"""Model-level training parity: the port's L1 sequence loss and the gradient
of every parameter vs the JAX package's ``make_loss_fn`` (train mode,
``drop_path_rate`` 0), on both attention paths: the port's kernel path (the
twins and their autograd Function on the CPU) vs the JAX Pallas path in
interpret mode, and the unfused paths of both. JAX's gradient tree goes
through ``state_dict_from_jax`` and is compared key by key with
``param.grad`` at the bound of tests/test_pallas_attn.py::
test_fused_path_gradients_match_xla_path (atol 5e-5, rtol 1e-3)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.train import SequenceLossComputer as JaxLoss
from bde2vid_tpu.train.trainer import make_loss_fn
from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked, state_dict_from_jax
from bde2vid_tpu_torch.models import build_model
from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
from bde2vid_tpu_torch.train import SequenceLossComputer

CONFIGS = {
    # the config of tests/test_pallas_attn.py::test_fused_path_gradients_match_xla_path
    "small": (dict(num_bins=5, basechannels=8, num_encoders=2, ks=3, num_res_blocks=1,
                   buffer_index=[-1, 0, 1], depths=[2, 0], num_heads=4, window_size=[7, 7]),
              (3, 1, 28, 28)),
    # the flagship architecture at a reduced size
    "flagship": (dict(num_bins=5, basechannels=32, num_encoders=3, ks=5, num_res_blocks=2,
                      buffer_index=[-3, -2, -1, 0, 1, 2, 3], depths=[4, 0, 6], num_heads=16,
                      window_size=[7, 7]),
                 (3, 1, 56, 56)),
}


# both attention paths on the small config; the flagship on the kernel path
# only (its unfused parity adds half a minute of JAX work and no coverage
# that the small config lacks)
@pytest.mark.parametrize("config,kernel", [
    pytest.param("small", False, id="small-False"),
    pytest.param("small", True, id="small-True"),
    pytest.param("flagship", True, id="flagship-True"),
])
def test_loss_and_gradients_match_jax_make_loss_fn(config, kernel):
    gcfg, (t, n, h, w) = CONFIGS[config]
    rng = np.random.default_rng(5)
    vox = rng.normal(size=(t, n, h, w, 5)).astype(np.float32)
    tgt = rng.uniform(size=(t, n, h, w, 1)).astype(np.float32)
    cfg = {"generator": dict(gcfg, drop_path_rate=0.0, use_pallas_attention=kernel)}

    jmodel = jax_build("BDE2VID", cfg, train=True)
    params = jmodel.init({"params": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1)},
                         jnp.asarray(vox[:2]))
    loss_fn = make_loss_fn(jmodel, JaxLoss([{"type": "L1Loss"}]), is_sequence_model=True)
    (want_loss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jnp.asarray(vox), jnp.asarray(tgt), None, {"droppath": jax.random.PRNGKey(2)})

    model = build_model("BDE2VID", cfg, device="cpu", train=True)
    load_state_dict_checked(model, state_dict_from_jax(params))
    set_attention_kernel(model, kernel)
    loss, _ = SequenceLossComputer([{"type": "L1Loss"}])(
        model(torch.from_numpy(np.ascontiguousarray(vox.transpose(0, 1, 4, 2, 3))))["image"],
        torch.from_numpy(np.ascontiguousarray(tgt.transpose(0, 1, 4, 2, 3))))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=2e-5, rtol=1e-4)

    want = state_dict_from_jax(jgrads)
    got = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    assert set(got) == set(want)
    for key, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[key].numpy(), atol=5e-5, rtol=1e-3, err_msg=key)
        if key.endswith("attn.kv.bias"):
            # the key half's gradient is analytically zero (softmax is shift
            # invariant per row): bound it absolutely
            c = g.shape[0] // 2
            assert g[:c].abs().max() <= 1e-5, key
