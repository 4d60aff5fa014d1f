"""bf16 and remat training in the port, on the CPU at small width.

- Remat (``remat: true``, ``nn.remat.checkpoint_step``): with DropPath 0.2
  and one generator seed, the loss, every gradient, the BN running
  statistics and the generator's state after a step equal those without
  remat bit for bit, on both attention paths; the backward recomputes
  every attention block once, and the forward keeps far fewer bytes for
  the backward.
- bf16 (``train_step(dtype=torch.bfloat16)``, the JAX CLI's ``"train":
  {"bf16": true}``): the model computes in bf16 over f32 weights, so the
  gradients, the weights and the Adam state stay f32. Against the JAX
  package at ``dtype=bfloat16`` on the same params (f32 reference: JAX at
  f32), the port's loss and gradients sit within bf16 noise: the port's
  bf16 is no farther from f32 than twice JAX's bf16 is, and no farther
  from JAX's bf16 than twice JAX's bf16 is from f32 (gradients as one
  vector, relative L2). The factor: the two packages round at other points
  (XLA on the CPU keeps f32 inside a fusion, PyTorch rounds each op), so
  their bf16 errors are close to independent, and two independent errors
  of one size sit about 1.4 times that size apart (over five weight seeds
  the second ratio measured 0.9-1.8 on the kernel path). The loss moves by
  less than one bf16 step (2^-8 relative) either way.
- bf16 eval drift: the port's bf16 images stay within 0.05 of its f32
  images at sigmoid scale (the bound of tests/test_bde2vid.py::
  test_bf16_pallas_fast_path_drift), with f32 weights (bf16 training) and
  with the weights cast to bf16 (the eval CLI's ``--bf16``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.train import SequenceLossComputer as JaxLoss
from bde2vid_tpu.train.trainer import make_loss_fn
from bde2vid_tpu_torch.models import build_model
from bde2vid_tpu_torch.nn.window_attention import SwinTransformerBlock3D, set_attention_kernel
from bde2vid_tpu_torch.train import SequenceLossComputer, build_optimizer, train_step
from tests.test_torch_config_surface import (
    BASE,
    _inputs,
    _port,
    l1_targets,
    nchw,
    seeded_variables,
    state_dict_from_jax,
)
from tests.test_torch_parallel_nwindow import concrete_gathers  # noqa: F401  (a fixture)


@pytest.fixture(autouse=True)
def _concrete(concrete_gathers):
    yield


def _voxels_and_targets(seed=0):
    rng = np.random.default_rng(seed)
    vox = torch.from_numpy(rng.normal(size=(3, 1, 5, 28, 28)).astype(np.float32))
    tgt = torch.from_numpy(rng.uniform(size=(3, 1, 1, 28, 28)).astype(np.float32))
    return vox, tgt


@pytest.mark.parametrize("extra,kernel", [
    pytest.param({}, False, id="unfused"),
    pytest.param({}, True, id="kernel"),
    pytest.param({"norm": "BN", "recurrent_block_type": "convgru"}, True, id="BN-convgru-kernel"),
    pytest.param({"norm": "IN", "skip_type": "concat"}, False, id="IN-concat-unfused"),
])
def test_remat_gives_the_same_step_bit_for_bit(extra, kernel):
    gcfg = dict(BASE, drop_path_rate=0.2, **extra)
    vox, tgt = _voxels_and_targets()
    torch.manual_seed(0)
    base = build_model("BDE2VID", {"generator": gcfg}, device="cpu", train=True)
    runs = []
    for remat in (False, True):
        model = build_model("BDE2VID", {"generator": gcfg, "remat": remat}, device="cpu", train=True)
        model.load_state_dict(base.state_dict())
        set_attention_kernel(model, kernel)
        calls = [0]
        for m in model.modules():
            if isinstance(m, SwinTransformerBlock3D):
                m.register_forward_pre_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
        saved = [0]

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t

        gen = torch.Generator().manual_seed(1)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = SequenceLossComputer([{"type": "L1Loss"}])(model(vox, generator=gen)["image"], tgt)
        forward_calls = calls[0]
        loss.backward()
        runs.append({"loss": loss.detach(), "gen": gen.get_state(), "calls": (forward_calls, calls[0]),
                     "saved": saved[0], **{k: p.grad for k, p in model.named_parameters()},
                     **{k: b for k, b in model.named_buffers() if "running" in k or "batches" in k}})
    plain, remat = runs
    assert plain["calls"] == (6, 6)  # 2 blocks x 3 frames, nothing recomputed
    assert remat["calls"] == (6, 12)  # each block once more, in the backward
    assert remat["saved"] < 0.3 * plain["saved"]
    for key, want in plain.items():
        if key not in ("calls", "saved"):
            assert (want is None and remat[key] is None) or torch.equal(remat[key], want), key


def _jax_loss_and_grads(cfg, variables, vox, tgt, dtype):
    jmodel = jax_build("BDE2VID", cfg, train=True, dtype=dtype)
    loss_fn = make_loss_fn(jmodel, JaxLoss([{"type": "L1Loss"}]), is_sequence_model=True)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables, jnp.asarray(vox), jnp.asarray(tgt), None, {"droppath": jax.random.PRNGKey(2)})
    return float(loss), state_dict_from_jax({"params": grads["params"]})


def _l2(a, b, keys):
    num = sum(((a[k].float() - b[k].float()) ** 2).sum() for k in keys)
    return float(num.sqrt())


@pytest.mark.parametrize("kernel", [False, True])
def test_bf16_train_step_sits_within_bf16_noise_of_jax(kernel):
    cfg = {"generator": dict(BASE, use_pallas_attention=kernel)}
    vox, _ = _inputs(3)
    jmodel = jax_build("BDE2VID", cfg, train=True)
    variables = seeded_variables(jmodel, vox, seed=6)
    tgt = l1_targets({"generator": dict(BASE)}, variables, vox, seed=5)
    loss32, g32 = _jax_loss_and_grads(cfg, variables, vox, tgt, jnp.float32)
    loss16, g16 = _jax_loss_and_grads(cfg, variables, vox, tgt, jnp.bfloat16)

    model = _port(cfg, variables, train=True)
    set_attention_kernel(model, kernel)
    preds = model(nchw(vox).to(torch.bfloat16))["image"]
    assert preds.dtype == torch.bfloat16
    loss, _ = SequenceLossComputer([{"type": "L1Loss"}])(preds.float(), nchw(tgt))
    loss.backward()
    got = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    assert set(got) == set(g32) and all(g.dtype == torch.float32 for g in got.values())
    keys = sorted(g32)
    norm = _l2(g32, {k: torch.zeros_like(v) for k, v in g32.items()}, keys)
    jax_noise = _l2(g16, g32, keys) / norm
    assert _l2(got, g32, keys) / norm <= 2 * jax_noise
    assert _l2(got, g16, keys) / norm <= 2 * jax_noise
    for other in (loss16, loss32):
        assert abs(loss.item() - other) <= 2**-8 * abs(loss32)


def test_bf16_train_step_keeps_f32_weights_and_adam_state():
    vox, tgt = _voxels_and_targets()
    model = build_model("BDE2VID", {"generator": dict(BASE, drop_path_rate=0.2),
                                    "use_pallas_attention": True}, device="cpu", train=True)
    optimizer, _, clip, _ = build_optimizer(model.parameters(), {"type": "Adam", "args": {"lr": 1e-3}})
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        out = train_step(model, optimizer, SequenceLossComputer([{"type": "L1Loss"}]), vox, tgt,
                         generator=gen, grad_clip=clip, dtype=torch.bfloat16)
    assert out["loss"].dtype == torch.float32 and torch.isfinite(out["loss"])
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in model.parameters()
               if p.grad is not None)
    states = [s for s in optimizer.state.values() if s]
    assert states and all(v.dtype == torch.float32 for s in states for k, v in s.items()
                          if k in ("exp_avg", "exp_avg_sq"))


@pytest.mark.parametrize("weights", ["f32", "bf16"])
def test_bf16_eval_drift_stays_within_bf16_noise(weights):
    """tests/test_bde2vid.py::test_bf16_pallas_fast_path_drift on the port:
    the f32 unfused path vs the bf16 kernel path on shared weights."""
    base = {"num_bins": 5, "basechannels": 8, "num_encoders": 2, "ks": 3,
            "num_res_blocks": 1, "buffer_index": [-1, 0, 1],
            "depths": [1, 1], "num_heads": 4, "window_size": [7, 7]}
    v = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 1, 5, 28, 28)).astype(np.float32))
    torch.manual_seed(0)
    m32 = build_model("BDE2VID", {"generator": base}, device="cpu")
    m16 = build_model("BDE2VID", {"generator": dict(base, use_pallas_attention=True)}, device="cpu",
                      dtype=torch.bfloat16 if weights == "bf16" else torch.float32)
    m16.load_state_dict(m32.state_dict())
    with torch.no_grad():
        a = m32(v)["image"]
        b = m16(v.to(torch.bfloat16))["image"]
    assert b.dtype == torch.bfloat16
    assert (a - b.float()).abs().max().item() < 0.05  # sigmoid-output scale, bf16 noise
