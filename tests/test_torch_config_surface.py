"""BDE2VID's config surface beyond the flagship's, the port vs the JAX
package on the CPU in f32 at small width: ``skip_type`` concat, ``norm``
BN and IN, ``recurrent_block_type`` convgru, one combination of them, and a
long buffer (``buffer_index`` -10..10: 21 frames, N = 1029 keys a row).
Weights and running statistics come from a numpy seed in the flax tree and
reach the port through ``state_dict_from_jax``; the port's attention runs
both its paths (the kernel path takes the kernels' plain twins on the CPU).

- Eval forward: images within the repo's bar, atol 2e-4
  (tests/test_bde2vid.py:313). The port's state dict saved as a reference
  mmengine checkpoint then loads strictly into both packages: JAX's
  converter gives back the very variables, the port the same images.
- One train-mode step (DropPath 0, L1 sequence loss against targets kept
  away from the images, ``l1_targets``): the loss and every
  gradient within 1e-3 relative (max |diff| over max |JAX|) of
  ``make_loss_fn``'s, the key half of ``attn.kv.bias`` within 1e-5 and the
  conv biases under InstanceNorm within 1e-6 absolute (both analytically
  zero), and the BN/IN running statistics after the step
  within 1e-5 of the ``batch_stats`` JAX's step mutates.

ReLU and ReLU6 have no derivative at 0: a pre-activation within f32
rounding of the kink may take either side in two forwards that agree to
1e-6, and under BatchNorm that one element moves its whole channel's
gradients by percents. The weight seed gives no such tie; seed 4 had one
(a decoder pre-activation at 3e-7 on the kernel path of concat-BN-convgru,
-3e-7 on the unfused path), with every other element within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.eval.checkpoint import load_model_from_torch as jax_load
from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.train import SequenceLossComputer as JaxLoss
from bde2vid_tpu.train.trainer import make_loss_fn
from bde2vid_tpu_torch.eval.checkpoint import (
    load_model_from_torch,
    load_state_dict_checked,
    state_dict_from_jax,
)
from bde2vid_tpu_torch.models import build_model
from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
from bde2vid_tpu_torch.train import SequenceLossComputer, save_checkpoint
from tests.test_torch_parallel_nwindow import concrete_gathers  # noqa: F401  (a fixture)

BASE = dict(num_bins=5, basechannels=8, num_encoders=2, ks=3, num_res_blocks=1,
            buffer_index=[-1, 0, 1], depths=[2, 0], num_heads=4, window_size=[7, 7],
            drop_path_rate=0.0)
VARIANTS = {
    "concat": {"skip_type": "concat"},
    "BN": {"norm": "BN"},
    "IN": {"norm": "IN"},
    "convgru": {"recurrent_block_type": "convgru"},
    "concat-BN-convgru": {"skip_type": "concat", "norm": "BN", "recurrent_block_type": "convgru"},
    "long-buffer": {"buffer_index": list(range(-10, 11))},
}
T, N, H, W = 3, 1, 28, 28


@pytest.fixture(autouse=True)
def _concrete(concrete_gathers):
    yield


def seeded_variables(jmodel, vox, seed):
    """The flax variables of ``jmodel`` with values from a numpy seed:
    kernels a fan-in-scaled normal, LayerNorm/BatchNorm scales around 1,
    biases around 0, running means around 0 and running variances in
    [0.5, 1.5]. The tree comes from ``jax.eval_shape`` (no compile)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        key = jax.tree_util.keystr(path)
        if len(s.shape) >= 2:
            return jnp.asarray(rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1])), s.dtype)
        if key.endswith("['var']"):
            return jnp.asarray(rng.uniform(0.5, 1.5, size=s.shape), s.dtype)
        base = 1.0 if key.endswith("['scale']") else 0.0
        return jnp.asarray(base + 0.1 * rng.normal(size=s.shape), s.dtype)

    init = lambda v: jmodel.init(jax.random.PRNGKey(0), v)
    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init, jnp.asarray(vox[:2])))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    vox = rng.normal(size=(T, N, H, W, 5)).astype(np.float32)
    tgt = rng.uniform(size=(T, N, H, W, 1)).astype(np.float32)
    return vox, tgt


def l1_targets(cfg, variables, vox, seed):
    """Targets (T, N, H, W, 1) 0.02-0.1 away from the train-mode images of
    the port's unfused path, on a random side: the L1 loss's gradient,
    sign(image - target), then has no ties that a 1e-6 difference between
    two forwards could flip (one flipped pixel moves a small leaf's
    gradient by percents)."""
    with torch.no_grad():
        img = _port(cfg, variables, train=True)(nchw(vox))["image"].numpy().transpose(0, 1, 3, 4, 2)
    rng = np.random.default_rng(seed)
    off = rng.uniform(0.02, 0.1, size=img.shape) * rng.choice([-1.0, 1.0], size=img.shape)
    return (img + off).astype(np.float32)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 1, 4, 2, 3)))


def _port(cfg, variables, train):
    model = build_model("BDE2VID", cfg, device="cpu", train=train)
    load_state_dict_checked(model, state_dict_from_jax(variables))
    return model


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax_and_checkpoint_loads_in_both(variant, tmp_path):
    cfg = {"generator": dict(BASE, **VARIANTS[variant])}
    vox, _ = _inputs(1)
    jmodel = jax_build("BDE2VID", cfg)
    variables = seeded_variables(jmodel, vox, seed=2)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(vox))[0]["image"])
    want = want.transpose(0, 1, 4, 2, 3)
    model = _port(cfg, variables, train=False)
    for kernel in (False, True):
        set_attention_kernel(model, kernel)
        with torch.no_grad():
            got = model(nchw(vox))["image"].numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0, err_msg=f"kernel={kernel}")

    # the port's state dict in the reference layout loads strictly into both
    # packages: JAX's converter gives back the variables it started from
    path = str(tmp_path / "epoch_1.pth")
    save_checkpoint(path, model, "BDE2VID", cfg)
    loaded = jax.tree_util.tree_leaves_with_path(jax_load(path).params)
    assert [p for p, _ in loaded] == [p for p, _ in jax.tree_util.tree_leaves_with_path(variables)]
    for (path_, a), b in zip(loaded, jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path_))
    spec = load_model_from_torch(path, device="cpu")
    set_attention_kernel(spec.module, True)
    with torch.no_grad():
        np.testing.assert_array_equal(spec.module(nchw(vox))["image"].numpy(), got)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_step_matches_jax_make_loss_fn(variant):
    cfg = {"generator": dict(BASE, **VARIANTS[variant])}
    vox, _ = _inputs(3)
    jmodel = jax_build("BDE2VID", cfg, train=True)
    variables = seeded_variables(jmodel, vox, seed=6)
    tgt = l1_targets(cfg, variables, vox, seed=5)
    loss_fn = make_loss_fn(jmodel, JaxLoss([{"type": "L1Loss"}]), is_sequence_model=True)
    (want_loss, (_, mutated)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables, jnp.asarray(vox), jnp.asarray(tgt), None, {"droppath": jax.random.PRNGKey(2)})
    want = state_dict_from_jax({"params": jgrads["params"]})
    want_stats = state_dict_from_jax({"params": {}, "batch_stats": mutated.get("batch_stats", {})})

    for kernel in (False, True):
        model = _port(cfg, variables, train=True)
        set_attention_kernel(model, kernel)
        loss, _ = SequenceLossComputer([{"type": "L1Loss"}])(model(nchw(vox))["image"], nchw(tgt))
        loss.backward()
        assert abs(loss.item() - float(want_loss)) <= 1e-3 * abs(float(want_loss)), kernel
        got = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
        assert set(got) == set(want), kernel
        state = model.state_dict()
        for key, g in got.items():
            w = want[key]
            if key.endswith("attn.kv.bias"):
                c = g.shape[0] // 2
                assert g[:c].abs().max() <= 1e-5, key
                g, w = g[c:], w[c:]
            if key.endswith("conv2d.bias") and key[:-11] + "norm_layer.running_mean" in state:
                # a conv bias under an affine-free InstanceNorm cancels out:
                # its gradient is analytically zero on both sides
                assert max(g.abs().max().item(), w.abs().max().item()) <= 1e-6, key
                continue
            err = (g - w).abs().max().item()
            assert err <= 1e-3 * w.abs().max().item(), (kernel, key, err)
        assert bool(want_stats) == ("norm" in VARIANTS[variant])
        for key, w in want_stats.items():
            if key.endswith("num_batches_tracked"):
                assert state[key].item() == (T if ".encoder" in key or "_encoder" in key else 1), key
                continue
            np.testing.assert_allclose(state[key].numpy(), w.numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"kernel={kernel} {key}")
