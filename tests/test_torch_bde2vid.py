"""Port parity of the whole BDE2VID model vs the JAX package at the flagship
width (base 32, 3 encoders, depths [4, 0, 6], 16 heads, 7x7 windows, buffer
+-3) on a 56x56 input, f32 on the CPU, at the repo's bar atol 2e-4
(tests/test_bde2vid.py). Weights: the torch replica of the reference
generator in tests/test_bde2vid.py saved as an mmengine .pth, which the port
loads as is and the JAX package converts; or flax init params carried over
with ``state_dict_from_jax``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.test_bde2vid as tb
from bde2vid_tpu.eval.checkpoint import load_model_from_torch as jax_load
from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.models.api import set_pallas_attention
from bde2vid_tpu_torch.eval.checkpoint import (
    load_model_from_torch,
    load_state_dict_checked,
    state_dict_from_jax,
)
from bde2vid_tpu_torch.models import build_model
from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel

FLAGSHIP = dict(BASE=32, ENC=3, KS=5, NRES=2, BUF=[-3, -2, -1, 0, 1, 2, 3], DEPTHS=[4, 0, 6],
                HEADS=16, WIN=(7, 7))


@pytest.fixture(scope="module")
def flagship_pth(tmp_path_factory):
    """The reference-replica generator at flagship width, saved as an
    mmengine checkpoint with its embedded config."""
    mp = pytest.MonkeyPatch()
    for name, val in FLAGSHIP.items():
        mp.setattr(tb, name, val)
    try:
        torch.manual_seed(1)
        tnet = tb.TV5().eval()
    finally:
        mp.undo()
    cfg = f"""
model = dict(
    type='BDE2VID',
    generator=dict(
        type='BDE2VIDCrossscalePropogationV5',
        num_bins=5, basechannels=32, num_encoders=3, ks=5, num_res_blocks=2,
        buffer_index={FLAGSHIP['BUF']}, depths={FLAGSHIP['DEPTHS']}, num_heads=16,
        window_size=(7, 7), drop_path_rate=0.2, activation=dict(type='Sigmoid'), losses=[],
    ),
)
"""
    path = tmp_path_factory.mktemp("flagship") / "epoch_1.pth"
    sd = {f"generator.{k}": v for k, v in tnet.state_dict().items()}
    torch.save({"meta": {"cfg": cfg}, "state_dict": sd}, str(path))
    return str(path)


def _voxels(t, h=56, w=56, seed=0):
    return np.random.default_rng(seed).normal(size=(t, 1, h, w, 5)).astype(np.float32)


def _port_images(spec, voxels):
    with torch.no_grad():  # the eval driver's grad mode
        out = spec.module(torch.from_numpy(np.ascontiguousarray(voxels.transpose(0, 1, 4, 2, 3))))
    return out["image"][:, 0, 0].numpy()


@pytest.mark.parametrize("use_kernel,t", [(False, 8), (True, 3)])
def test_flagship_width_matches_jax(flagship_pth, use_kernel, t):
    """use_kernel: the port's fused-block path (plain twin on the CPU) vs the
    JAX package's Pallas path in interpret mode; otherwise both unfused."""
    jspec = jax_load(flagship_pth)
    if use_kernel:
        jspec = set_pallas_attention(jspec, True)
    spec = load_model_from_torch(flagship_pth, device="cpu")
    set_attention_kernel(spec.module, use_kernel)
    assert spec.num_encoders == 3 and spec.num_bins == 5
    v = _voxels(t)
    want = np.asarray(jspec.module.apply(jspec.params, jnp.asarray(v))[0]["image"])[:, 0, :, :, 0]
    got = _port_images(spec, v)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_reference_replica_checkpoint_loads_strictly(flagship_pth):
    """The port's module tree is the reference state-dict layout: every key
    of the replica's checkpoint has a home and nothing is missing."""
    spec = load_model_from_torch(flagship_pth, device="cpu")
    ckpt = torch.load(flagship_pth, weights_only=False)
    assert set(spec.module.state_dict()) == set(ckpt["state_dict"])


_SMALL = {"num_bins": 5, "basechannels": 4, "num_encoders": 2, "ks": 3, "num_res_blocks": 2,
          "buffer_index": [-1, 0, 1], "num_heads": 2, "window_size": [4, 4]}


@pytest.mark.parametrize("depths", [[0, 0], [1, 2]])
def test_flax_params_carried_over_match_jax(depths):
    """flax init params -> state_dict_from_jax -> the port: the depth-0 last
    level (norm-free resblocks on buffer frame -1), and attention at both
    levels with a dilated block at the last."""
    cfg = {"generator": dict(_SMALL, depths=depths)}
    jmod = jax_build("BDE2VID", cfg)
    v = _voxels(3, 16, 16, seed=1)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(v))
    model = build_model("BDE2VID", cfg, device="cpu")
    load_state_dict_checked(model, state_dict_from_jax(params))
    want = np.asarray(jmod.apply(params, jnp.asarray(v))[0]["image"])[:, 0, :, :, 0]
    with torch.no_grad():
        out = model(torch.from_numpy(np.ascontiguousarray(v.transpose(0, 1, 4, 2, 3))))["image"]
    np.testing.assert_allclose(out[:, 0, 0].numpy(), want, atol=2e-4, rtol=0)


# parallel_attention and nwindow_size are ported: tests/test_torch_parallel_nwindow.py;
# concat skips, BN/IN, ConvGRU and remat build and run here and match JAX in
# tests/test_torch_config_surface.py; no_skip is refused as JAX refuses it
@pytest.mark.parametrize("extra,exc", [
    pytest.param({"remat": True}, None, id="remat"),
    pytest.param({"norm": "BN"}, None, id="BN"),
    pytest.param({"skip_type": "concat"}, None, id="concat"),
    pytest.param({"recurrent_block_type": "convgru"}, None, id="convgru"),
    pytest.param({"skip_type": "no_skip"}, ValueError, id="no_skip"),
])
def test_unsupported_config_keys_raise(extra, exc):
    cfg = {"generator": dict(_SMALL, depths=[1, 1], **extra)}
    if exc is not None:
        with pytest.raises(exc):
            build_model("BDE2VID", cfg, device="cpu")
        return
    model = build_model("BDE2VID", cfg, device="cpu")
    v = torch.from_numpy(np.ascontiguousarray(_voxels(3, 16, 16, seed=2).transpose(0, 1, 4, 2, 3)))
    with torch.no_grad():
        out = model(v)["image"]
    assert out.shape == (3, 1, 1, 16, 16) and torch.isfinite(out).all()
