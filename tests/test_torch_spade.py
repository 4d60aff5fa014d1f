"""SPADE-E2VID in the port vs the JAX package on the CPU in f32: the
torch-floor nearest resize and the pixel shuffle bit-equal, PixelShufflePack
and each SPADE module with the flax variables (numpy-seeded, running
statistics included) carried over by ``state_dict_from_jax`` within 1e-5,
and the whole ``SPADEE2VID`` over 3 steps at 32x40 within 2e-4 (the repo's
bar, tests/test_bde2vid.py:313): images, ``image_bgr`` and every state
tensor, through both branches of the first step's bootstrap. A bare
``SPADE_E2VID.pth`` loads through both packages' ``load_model_from_torch``
with ``normalize`` and 3 encoders, and gives the same images.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from bde2vid_tpu.eval.checkpoint import load_model_from_torch as jax_load
from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.models import spade_e2vid as jspade
from bde2vid_tpu.nn import layers as jlayers
from bde2vid_tpu_torch.eval.checkpoint import (
    load_model_from_torch,
    load_state_dict_checked,
    state_dict_from_jax,
)
from bde2vid_tpu_torch.models import build_model
from bde2vid_tpu_torch.models import spade_e2vid as tspade
from bde2vid_tpu_torch.nn.layers import PixelShufflePack, pixel_shuffle, resize_nearest_torch
from tests.test_torch_checkpoint_dialects import seeded_state_dict
from tests.test_torch_e2vid import nchw, seeded_tree

ATOL = 2e-4
H, W, B = 32, 40, 5


def _variables(module, *inputs, seed):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs))
    return seeded_tree(shapes, seed)


def _port(module, variables):
    load_state_dict_checked(module, state_dict_from_jax(variables))
    return module.eval()


@pytest.mark.parametrize("src,dst", [((46, 60), (23, 30)), ((36, 44), (23, 30)), ((23, 30), (46, 60)),
                                     ((7, 9), (23, 30)), ((32, 40), (8, 10)), ((50, 61), (17, 13))])
def test_resize_nearest_picks_jax_and_torch_pixels(src, dst):
    """The same source pixels as JAX, bit for bit, and as the reference's
    ``F.interpolate(mode="nearest")``, at integer and non-integer ratios."""
    x = np.random.default_rng(1).normal(size=(2, *src, 3)).astype(np.float32)
    want = np.asarray(jlayers.resize_nearest_torch(jnp.asarray(x), *dst))
    got = resize_nearest_torch(nchw(x), *dst)
    np.testing.assert_array_equal(got.numpy(), np.asarray(nchw(want)))
    assert torch.equal(got, F.interpolate(nchw(x), size=dst, mode="nearest"))


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_is_bit_equal_to_jax(r):
    x = np.random.default_rng(2).normal(size=(2, 5, 7, 4 * r * r)).astype(np.float32)
    want = np.asarray(jlayers.pixel_shuffle(jnp.asarray(x), r))
    np.testing.assert_array_equal(pixel_shuffle(nchw(x), r).numpy(), np.asarray(nchw(want)))


def test_pixel_shuffle_pack_matches_jax():
    x = np.random.default_rng(3).normal(size=(1, 6, 8, 4)).astype(np.float32)
    jmod = jlayers.PixelShufflePack(5, scale_factor=2, upsample_kernel=3)
    variables = _variables(jmod, jnp.asarray(x), seed=4)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    mod = _port(PixelShufflePack(4, 5, 2, 3), variables)
    with torch.no_grad():
        got = mod(nchw(x)).numpy()
    assert got.shape == (1, 5, 12, 16)
    np.testing.assert_allclose(got, np.asarray(nchw(want)), atol=1e-5, rtol=0)


def _module_case(kind, rng):
    """(JAX module, port module, NHWC inputs) of one SPADE module at small width."""
    x = rng.normal(size=(2, 8, 10, 6)).astype(np.float32)
    seg = rng.uniform(size=(2, 16, 20, 3)).astype(np.float32)
    if kind == "SPADE":
        return jspade.SPADE(6, nhidden=16), tspade.SPADE(6, nhidden=16), (x, seg)
    if kind == "SpadeResidualBlock":
        return jspade.SpadeResidualBlock(6), tspade.SpadeResidualBlock(6), (x,)
    if kind == "SpadeUpConvLayer":
        return jspade.SpadeUpConvLayer(4), tspade.SpadeUpConvLayer(6, 4), (x, seg)
    stride = 2 if kind == "SpadeRecurrentConvLayer-s2" else 1
    h, w = (4, 5) if stride == 2 else (8, 10)
    state = tuple(rng.normal(size=(2, h, w, 7)).astype(np.float32) for _ in range(2))
    return (jspade.SpadeRecurrentConvLayer(7, stride=stride),
            tspade.SpadeRecurrentConvLayer(6, 7, stride=stride), (x, state))


@pytest.mark.parametrize("kind", ["SPADE", "SpadeRecurrentConvLayer-s1",
                                  "SpadeRecurrentConvLayer-s2", "SpadeResidualBlock",
                                  "SpadeUpConvLayer"])
def test_spade_module_matches_jax(kind):
    jmod, mod, inputs = _module_case(kind, np.random.default_rng(5))
    jin = jax.tree_util.tree_map(jnp.asarray, inputs)
    variables = _variables(jmod, *jin, seed=6)
    want = jmod.apply(variables, *jin)
    _port(mod, variables)
    with torch.no_grad():
        got = mod(*jax.tree_util.tree_map(nchw, inputs))
    got_leaves, want_leaves = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, wl in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(nchw(wl)), atol=1e-5, rtol=0)


def test_icnr_init_starts_the_shuffle_as_a_nearest_upsample():
    torch.manual_seed(0)
    layer = tspade.SpadeUpConvLayer(6, 4)
    x = torch.randn(1, 6, 5, 7)
    with torch.no_grad():
        up = pixel_shuffle(layer.conv0(x), 2)
    assert torch.equal(up, up[:, :, ::2, ::2].repeat_interleave(2, 2).repeat_interleave(2, 3))


def _first_windows(kind, rng):
    v = rng.normal(size=(1, H, W, B)).astype(np.float32)
    if kind == "zero-max":  # non-positive first channels with zeros: the raw window is kept
        v[..., :3] = -np.abs(v[..., :3])
        v[..., :3][rng.uniform(size=(1, H, W, 3)) < 0.5] = 0.0
    elif kind == "negative":  # all below 0: its raw max is not 0, so it is shifted and scaled
        v[..., :3] = -np.abs(v[..., :3]) - 0.5
    return v


@pytest.fixture(scope="module")
def jax_spade():
    """The JAX model, its seeded variables and one jitted step, compiled once."""
    jmodel = jax_build("SPADEE2VID", {})
    variables = _variables(jmodel, jnp.zeros((1, H, W, B)), jmodel.initial_state(1, H, W), seed=8)
    return jmodel, variables, jax.jit(jmodel.apply)


@pytest.mark.parametrize("first", ["positive", "zero-max", "negative"])
def test_spade_e2vid_matches_jax_over_three_steps(jax_spade, first):
    rng = np.random.default_rng(7)
    vox = rng.normal(size=(3, 1, H, W, B)).astype(np.float32)
    vox[0] = _first_windows(first, rng)
    jmodel, variables, step = jax_spade
    model = _port(build_model("SPADEE2VID", {}, device="cpu"), variables)
    jstate, state = jmodel.initial_state(1, H, W), model.initial_state(1, H, W)
    for t in range(3):
        want, jstate = step(variables, jnp.asarray(vox[t]), jstate)
        with torch.no_grad():
            got, state = model(nchw(vox[t]), state)
        for key in ("image", "image_bgr"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(nchw(want[key])), atol=ATOL,
                                       rtol=0, err_msg=f"{key} at step {t}")
        assert bool(state["initialized"]) and bool(jstate["initialized"])
        np.testing.assert_allclose(state["pred"].numpy(), np.asarray(nchw(jstate["pred"])),
                                   atol=ATOL, rtol=0)
        for g, wl in zip(jax.tree_util.tree_leaves(state["states"]),
                         jax.tree_util.tree_leaves(jstate["states"])):
            np.testing.assert_allclose(g.numpy(), np.asarray(nchw(wl)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("first", ["positive", "zero-max", "negative"])
def test_spade_bootstrap_branches(first):
    """The first step's segmap: the first three channels min-max scaled
    unless their raw max is exactly 0, then kept raw."""
    v = _first_windows(first, np.random.default_rng(9))
    first3 = torch.from_numpy(v[..., :3]).permute(0, 3, 1, 2)
    model = build_model("SPADEE2VID", {}, device="cpu")
    seen = {}
    model.generator.register_forward_hook(lambda m, args, out: seen.update(pred=args[2]))
    with torch.no_grad():
        model(nchw(v), model.initial_state(1, H, W))
    if first == "zero-max":
        assert first3.max() == 0
        assert torch.equal(seen["pred"], first3)
    else:
        scaled = (first3 - first3.min()) / (first3 - first3.min()).max()
        torch.testing.assert_close(seen["pred"], scaled, atol=1e-7, rtol=0)
        assert seen["pred"].min() == 0 and seen["pred"].max() == 1


def test_initial_state_shapes_match_jax_at_odd_sizes():
    jmodel = jax_build("SPADEE2VID", {})
    model = build_model("SPADEE2VID", {}, device="cpu")
    for h, w in ((33, 47), (36, 44)):
        want = [tuple(np.moveaxis(np.empty(a.shape), -1, -3).shape) if a.ndim == 4 else a.shape
                for a in jax.tree_util.tree_leaves(jmodel.initial_state(1, h, w))]
        got = [tuple(a.shape) for a in jax.tree_util.tree_leaves(model.initial_state(1, h, w))]
        assert got == want


def test_bare_spade_dialect_loads_in_both_packages(tmp_path):
    """One torch state dict of the generator (the reference's bare layout)
    saved as ``SPADE_E2VID.pth``: both loaders read it with ``normalize``
    and 3 encoders, and give the same images over 2 steps."""
    sd = seeded_state_dict(build_model("SPADEE2VID", {}, device="cpu").generator, 10)
    path = str(tmp_path / "SPADE_E2VID.pth")
    torch.save(sd, path)
    spec, jspec = load_model_from_torch(path, device="cpu"), jax_load(path)
    assert spec.name == jspec.name == "SPADEE2VID"
    assert spec.normalize and jspec.normalize
    assert spec.num_encoders == jspec.num_encoders == 3
    assert not spec.is_sequence_model
    assert all(torch.equal(v, spec.module.state_dict()["generator." + k]) for k, v in sd.items())
    vox = np.random.default_rng(11).normal(size=(2, 1, H, W, B)).astype(np.float32)
    jstate, state = jspec.module.initial_state(1, H, W), spec.initial_state(1, H, W)
    jstep = jax.jit(jspec.module.apply)
    for t in range(2):
        want, jstate = jstep(jspec.params, jnp.asarray(vox[t]), jstate)
        with torch.no_grad():
            got, state = spec.step(nchw(vox[t]), state)
        np.testing.assert_allclose(got["image"].numpy(), np.asarray(nchw(want["image"])),
                                   atol=ATOL, rtol=0)


def test_bf16_drift_within_the_jax_bound():
    """bf16 against f32 on the same weights over 3 steps: within the JAX
    package's own drift bound (0.08)."""
    torch.manual_seed(0)
    m32 = build_model("SPADEE2VID", {}, device="cpu")
    m16 = build_model("SPADEE2VID", {}, device="cpu", dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    s32, s16 = m32.initial_state(1, H, W), m16.initial_state(1, H, W)
    with torch.no_grad():
        for _ in range(3):
            vox = torch.randn(1, B, H, W)
            a, s32 = m32(vox, s32)
            b, s16 = m16(vox.bfloat16(), s16)
    assert b["image"].dtype == torch.bfloat16 and s16["pred"].dtype == torch.float32
    assert (a["image"] - b["image"].float()).abs().max().item() < 0.08
