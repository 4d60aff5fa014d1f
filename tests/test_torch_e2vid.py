"""The E2VID family of the port vs the JAX package on the CPU in f32, at
small width (base 8, 2 encoders, 1 residual block, 32x48; FireNet and
FireNetOrg at the odd 31x45): E2VID, E2VIDRecurrent, FireNet, FireNetOrg
and FlowNet over T=3 steps, through JAX's ``run_sequence`` and the port's,
with the flax variables (numpy-seeded, running statistics included) carried
to the port by ``state_dict_from_jax``. Images and the final state agree
within the repo's bar, atol 2e-4 (tests/test_bde2vid.py:313).

Also alone: TransposedConvLayer (layout, flip and output_padding at an odd
and an even input size, both converters), ResidualBlock (stat-less IN, BN,
a strided 1x1 downsample), the state shapes at odd padded sizes,
``legacy_norm``, and the sequence runners.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.eval.checkpoint import convert_state_dict
from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.models.api import run_sequence as jax_run_sequence
from bde2vid_tpu.nn.layers import ResidualBlock as JaxResidualBlock
from bde2vid_tpu.nn.layers import TransposedConvLayer as JaxTransposedConvLayer
from bde2vid_tpu.utils.norm import legacy_norm as jax_legacy_norm
from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked, state_dict_from_jax
from bde2vid_tpu_torch.models import ModelSpec, build_model, run_sequence, run_sequence_chunked
from bde2vid_tpu_torch.nn.layers import ResidualBlock, TransposedConvLayer
from bde2vid_tpu_torch.utils.norm import legacy_norm
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

ATOL = 2e-4
T, B = 3, 5
SMALL = {"num_bins": B, "num_encoders": 2, "base_num_channels": 8, "num_residual_blocks": 1}
FIRE = {"num_bins": B, "base_num_channels": 8, "num_residual_blocks": 2}
CASES = {
    "E2VID": ("E2VID", SMALL),
    "E2VID-BN-transposed": ("E2VID", dict(SMALL, norm="BN", use_upsample_conv=False)),
    "E2VID-IN-concat": ("E2VID", dict(SMALL, norm="IN", skip_type="concat")),
    "E2VIDRecurrent": ("E2VIDRecurrent", SMALL),
    "E2VIDRecurrent-BN": ("E2VIDRecurrent", dict(SMALL, norm="BN")),
    "E2VIDRecurrent-IN": ("E2VIDRecurrent", dict(SMALL, norm="IN")),
    "E2VIDRecurrent-concat": ("E2VIDRecurrent", dict(SMALL, skip_type="concat")),
    "E2VIDRecurrent-transposed": ("E2VIDRecurrent", dict(SMALL, use_upsample_conv=False)),
    "E2VIDRecurrent-convgru": ("E2VIDRecurrent", dict(SMALL, recurrent_block_type="convgru")),
    "E2VIDRecurrent-concat-BN-transposed-convgru": (
        "E2VIDRecurrent", dict(SMALL, skip_type="concat", norm="BN", use_upsample_conv=False,
                               recurrent_block_type="convgru")),
    "FireNet": ("FireNet", FIRE),
    "FireNet-k5": ("FireNet", dict(FIRE, kernel_size=5)),
    "FireNetOrg-resblock0": ("FireNetOrg", dict(FIRE, recurrent_blocks={"resblock": [0]})),
    "FireNetOrg-all-IN": ("FireNetOrg", dict(FIRE, norm="IN", recurrent_blocks={"resblock": [-1]})),
    "FireNetOrg-BN-convlstm": ("FireNetOrg", dict(FIRE, norm="BN", recurrent_block_type="convlstm",
                                                  recurrent_blocks={"resblock": [1]})),
    "FlowNet": ("FlowNet", SMALL),
    "FlowNet-k3": ("FlowNet", dict(SMALL, kernel_size=3)),
}


def seeded_tree(shapes, seed):
    """A tree of ``jax.ShapeDtypeStruct`` (from ``jax.eval_shape`` of a flax
    init) filled from a numpy seed: kernels a fan-in-scaled normal, norm
    scales around 1, biases around 0, running means around 0 and running
    variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        key = jax.tree_util.keystr(path)
        if len(s.shape) >= 2:
            return jnp.asarray(rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1])), s.dtype)
        if key.endswith("['var']"):
            return jnp.asarray(rng.uniform(0.5, 1.5, size=s.shape), s.dtype)
        base = 1.0 if key.endswith("['scale']") else 0.0
        return jnp.asarray(base + 0.1 * rng.normal(size=s.shape), s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_variables(jmodel, h, w, seed):
    voxel = jnp.zeros((1, h, w, B))
    init = lambda: jmodel.init(jax.random.PRNGKey(0), voxel, jmodel.initial_state(1, h, w))
    return seeded_tree(jax.eval_shape(init), seed)


def port_model(name, cfg, variables):
    model = build_model(name, cfg, device="cpu")
    load_state_dict_checked(model, state_dict_from_jax(variables))
    return model


def nchw(a):
    """NHWC (or (T, N, H, W, C)) numpy -> NCHW torch."""
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def hw_of(name):
    return (31, 45) if name.startswith("FireNet") else (32, 48)


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_matches_jax_over_a_sequence(case):
    name, cfg = CASES[case]
    h, w = hw_of(name)
    jmodel = jax_build(name, dict(cfg))
    variables = jax_variables(jmodel, h, w, seed=3)
    vox = np.random.default_rng(4).normal(size=(T, 1, h, w, B)).astype(np.float32)
    want, want_state = jax.jit(lambda v, x: jax_run_sequence(
        jmodel, v, x, jmodel.initial_state(1, h, w)))(variables, jnp.asarray(vox))
    model = port_model(name, cfg, variables)
    with torch.no_grad():
        got, state = run_sequence(model, nchw(vox), model.initial_state(1, h, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(nchw(want)), atol=ATOL, rtol=0)
    got_leaves, want_leaves = jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(want_state)
    assert len(got_leaves) == len(want_leaves)
    for g, wl in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(nchw(wl)), atol=ATOL, rtol=0)
    if name == "FlowNet":
        with torch.no_grad():
            out, _ = model(nchw(vox[0]), model.initial_state(1, h, w))
        jout, _ = jmodel.apply(variables, jnp.asarray(vox[0]), jmodel.initial_state(1, h, w))
        assert out["flow"].shape == (1, 2, h, w)
        np.testing.assert_allclose(out["flow"].numpy(), np.asarray(nchw(jout["flow"])), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("name,cfg", [("E2VIDRecurrent", SMALL), ("FlowNet", dict(SMALL, kernel_size=3)),
                                      ("FireNetOrg", dict(FIRE, recurrent_blocks={"resblock": [-1]})),
                                      ("FireNet", FIRE)])
def test_initial_state_shapes_at_odd_sizes(name, cfg):
    """The state at the strided size, (h + 2p - k) // 2 + 1, as JAX's."""
    jmodel = jax_build(name, dict(cfg))
    model = build_model(name, cfg, device="cpu")
    for h, w in ((33, 47), (35, 45), (36, 44)):
        want = [tuple(np.moveaxis(np.empty(a.shape), -1, -3).shape)
                for a in jax.tree_util.tree_leaves(jmodel.initial_state(1, h, w))]
        got = [tuple(a.shape) for a in jax.tree_util.tree_leaves(model.initial_state(1, h, w))]
        assert got == want, (h, w)


@pytest.mark.parametrize("hw", [(7, 9), (8, 10)])
@pytest.mark.parametrize("norm", [None, "BN"])
def test_transposed_conv_layer_matches_jax(hw, norm):
    """torch's ConvTranspose2d(5, stride 2, padding 2, output_padding 1)
    against JAX's input-dilated conv over the flipped kernel; the weight
    goes through ``state_dict_from_jax`` and back through JAX's
    ``convert_state_dict``."""
    x = np.random.default_rng(5).normal(size=(2, *hw, 6)).astype(np.float32)
    jlayer = JaxTransposedConvLayer(4, kernel_size=5, padding=2, norm=norm)
    shapes = jax.eval_shape(lambda: jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = seeded_tree(shapes, seed=6)
    want = np.asarray(jlayer.apply(variables, jnp.asarray(x)))
    assert want.shape == (2, 2 * hw[0], 2 * hw[1], 4)
    sd = state_dict_from_jax({k: {"decoder0": v} for k, v in variables.items()})
    assert "decoders.0.transposed_conv2d.weight" in sd
    assert ("decoders.0.transposed_conv2d.bias" in sd) == (norm is None)
    layer = TransposedConvLayer(6, 4, 5, padding=2, norm=norm).eval()
    load_state_dict_checked(layer, {k.removeprefix("decoders.0."): v for k, v in sd.items()})
    assert layer.transposed_conv2d.weight.shape == (6, 4, 5, 5)
    with torch.no_grad():
        got = layer(nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(nchw(want)), atol=1e-5, rtol=0)
    back = convert_state_dict({k: v.numpy() for k, v in sd.items()})
    np.testing.assert_array_equal(back["params"]["decoder0"]["kernel"],
                                  np.asarray(variables["params"]["kernel"]))


@pytest.mark.parametrize("norm,stride", [("IN", 1), ("BN", 1), (None, 2)])
def test_residual_block_matches_jax(norm, stride):
    """conv-norm-relu-conv-norm plus the input (a strided 1x1 downsample
    when ``stride`` is 2), then relu. The block's IN keeps no statistics,
    in the port as in JAX."""
    cin = 8 if stride == 1 else 6
    x = np.random.default_rng(7).normal(size=(2, 10, 14, cin)).astype(np.float32)
    jblock = JaxResidualBlock(8, stride=stride, norm=norm, downsample=stride != 1)
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = seeded_tree(shapes, seed=8)
    assert ("batch_stats" in variables) == (norm == "BN")
    want = np.asarray(jblock.apply(variables, jnp.asarray(x)))
    block = ResidualBlock(cin, 8, stride=stride, norm=norm, downsample=stride != 1).eval()
    load_state_dict_checked(block, state_dict_from_jax(variables))
    with torch.no_grad():
        got = block(nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(nchw(want)), atol=1e-5, rtol=0)


def _norm_inputs():
    rng = np.random.default_rng(9)
    sparse = rng.normal(size=(5, 12, 16)).astype(np.float32)
    sparse[rng.uniform(size=sparse.shape) < 0.7] = 0.0
    return {"sparse": sparse, "zeros": np.zeros((5, 12, 16), np.float32),
            "constant": np.full((5, 12, 16), 0.5, np.float32),
            "one-nonzero": np.pad(np.ones((1, 1, 1), np.float32), ((0, 4), (0, 11), (0, 15)))}


@pytest.mark.parametrize("kind", ["sparse", "zeros", "constant", "one-nonzero"])
@pytest.mark.parametrize("unbiased", [False, True])
def test_legacy_norm_matches_jax(kind, unbiased):
    x = _norm_inputs()[kind]
    want = np.asarray(jax_legacy_norm(jnp.asarray(x), unbiased=unbiased))
    got = legacy_norm(torch.from_numpy(x), unbiased=unbiased).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got[x == 0] == 0).all()
    if kind in ("zeros", "constant"):
        np.testing.assert_array_equal(got, x)
    # batched: each leading entry on its own
    both = np.stack([x, _norm_inputs()["sparse"]])
    got_b = legacy_norm(torch.from_numpy(both), unbiased=unbiased, batched=True).numpy()
    np.testing.assert_allclose(got_b[0], got, atol=1e-6, rtol=0)


def test_run_sequence_is_the_step_loop_and_chunks_reset():
    torch.manual_seed(0)
    model = build_model("E2VIDRecurrent", SMALL, device="cpu")
    vox = torch.randn(6, 1, B, 32, 48)
    state0 = model.initial_state(1, 32, 48)
    with torch.no_grad():
        images, final = run_sequence(model, vox, state0)
        spec = ModelSpec("E2VIDRecurrent", model, num_encoders=2)
        st, loop = spec.initial_state(1, 32, 48), []
        for v in vox:
            out, st = spec.step(v, st)
            loop.append(out["image"])
        assert torch.equal(images, torch.stack(loop))
        for a, b in zip(jax.tree_util.tree_leaves(final), jax.tree_util.tree_leaves(st)):
            assert torch.equal(a, b)
        chunked = run_sequence_chunked(model, vox, state0, chunk=4)
        a, _ = run_sequence(model, vox[:4], state0)
        b, _ = run_sequence(model, vox[4:], state0)
    assert torch.equal(chunked, torch.cat([a, b]))
    assert not torch.allclose(chunked[4:], images[4:])  # the reset is a real one


@pytest.mark.parametrize("name", ["E2VIDRecurrent", "FireNet"])
def test_bf16_drift_within_the_jax_bound(name):
    """The eval CLI's --bf16 casts the whole model: over T=4 steps its images
    stay within the JAX package's own drift bound against f32 (0.08,
    tests/test_models_e2vid.py::test_bf16_drift_within_tolerance)."""
    torch.manual_seed(0)
    m32 = build_model(name, SMALL, device="cpu")
    m16 = build_model(name, SMALL, device="cpu", dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    vox = torch.randn(4, 1, B, 32, 32)
    with torch.no_grad():
        a, _ = run_sequence(m32, vox, m32.initial_state(1, 32, 32))
        b, state = run_sequence(m16, vox.bfloat16(), m16.initial_state(1, 32, 32))
    assert b.dtype == torch.bfloat16 and all(t.dtype == torch.bfloat16
                                             for t in jax.tree_util.tree_leaves(state))
    assert torch.isfinite(b).all()
    assert (a - b.float()).abs().max().item() < 0.08
