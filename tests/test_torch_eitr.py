"""EITR and its transformer blocks in the port vs the JAX package on the CPU
in f32, with the flax variables (numpy-seeded) carried over by
``state_dict_from_jax``: multi-head attention (self and cross; also against
torch's own ``nn.MultiheadAttention`` on its state dict), the pre-norm
encoder and decoder layers and stacks within 1e-5, the sine position table
bit-equal, the generic post-norm ``Transformer`` (parity, shapes, and that
positions and the task embedding move its output), and the whole ``EITR``
at tests/test_eitr.py's small widths (d 32, 4 heads) on a non-/8 36x44
input over 3 steps, with and without the transformer decoders and with BN,
images and states within 2e-4 (tests/test_bde2vid.py:313). An EITR
pytorch-template checkpoint (``eitr_kwargs``) loads through both packages'
``load_model_from_torch`` and gives the same images.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.eval.checkpoint import load_model_from_torch as jax_load
from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.models.api import run_sequence as jax_run_sequence
from bde2vid_tpu.nn import transformer as jtr
from bde2vid_tpu_torch.eval.checkpoint import (
    load_model_from_torch,
    load_state_dict_checked,
    state_dict_from_jax,
)
from bde2vid_tpu_torch.models import build_model, run_sequence
from bde2vid_tpu_torch.nn import transformer as ttr
from tests.test_torch_checkpoint_dialects import seeded_state_dict
from tests.test_torch_e2vid import nchw, seeded_tree
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

ATOL = 2e-4
D, HEADS, FF = 32, 4, 64
SMALL = {"num_bins": 5, "norm": None, "d_model": D, "dim_feedforward": FF, "nhead": HEADS,
         "channels": [8, 16, 32, 32]}
H, W = 36, 44  # pads to 40x48 inside the model


def _variables(module, *inputs, seed):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs))
    return seeded_tree(shapes, seed)


def _tokens(*lengths, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, n, D)).astype(np.float32) for n in lengths]


def _port_under(module, variables, parent):
    """Load a stack's flax variables into the port's module: the JAX stack
    is named as EITR names it (``parent``), so the ``.encoder`` /
    ``.decoder`` level appears, then the parent's prefix is dropped."""
    sd = state_dict_from_jax({k: {parent: v} for k, v in variables.items()})
    load_state_dict_checked(module, {k.removeprefix(parent + "."): v for k, v in sd.items()})
    return module.eval()


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("cross", [False, True])
def test_multihead_attention_matches_jax_and_torch(cross):
    q, kv = _tokens(10, 14 if cross else 10)
    if not cross:
        kv = q
    jmha = jtr.MultiheadAttention(D, HEADS)
    variables = _variables(jmha, q, kv, kv, seed=2)
    want = jmha.apply(variables, q, kv, kv)
    mha = ttr.MultiheadAttention(D, HEADS)
    sd = state_dict_from_jax(variables)
    assert sorted(sd) == ["in_proj_bias", "in_proj_weight", "out_proj.bias", "out_proj.weight"]
    load_state_dict_checked(mha, sd)
    got = mha(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv))
    _close(got, want)
    # the parameters are torch's own: nn.MultiheadAttention computes the same
    ref = torch.nn.MultiheadAttention(D, HEADS, dropout=0.0, batch_first=True).eval()
    ref.load_state_dict(mha.state_dict())
    with torch.no_grad():
        want_t = ref(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv))[0]
    _close(got, want_t.numpy())


@pytest.mark.parametrize("kind", ["encoder_layer", "decoder_layer", "encoder", "decoder"])
def test_transformer_blocks_match_jax(kind):
    src, mem = _tokens(12, 12, seed=3)
    pos = _tokens(12, seed=4)[0][:1]
    if kind == "encoder_layer":
        jmod, mod, args = jtr.TransformerEncoderLayer(D, HEADS, FF), ttr.TransformerEncoderLayer(D, HEADS, FF), (src,)
    elif kind == "decoder_layer":
        jmod, mod, args = jtr.TransformerDecoderLayer(D, HEADS, FF), ttr.TransformerDecoderLayer(D, HEADS, FF), (src, mem)
    elif kind == "encoder":
        jmod, mod, args = jtr.TransformerEncoder(D, HEADS, 2, FF), ttr.TransformerEncoder(D, HEADS, 2, FF), (src, pos)
    else:
        jmod, mod, args = jtr.TransformerDecoder(D, HEADS, 2, FF), ttr.TransformerDecoder(D, HEADS, 2, FF), (src, mem)
    variables = _variables(jmod, *args, seed=5)
    want = jmod.apply(variables, *args)
    if kind in ("encoder", "decoder"):
        _port_under(mod, variables, f"trans_{kind}0")
    else:
        load_state_dict_checked(mod, state_dict_from_jax(variables))
    with torch.no_grad():
        got = mod(*map(torch.from_numpy, args))
    _close(got, want)


@pytest.mark.parametrize("n,d", [(690, 256), (30, 32), (16, 8)])
def test_sine_position_table_is_bit_equal(n, d):
    got = ttr.sine_position_table(n, d)
    assert got.dtype == np.float32 and got.shape == (n, d)
    np.testing.assert_array_equal(got, jtr.sine_position_table(n, d))


def test_generic_transformer_matches_jax_and_uses_pos_and_task():
    src = _tokens(10, seed=6)[0]
    pos, task = (t[:1] for t in _tokens(10, 10, seed=7))
    jmod = jtr.Transformer(d_model=D, nhead=HEADS, num_encoder_layers=2, num_decoder_layers=2,
                           dim_feedforward=FF)
    variables = _variables(jmod, src, pos, task, seed=8)
    mod = ttr.Transformer(D, HEADS, 2, 2, FF).eval()
    load_state_dict_checked(mod, state_dict_from_jax(variables))
    with torch.no_grad():
        got = mod(*map(torch.from_numpy, (src, pos, task)))
        bare = mod(torch.from_numpy(src))
        no_task = mod(torch.from_numpy(src), torch.from_numpy(pos))
    assert got.shape == src.shape and torch.isfinite(got).all()
    _close(got, jmod.apply(variables, src, pos, task))
    _close(bare, jmod.apply(variables, src, None, None))
    assert not torch.allclose(got, bare) and not torch.allclose(got, no_task)


CASES = {"decoder": SMALL, "no-decoder": dict(SMALL, use_trans_decoder=False),
         "BN": dict(SMALL, norm="BN")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eitr_matches_jax_over_three_steps(case):
    cfg = CASES[case]
    jmodel = jax_build("EITR", dict(cfg))
    variables = _variables(jmodel, jnp.zeros((1, H, W, 5)), jmodel.initial_state(1, H, W), seed=9)
    if case == "no-decoder":
        assert not any(k.startswith("trans_decoder") for k in variables["params"])
    vox = np.random.default_rng(10).normal(size=(3, 1, H, W, 5)).astype(np.float32)
    want, want_state = jax.jit(lambda v, x: jax_run_sequence(
        jmodel, v, x, jmodel.initial_state(1, H, W)))(variables, jnp.asarray(vox))
    model = build_model("EITR", cfg, device="cpu")
    load_state_dict_checked(model, state_dict_from_jax(variables))
    with torch.no_grad():
        got, state = run_sequence(model, nchw(vox), model.initial_state(1, H, W))
    assert got.shape == (3, 1, 1, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(nchw(want)), atol=ATOL, rtol=0)
    got_leaves, want_leaves = jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(want_state)
    assert len(got_leaves) == len(want_leaves) == 6
    for g, wl in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(nchw(wl)), atol=ATOL, rtol=0)


def test_initial_state_lives_at_the_padded_size():
    jmodel, model = jax_build("EITR", dict(SMALL)), build_model("EITR", SMALL, device="cpu")
    for h, w in ((36, 44), (33, 47), (184, 240)):
        want = [tuple(np.moveaxis(np.empty(a.shape), -1, -3).shape)
                for a in jax.tree_util.tree_leaves(jmodel.initial_state(1, h, w))]
        assert [tuple(a.shape) for a in jax.tree_util.tree_leaves(model.initial_state(1, h, w))] == want


def test_d_model_must_equal_the_last_channels():
    with pytest.raises(ValueError, match="d_model"):
        build_model("EITR", dict(SMALL, d_model=64), device="cpu")


def test_template_checkpoint_loads_in_both_packages(tmp_path):
    model = build_model("EITR", SMALL, device="cpu")
    path = str(tmp_path / "eitr.pth")
    torch.save({"arch": "EITR", "config": {"arch": {"args": {"eitr_kwargs": SMALL}}},
                "state_dict": seeded_state_dict(model, 11)}, path)
    spec, jspec = load_model_from_torch(path, device="cpu"), jax_load(path)
    assert spec.name == jspec.name == "EITR"
    assert spec.num_encoders == jspec.num_encoders == 3
    assert not spec.normalize and not getattr(jspec, "normalize", False)
    vox = np.random.default_rng(12).normal(size=(2, 1, H, W, 5)).astype(np.float32)
    want, _ = jax.jit(lambda v, x: jax_run_sequence(
        jspec.module, v, x, jspec.module.initial_state(1, H, W)))(jspec.params, jnp.asarray(vox))
    with torch.no_grad():
        got, _ = run_sequence(spec.module, nchw(vox), spec.initial_state(1, H, W))
    np.testing.assert_allclose(got.numpy(), np.asarray(nchw(want)), atol=ATOL, rtol=0)


def test_bf16_drift_within_the_jax_bound():
    """bf16 against f32 on the same weights over 3 steps: within the JAX
    package's own drift bound (0.08); the states stay bf16."""
    torch.manual_seed(0)
    m32 = build_model("EITR", SMALL, device="cpu")
    m16 = build_model("EITR", SMALL, device="cpu", dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    vox = torch.randn(3, 1, 5, H, W)
    with torch.no_grad():
        a, _ = run_sequence(m32, vox, m32.initial_state(1, H, W))
        b, state = run_sequence(m16, vox.bfloat16(), m16.initial_state(1, H, W))
    assert b.dtype == torch.bfloat16 and all(t.dtype == torch.bfloat16
                                             for t in jax.tree_util.tree_leaves(state))
    assert (a - b.float()).abs().max().item() < 0.08
