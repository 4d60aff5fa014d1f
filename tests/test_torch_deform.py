"""Port parity of the deformable convolution and its blocks
(``nn/deform.py``), the two recurrent layers ``RecurrentUpConv`` and
``DownsampleRecurrentConvLayer`` and ``resize_bilinear_half``: the same
seeded inputs and flax params (carried across by ``state_dict_from_jax``)
through both packages. CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bde2vid_tpu.nn import deform as jd
from bde2vid_tpu.nn import layers as jl
from bde2vid_tpu.nn import recurrent as jr
from bde2vid_tpu_torch.eval.checkpoint import state_dict_from_jax
from bde2vid_tpu_torch.nn import deform as td
from bde2vid_tpu_torch.nn import layers as tl
from bde2vid_tpu_torch.nn import recurrent as tr


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def close(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * max(1.0, np.abs(ref).max())


def seeded_variables(module, seed, *inputs):
    """flax variables of ``module`` by shape (``jax.eval_shape`` of its
    init), filled from a numpy seed: kernels and deform weights a
    fan-in-scaled normal, biases and scales near 0 and 1, BN variances in
    [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a), *inputs)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        key = jax.tree_util.keystr(path)
        if len(s.shape) >= 2:
            return rng.normal(size=s.shape).astype(np.float32) / np.sqrt(np.prod(s.shape[:-1]))
        if key.endswith("['var']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        base = 1.0 if key.endswith("['scale']") else 0.0
        return (base + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_module(module, variables):
    module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return module.eval()


DEFORM_CASES = {  # (stride, padding, dilation, deform_groups, offset scale)
    "s1": (1, 1, 1, 1, 1.5),
    "s2": (2, 1, 1, 1, 1.5),
    "s1_dg2": (1, 1, 1, 2, 1.5),
    "s2_dg2_outside": (2, 0, 2, 2, 6.0),
}


def deform_inputs(case, n=2, c=4, h=9, w=11, o=5, k=3):
    stride, padding, dilation, dg, scale = DEFORM_CASES[case]
    rng = np.random.default_rng(sorted(DEFORM_CASES).index(case))
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    off = (rng.normal(size=(n, ho, wo, dg * 2 * k * k)) * scale).astype(np.float32)
    wt = (rng.normal(size=(k, k, c, o)) / np.sqrt(k * k * c)).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    return x, off, wt, b, dict(stride=stride, padding=padding, dilation=dilation, deform_groups=dg)


def port_deform(x, off, wt, b, kw):
    return td.deform_conv2d(nchw(x), nchw(off), torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()),
                            None if b is None else torch.from_numpy(b), **kw)


@pytest.mark.parametrize("case", sorted(DEFORM_CASES))
def test_deform_conv2d_matches_jax(case):
    x, off, wt, b, kw = deform_inputs(case)
    got = port_deform(x, off, wt, b, kw)
    close(nhwc(got), jd.deform_conv2d(jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt),
                                      jnp.asarray(b), **kw))
    if case == "s2_dg2_outside":  # some taps sample wholly outside the image
        h, w = x.shape[1:3]
        py = off[..., 0::2]
        assert (np.abs(py) > h).any() or (np.abs(off[..., 1::2]) > w).any()


@pytest.mark.parametrize("case", ["s1", "s2_dg2_outside"])
def test_deform_conv2d_vjp_matches_jax(case):
    """The gradients with respect to x, offsets and weight against
    ``jax.vjp``, within 1e-4 relative."""
    x, off, wt, _, kw = deform_inputs(case)
    out, vjp = jax.vjp(lambda a, o, w: jd.deform_conv2d(a, o, w, None, **kw),
                       jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt))
    g = np.random.default_rng(9).normal(size=out.shape).astype(np.float32)
    gx, goff, gw = vjp(jnp.asarray(g))
    tx, toff = nchw(x).requires_grad_(), nchw(off).requires_grad_()
    tw = torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()).requires_grad_()
    y = td.deform_conv2d(tx, toff, tw, None, **kw)
    y.backward(nchw(g))
    close(nhwc(tx.grad), gx, 1e-4)
    close(nhwc(toff.grad), goff, 1e-4)
    close(tw.grad.numpy().transpose(2, 3, 1, 0), gw, 1e-4)


def test_zero_offsets_equal_a_conv():
    x, off, wt, b, kw = deform_inputs("s2")
    got = port_deform(x, np.zeros_like(off), wt, b, kw)
    ref = F.conv2d(nchw(x), torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b),
                   stride=2, padding=1)
    assert torch.allclose(got, ref, atol=1e-5)


def _modules():
    """(name, flax module, port module, flax inputs NHWC); C 8 at 9x11."""
    return {
        "DeformConv2dPack": (jd.DeformConv2dPack(6, 3, stride=2, padding=1, use_bias=True),
                             td.DeformConv2dPack(8, 6, 3, stride=2, padding=1, use_bias=True), 1),
        "AlignAdd": (jd.AlignAdd(4), td.AlignAdd(8, 4), 1),
        "AlignAdd2": (jd.AlignAdd2(4, deform_groups=2), td.AlignAdd2(8, 4, deform_groups=2), 1),
        "SepDconv": (jd.SepDconv(6, deform_groups=2), td.SepDconv(5, 8, 6, deform_groups=2), 2),
        "GatedAdd": (jd.GatedAdd(6), td.GatedAdd(8, 6), 1),
    }


@pytest.mark.parametrize("name", ["DeformConv2dPack", "AlignAdd", "AlignAdd2", "SepDconv",
                                  "GatedAdd"])
def test_deform_modules_with_jax_params(name):
    """Every param filled (the offset convs too, so the offsets are not 0),
    carried across by state_dict_from_jax and loaded strictly."""
    flax_mod, ours, n_inputs = _modules()[name]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 9, 11, 8)).astype(np.float32)
    inputs = [jnp.asarray(x)]
    if n_inputs == 2:  # SepDconv(offset_x, x, init_offset)
        inputs = [jnp.asarray(rng.normal(size=(2, 9, 11, 5)).astype(np.float32)), jnp.asarray(x)]
    variables = seeded_variables(flax_mod, 12, *inputs)
    port_module(ours, variables)
    if name == "SepDconv":
        init = rng.normal(size=(2, 9, 11, 2 * 2 * 9)).astype(np.float32)
        ref_out, ref_off = flax_mod.apply(variables, *inputs, jnp.asarray(init))
        out, offsets = ours(*(nchw(a) for a in inputs), nchw(init))
        close(nhwc(out), ref_out)
        close(nhwc(offsets), ref_off)
        return
    ref = flax_mod.apply(variables, *inputs)
    close(nhwc(ours(*(nchw(a) for a in inputs))), ref)


@pytest.mark.parametrize("hw", [(8, 10), (7, 9)])
def test_resize_bilinear_half_matches_jax(hw):
    x = np.random.default_rng(13).normal(size=(2,) + hw + (3,)).astype(np.float32)
    got = tl.resize_bilinear_half(nchw(x))
    close(nhwc(got), jl.resize_bilinear_half(jnp.asarray(x)), 1e-6)
    if hw == (7, 9):  # scale_factor=0.5 maps with ratio 2, not in / out
        off = F.interpolate(nchw(x), scale_factor=0.5, mode="bilinear", align_corners=False)
        assert (off - got).abs().max() > 0.1


RECURRENT_CASES = [("up", "convlstm", None, 0), ("up", "convgru", None, 2), ("up", "convlstm", "BN", 2),
                   ("down", "convlstm", None, 3), ("down", "convgru", None, 5)]


@pytest.mark.parametrize("hw", [(8, 10), (7, 9)])
@pytest.mark.parametrize("kind,block,norm,k", RECURRENT_CASES)
def test_recurrent_layers_two_steps(hw, kind, block, norm, k):
    """Two steps carrying the state from ``initial_state``; outputs and
    state against JAX's."""
    cin, cout = 3, 4
    h, w = hw
    if kind == "up":
        flax_mod = jr.RecurrentUpConv(cout, kernel_size=5, padding=k, recurrent_block_type=block,
                                      norm=norm)
        ours = tr.RecurrentUpConv(cin, cout, kernel_size=5, padding=k, recurrent_block_type=block,
                                  norm=norm)
    else:
        flax_mod = jr.DownsampleRecurrentConvLayer(cout, kernel_size=k, recurrent_block_type=block)
        ours = tr.DownsampleRecurrentConvLayer(cin, cout, kernel_size=k, recurrent_block_type=block)
    rng = np.random.default_rng(14)
    xs = [rng.normal(size=(2, h, w, cin)).astype(np.float32) for _ in range(2)]
    state = flax_mod.initial_state(2, h, w)
    variables = seeded_variables(flax_mod, 15, jnp.asarray(xs[0]), state)
    port_module(ours, variables)
    tstate = ours.initial_state(2, h, w)
    for x in xs:
        ref, state = flax_mod.apply(variables, jnp.asarray(x), state)
        got, tstate = ours(nchw(x), tstate)
        close(nhwc(got), ref)
    for g, r in zip(jax.tree_util.tree_leaves(tstate), jax.tree_util.tree_leaves(state)):
        close(nhwc(g), r)
