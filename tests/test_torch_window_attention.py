"""Port parity: window partition/reverse, relative-position index, the fused
Swin block (plain twin vs the JAX twin and the interpret-mode Pallas kernel)
and the Swin/DFrameAttention modules vs flax. Inputs come from numpy seeds
and go through both packages; JAX runs on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.nn import window_attention as jwa
from bde2vid_tpu.ops.window_attn_pallas import _ref_swin_block
from bde2vid_tpu.ops.window_attn_pallas import fused_swin_block as jax_fused_swin_block
from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked, state_dict_from_jax
from bde2vid_tpu_torch.nn import window_attention as twa
from bde2vid_tpu_torch.ops.window_attn_cuda import (
    SwinBlockParams,
    fused_swin_block,
    launch_counts,
    swin_block_reference,
)
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

T = torch.from_numpy


@pytest.mark.parametrize("win", [(7, 7), (4, 4), (3, 5), (4, 6)])
@pytest.mark.parametrize("dilated", [False, True])
def test_partition_and_reverse_equal_jax(rng, win, dilated):
    wh, ww = win
    d, b, c = 2, 2, 3
    h, w = wh * 3, ww * 2
    x = rng.normal(size=(d, b, h, w, c)).astype(np.float32)
    jpart = jwa.window_partition_dilated if dilated else jwa.window_partition
    tpart = twa.window_partition_dilated if dilated else twa.window_partition
    jrev = jwa.window_reverse_dilated if dilated else jwa.window_reverse
    trev = twa.window_reverse_dilated if dilated else twa.window_reverse
    jw = np.array(jpart(jnp.asarray(x), win))
    tw = tpart(T(x), win).numpy()
    np.testing.assert_array_equal(tw, jw)
    jr = np.asarray(jrev(jnp.asarray(jw[0]), b, h, w))
    tr = trev(T(tw[0]), b, h, w).numpy()
    np.testing.assert_array_equal(tr, jr)


@pytest.mark.parametrize("args", [(3, 7, 7, None, None), (7, 7, 7, None, None), (3, 7, 7, 5, 5),
                                  (7, 7, 7, 4, 6), (1, 4, 6, 2, 6)])
def test_relative_position_index_equal_jax(args):
    np.testing.assert_array_equal(twa.relative_position_index(*args),
                                  jwa.relative_position_index(*args))


def _block_inputs(rng, dilated, d=3, b=1, h=14, w=14, c=16, heads=4, win=(7, 7)):
    """Window tokens from a random feature map, partitioned plain or
    dilation-2, and random block weights in the JAX package's layout."""
    part = jwa.window_partition_dilated if dilated else jwa.window_partition
    feats = rng.normal(size=(d + 1, b, h, w, c)).astype(np.float32)
    x = np.array(part(jnp.asarray(feats[:d]), win))
    ctr = np.array(part(jnp.asarray(feats[d:]), win))[0]
    m = win[0] * win[1]
    x = x.reshape(d, -1, m, c)
    ctr = ctr.reshape(-1, m, c)
    hid = 4 * c

    def f(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    ln = lambda: (1 + f(c, scale=0.1), f(c, scale=0.1))
    lin = lambda i, o: (f(i, o, scale=i**-0.5), f(o, scale=0.1))
    params = (ln(), ln(), lin(c, c), lin(c, c), lin(c, c), lin(c, c), ln(), lin(c, hid),
              lin(hid, c), f(heads, m, d * m, scale=0.5))
    return x, ctr, params


def _torch_params(params) -> SwinBlockParams:
    ln_q, ln_kv, w_q, w_k, w_v, w_p, ln2, fc1, fc2, bias = params
    t = lambda a: T(np.ascontiguousarray(a))
    return SwinBlockParams(
        t(ln_q[0]), t(ln_q[1]), t(ln_kv[0]), t(ln_kv[1]), t(w_q[0].T), t(w_q[1]),
        t(np.concatenate([w_k[0], w_v[0]], 1).T), t(np.concatenate([w_k[1], w_v[1]])),
        t(w_p[0].T), t(w_p[1]), t(ln2[0]), t(ln2[1]), t(fc1[0].T), t(fc1[1]),
        t(fc2[0].T), t(fc2[1]), t(bias),
    )


@pytest.mark.parametrize("dilated", [False, True])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_swin_block_twin_matches_jax_twin_and_interpret_kernel(rng, dilated, dtype, atol):
    heads, q_ind = 4, 1
    x, ctr, params = _block_inputs(rng, dilated, heads=heads)
    jdt = jnp.dtype(dtype)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jx, jc = jnp.asarray(x).astype(jdt), jnp.asarray(ctr).astype(jdt)
    want_twin = np.asarray(_ref_swin_block(jx, jc, jparams, heads, q_ind, "gelu"), np.float32)
    want_kernel = np.asarray(
        jax_fused_swin_block(jx, jc, *jparams, heads, q_ind, interpret=True), np.float32
    )
    tdt = getattr(torch, dtype)
    got = swin_block_reference(T(x).to(tdt), T(ctr).to(tdt), _torch_params(params), heads, q_ind)
    assert got.dtype == tdt and got.shape == ctr.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want_twin, atol=atol, rtol=0)
    np.testing.assert_allclose(got, want_kernel, atol=atol, rtol=0)


def test_fused_swin_block_on_cpu_is_the_twin_and_counts_no_launch(rng):
    x, ctr, params = _block_inputs(rng, False)
    before = launch_counts["fused_swin_block"]
    p = _torch_params(params)
    a = fused_swin_block(T(x), T(ctr), p, 4, 1)
    b = swin_block_reference(T(x), T(ctr), p, 4, 1)
    assert torch.equal(a, b)
    assert launch_counts["fused_swin_block"] == before


def _flax_and_port(jmod, tmod, x, *call_args):
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), *call_args)
    load_state_dict_checked(tmod, state_dict_from_jax(params))
    return params


_BLOCK_CASES = {
    # dilated 7x7 block on a 14x14 map: ~38% of pixels no dilated window
    # samples, so the uncovered-pixel blend runs
    "dilated_block": dict(kind="block", dilate=True, hw=(14, 14), win=(7, 7), d=3),
    "plain_block_padded": dict(kind="block", dilate=False, hw=(13, 18), win=(7, 7), d=3),
    "dframe_depth3": dict(kind="dframe", depth=3, hw=(13, 18), win=(7, 7), d=5),
    # even dilated windows: the kernel path runs the plain body on the CPU
    "even_dilated_block": dict(kind="block", dilate=True, hw=(12, 12), win=(4, 4), d=3),
}


@pytest.mark.parametrize("case", sorted(_BLOCK_CASES))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_swin_modules_match_flax(rng, case, use_kernel):
    cfg = _BLOCK_CASES[case]
    c, heads, b = 16, 4, 2
    d = cfg["d"]
    h, w = cfg["hw"]
    wsz = (d, *cfg["win"])
    x = rng.normal(size=(d, b, h, w, c)).astype(np.float32)
    if cfg["kind"] == "block":
        jmod = jwa.SwinTransformerBlock3D(c, heads, window_size=wsz, dilate_win=cfg["dilate"],
                                          use_pallas=use_kernel)
        tmod = twa.SwinTransformerBlock3D(c, heads, window_size=wsz, dilate_win=cfg["dilate"],
                                          use_kernel=use_kernel)
    else:
        jmod = jwa.DFrameAttention(c, cfg["depth"], heads, window_size=wsz, use_pallas=use_kernel)
        tmod = twa.DFrameAttention(c, cfg["depth"], heads, window_size=wsz, use_kernel=use_kernel)
    params = _flax_and_port(jmod, tmod, x)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(T(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
