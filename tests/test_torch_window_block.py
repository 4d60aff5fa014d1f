"""Port parity of the WindowAttention3D body (``fused_window_block``) and the
bare attention core (``fused_window_attention``) vs the JAX package on the
CPU: the plain twins vs the interpret-mode Pallas kernels and the JAX twins,
the two autograd Functions vs ``jax.vjp`` of the JAX twins (f32 and bf16),
the kernel route of ``WindowAttention3D`` (with and without qkv biases), the
even-size dilated Swin block with DropPath, and the deterministic dilated
fold. Inputs come from numpy seeds; JAX runs on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bde2vid_tpu_torch.nn.window_attention as twa_mod
from bde2vid_tpu.nn import window_attention as jwa
from bde2vid_tpu.ops.window_attn_pallas import (
    _ref_window_attention,
    _ref_window_block,
    _window_block_pallas,
)
from bde2vid_tpu.ops.window_attn_pallas import fused_window_attention as jax_fused_window_attention
from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked, state_dict_from_jax
from bde2vid_tpu_torch.nn import window_attention as twa
from bde2vid_tpu_torch.ops import window_attn_cuda as wac
from bde2vid_tpu_torch.ops.window_attn_cuda import (
    WindowBlockParams,
    fused_window_attention,
    fused_window_block,
    launch_counts,
    window_attention_reference,
    window_block_reference,
)
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

T = torch.from_numpy
TOLS = {"float32": 1e-5, "bfloat16": 2e-2}


def seeded_params(init, *args, seed=0):
    """The variables of a flax ``init`` with values from a numpy seed in
    place of flax's initialisers. The tree comes from ``jax.eval_shape``,
    which traces once and compiles nothing (a jitted flax init of a small
    BDE2VID costs ~10 s on the CPU). Matrices and conv kernels get a
    fan-in-scaled normal, vectors a small normal around 1 (LayerNorm
    scales) or 0."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if len(s.shape) >= 2:
            return jnp.asarray(rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1])), s.dtype)
        base = 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else 0.0
        return jnp.asarray(base + 0.1 * rng.normal(size=s.shape), s.dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init, *args))


def _to_torch(a, dtype):
    return T(np.array(a, np.float32)).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# the attention core (B4)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b_,m,n", [(8, 16, 48), (7, 49, 147)])  # 7: a prime window count
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_attention_twin_matches_pallas_and_jax_twin(rng, b_, m, n, dtype):
    heads, c = 4, 16
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v, bias = f(b_, m, c), f(b_, n, c), f(b_, n, c), f(heads, m, n)
    jdt = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want_kernel = jax_fused_window_attention(jq, jk, jv, jnp.asarray(bias), heads, interpret=True)
    want_twin = _ref_window_attention(jq, jk, jv, jnp.asarray(bias), heads)
    before = launch_counts["fused_window_attention"]
    got = fused_window_attention(*(_to_torch(a, dtype) for a in (jq, jk, jv)), T(bias), heads)
    assert launch_counts["fused_window_attention"] == before  # the CPU runs the twin
    assert got.dtype == getattr(torch, dtype) and got.shape == (b_, m, c)
    for want in (want_kernel, want_twin):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=TOLS[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_attention_function_matches_twin_vjp(rng, dtype):
    """WindowAttentionFunction (twin forward, attention-core backward twin)
    vs jax.vjp of _ref_window_attention: every cotangent, dbias included."""
    b_, m, n, heads, c = 6, 16, 48, 4, 16
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    jdt = jnp.dtype(dtype)
    q, k, v, g = (jnp.asarray(f(*s)).astype(jdt) for s in ((b_, m, c), (b_, n, c), (b_, n, c), (b_, m, c)))
    bias = jnp.asarray(f(heads, m, n))
    _, vjp = jax.vjp(lambda qq, kk, vv, bb: _ref_window_attention(qq, kk, vv, bb, heads), q, k, v, bias)
    want = vjp(g)
    tq, tk, tv = (_to_torch(a, dtype).requires_grad_() for a in (q, k, v))
    tb = T(np.array(bias)).requires_grad_()
    out = fused_window_attention(tq, tk, tv, tb, heads)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv, tb), _to_torch(g, dtype))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4, err_msg=name)
        else:
            assert np.abs(a - b).max() <= 2e-2 * max(np.abs(b).max(), 1e-3), name


# ---------------------------------------------------------------------------
# the WindowAttention3D body (B3)
# ---------------------------------------------------------------------------


def _block_case(rng, d=3, b_=6, m=16, c=16, heads=4):
    """Inputs in the JAX package's layout: x (D, B_, M, C) and the params
    tuple (ln_q, ln_kv, w_q, w_k, w_v, w_proj, bias) of fused_window_block."""
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)
    x, g = f(d, b_, m, c), f(b_, m, c)
    ln = lambda: (f(c) + 1.0, f(c))
    lin = lambda: (f(c, c) * c**-0.5, f(c))
    return x, g, (ln(), ln(), lin(), lin(), lin(), lin(), f(heads, m, d * m))


def _torch_params(params) -> WindowBlockParams:
    ln_q, ln_kv, w_q, w_k, w_v, w_p, bias = params
    t = lambda a: T(np.ascontiguousarray(np.asarray(a, np.float32)))
    return WindowBlockParams(
        t(ln_q[0]), t(ln_q[1]), t(ln_kv[0]), t(ln_kv[1]), t(np.asarray(w_q[0]).T), t(w_q[1]),
        t(np.concatenate([w_k[0], w_v[0]], 1).T), t(np.concatenate([w_k[1], w_v[1]])),
        t(np.asarray(w_p[0]).T), t(w_p[1]), t(bias),
    )


def _jax_grads_in_torch_layout(dparams) -> dict:
    ln_q, ln_kv, w_q, w_k, w_v, w_p, bias = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), dparams)
    return dict(
        norm_q_w=ln_q[0], norm_q_b=ln_q[1], norm_kv_w=ln_kv[0], norm_kv_b=ln_kv[1],
        q_w=w_q[0].T, q_b=w_q[1], kv_w=np.concatenate([w_k[0], w_v[0]], 1).T,
        kv_b=np.concatenate([w_k[1], w_v[1]]), proj_w=w_p[0].T, proj_b=w_p[1], bias=bias,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_ind", [1, 0])
def test_window_block_twin_matches_pallas_and_jax_twin(rng, dtype, q_ind):
    heads = 4
    x, _, params = _block_case(rng)
    jdt = jnp.dtype(dtype)
    jx = jnp.asarray(x).astype(jdt)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want_out, want_acc = _window_block_pallas(heads, q_ind, True, True, jx, jparams, with_acc=True)
    want_twin = _ref_window_block(jx, jparams, heads, q_ind)
    before = launch_counts["fused_window_block"]
    out, acc = fused_window_block(_to_torch(jx, dtype), _torch_params(params), heads, q_ind,
                                  with_acc=True)
    assert launch_counts["fused_window_block"] == before
    assert out.dtype == acc.dtype == getattr(torch, dtype)
    tol = TOLS[dtype]
    np.testing.assert_allclose(acc.float().numpy(), np.asarray(want_acc, np.float32), atol=tol, rtol=0)
    for want in (want_out, want_twin):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_block_function_matches_twin_vjp(rng, dtype):
    """WindowBlockFunction (twin forward keeping acc; autograd of the pre
    stage and the out projection around the attention-core backward) vs
    jax.vjp of _ref_window_block: every cotangent; the key half of the k|v
    bias gradient, zero in exact arithmetic, bounded absolutely."""
    heads, q_ind = 4, 1
    x, g, params = _block_case(rng)
    jdt = jnp.dtype(dtype)
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    _, vjp = jax.vjp(lambda xx, pp: _ref_window_block(xx, pp, heads, q_ind), jx, jparams)
    want_dx, want_dp = vjp(jg)
    xt = _to_torch(jx, dtype).requires_grad_()
    p = WindowBlockParams(*[t.requires_grad_() for t in _torch_params(params)])
    out = fused_window_block(xt, p, heads, q_ind)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, [xt, *p], _to_torch(jg, dtype))
    want = {"x": np.asarray(want_dx, np.float32), **_jax_grads_in_torch_layout(want_dp)}
    for name, a in zip(("x", *WindowBlockParams._fields), got):
        a, b = a.float().numpy(), want[name]
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4, err_msg=name)
        else:
            assert np.abs(a - b).max() <= 2e-2 * max(np.abs(b).max(), 1e-3), name
    if dtype == "float32":  # bf16 rounds dk before it is summed, so only f32 is near zero
        c = x.shape[-1]
        assert got[1 + WindowBlockParams._fields.index("kv_b")][:c].abs().max() <= 1e-5


def test_window_block_launcher_refuses_inputs_that_require_grad(rng):
    x, _, params = _block_case(rng)
    p = WindowBlockParams(*[t.requires_grad_() for t in _torch_params(params)])
    with pytest.raises(RuntimeError, match="invisible to autograd"):
        wac._launch_window_block(T(x), p, 4, 1)
    q = T(x[1]).requires_grad_()
    with pytest.raises(RuntimeError, match="invisible to autograd"):
        wac._launch_window_attention(q, T(x[0]), T(x[2]), p.bias.detach()[:, :, :16], 4)
    with torch.no_grad():  # no gradient wanted: the launcher goes on to its device check
        with pytest.raises(ValueError, match="cuda"):
            wac._launch_window_block(T(x), p, 4, 1)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _flax_and_port(jmod, tmod, x):
    params = seeded_params(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    load_state_dict_checked(tmod, state_dict_from_jax(params))
    return params


@pytest.mark.parametrize("qkv_bias", [True, False])
def test_window_attention_module_kernel_route_matches_flax(rng, qkv_bias):
    """WindowAttention3D with the kernel (the twin on the CPU) vs the flax
    module on its Pallas path and its plain path, on shared params; without
    qkv biases both packages hold q and kv kernels only (the mirror of
    tests/test_pallas_attn.py::test_qkv_bias_false_tree_matches_across_paths)."""
    d, b_, wh, ww, c, heads = 3, 4, 8, 8, 16, 4
    x = rng.normal(size=(d, b_, wh, ww, c)).astype(np.float32)
    mk = lambda pallas: jwa.WindowAttention3D(c, (d, wh, ww), heads, qkv_bias=qkv_bias, use_pallas=pallas)
    tmod = twa.WindowAttention3D(c, (d, wh, ww), heads, qkv_bias=qkv_bias)
    params = _flax_and_port(mk(False), tmod, x)
    keys = set(tmod.state_dict())
    assert ("q.bias" in keys) == ("kv.bias" in keys) == qkv_bias
    with torch.no_grad():
        got_kernel = tmod(T(x), use_kernel=True).numpy()
        got_plain = tmod(T(x)).numpy()
    for pallas in (True, False):
        want = np.asarray(mk(pallas).apply(params, jnp.asarray(x)))
        np.testing.assert_allclose(got_kernel, want, atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(got_plain, want, atol=2e-5, rtol=1e-4)


def test_even_dilated_block_with_droppath_matches_jax(rng, monkeypatch):
    """The even dilated Swin block in training (DropPath 0.3) on the kernel
    route (B3's twin between the dilated partition and the fold) vs the JAX
    block on its Pallas path, both fed the same 0/1 keep draws: the output
    and the input's gradient."""
    d, b, c, heads = 3, 4, 16, 4
    win, hw = (4, 6), (13, 17)  # both sides padded
    keep = 0.7
    draws = [(rng.random(b) < keep).astype(np.float32) for _ in range(2)]
    draws[0][0], draws[1][1] = 0.0, 0.0  # at least one dropped branch each
    x = rng.normal(size=(d, b, *hw, c)).astype(np.float32)
    g = rng.normal(size=(b, *hw, c)).astype(np.float32)
    jmod = jwa.SwinTransformerBlock3D(c, heads, window_size=(d, *win), dilate_win=True,
                                      use_pallas=True, drop_path=1 - keep, deterministic=False)
    tmod = twa.SwinTransformerBlock3D(c, heads, window_size=(d, *win), dilate_win=True,
                                      use_kernel=True, drop_path=1 - keep).train()
    params = seeded_params(jmod.init, {"params": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1)},
                           jnp.asarray(x))
    load_state_dict_checked(tmod, state_dict_from_jax(params))

    it = iter(draws)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(next(it)).reshape(shape) > 0)
    fn = lambda xx: jmod.apply(params, xx, rngs={"droppath": jax.random.PRNGKey(2)})
    want, want_dx = jax.jit(lambda xx, gg: (lambda o, vjp: (o, vjp(gg)[0]))(*jax.vjp(fn, xx)))(
        jnp.asarray(x), jnp.asarray(g))
    monkeypatch.setattr(tmod, "keep_masks", lambda *a: tuple(T(dr) / keep for dr in draws))

    calls = []
    real = twa_mod.fused_window_block
    monkeypatch.setattr(twa_mod, "fused_window_block", lambda *a, **k: calls.append(1) or real(*a, **k))
    xt = T(x).requires_grad_()
    out = tmod(xt, generator=torch.Generator())
    assert calls == [1]  # the WindowAttention3D kernel route ran
    out.backward(T(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the dilated partition and fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("win", [(4, 4), (4, 6), (7, 7), (3, 5)])
def test_dilated_partition_and_fold_gradients_match_jax(rng, win):
    """The gather/fold pair's backward (a fold over the static taps, and a
    gather) vs jax.vjp of the JAX partition and reverse; the fold has one
    tap per pixel for odd windows and at most four for even ones."""
    wh, ww = win
    d, b, c = 2, 2, 3
    h, w = wh * 3 + 1, ww * 2 + 1
    x = rng.normal(size=(d, b, h, w, c)).astype(np.float32)
    taps = twa_mod._dilated_taps(h, w, wh, ww)
    assert taps.shape[1] == (1 if wh % 2 and ww % 2 else 4 if wh % 2 == ww % 2 == 0 else 2)

    def jfn(xx):
        win_tok = jwa.window_partition_dilated(xx, win)
        return jwa.window_reverse_dilated(win_tok[0] * win_tok[1], b, h, w)

    gy = rng.normal(size=(b, h, w, c)).astype(np.float32)
    want, vjp = jax.vjp(jfn, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(gy))
    xt = T(x).requires_grad_()
    win_tok = twa.window_partition_dilated(xt, win)
    out = twa.window_reverse_dilated(win_tok[0] * win_tok[1], b, h, w)
    out.backward(T(gy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), atol=1e-6, rtol=1e-6)


def test_twins_are_the_cpu_path_and_count_no_launch(rng):
    """The CPU runs the twins and launches nothing; the attention core is
    the ``bde2vid_tpu_torch.ops`` export, as in the JAX package."""
    from bde2vid_tpu_torch import ops

    assert ops.fused_window_attention is fused_window_attention
    x, _, params = _block_case(rng)
    p = _torch_params(params)
    before = dict(launch_counts)
    assert torch.equal(fused_window_block(T(x), p, 4, 1), window_block_reference(T(x), p, 4, 1))
    q, k, v = T(x[1]), T(x[0]), T(x[2])
    bias = p.bias[:, :, :16].contiguous()
    assert torch.equal(fused_window_attention(q, k, v, bias, 4),
                       window_attention_reference(q, k, v, bias, 4))
    assert dict(launch_counts) == before
