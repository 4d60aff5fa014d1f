"""Port parity of the training kernels' twins and their autograd Function vs
the JAX package on the CPU: the attention-core backward twin vs the
interpret-mode Pallas backward and ``jax.vjp`` of the JAX twin, the Swin
block under autograd (masked and unmasked) vs ``jax.vjp`` of the Pallas
block, and the saved ``acc``. Inputs come from numpy seeds; JAX runs on the
CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.ops.window_attn_pallas import (
    _attn_core_bwd_call,
    _ref_window_attention,
    _swin_block_pallas,
)
from bde2vid_tpu.ops.window_attn_pallas import fused_swin_block as jax_fused_swin_block
from bde2vid_tpu_torch.nn import window_attention as twa
from bde2vid_tpu_torch.ops import window_attn_cuda as wac
from bde2vid_tpu_torch.ops.window_attn_cuda import (
    SwinBlockParams,
    attn_core_backward,
    attn_core_backward_reference,
    fused_swin_block,
    launch_counts,
)

T = torch.from_numpy


def _core_inputs(rng, b_, m, n, heads, c):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(b_, m, c), f(b_, n, c), f(b_, n, c), f(heads, m, n), f(b_, m, c)


def test_backward_twin_matches_pallas_backward_and_twin_vjp(rng):
    """The shapes of tests/test_pallas_attn.py::test_bwd_kernel_matches_twin_vjp_attention."""
    b_, m, n, heads, c = 12, 49, 147, 4, 32
    q, k, v, bias, g = _core_inputs(rng, b_, m, n, heads, c)
    jargs = [jnp.asarray(a) for a in (q, k, v, bias)]
    kernel = _attn_core_bwd_call(heads, True, True, *jargs, jnp.asarray(g))
    _, vjp = jax.vjp(lambda qq, kk, vv, bb: _ref_window_attention(qq, kk, vv, bb, heads), *jargs)
    twin_vjp = vjp(jnp.asarray(g))
    before = launch_counts["attn_core_backward"]
    got = attn_core_backward(T(q), T(k), T(v), T(bias), T(g), heads)
    assert launch_counts["attn_core_backward"] == before  # the CPU runs the twin
    for name, a, want_k, want_v in zip(("dq", "dk", "dv", "dbias"), got, kernel, twin_vjp):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(want_k), atol=2e-5, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(want_v), atol=2e-5, rtol=1e-4, err_msg=name)


def test_backward_twin_bf16_matches_pallas_backward(rng):
    """The case of tests/test_pallas_attn.py::test_bwd_kernel_bf16_matches_twin_vjp,
    at its tolerance (2e-2 of the largest cotangent)."""
    b_, m, n, heads, c = 8, 49, 147, 4, 32
    ins = [jnp.asarray(a).astype(jnp.bfloat16) for a in _core_inputs(rng, b_, m, n, heads, c)]
    q, k, v, bias16, g = ins
    bias = bias16.astype(jnp.float32)  # the bias table stays f32
    want = _attn_core_bwd_call(heads, True, True, q, k, v, bias, g)
    tb = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    got = attn_core_backward_reference(tb(q), tb(k), tb(v), torch.from_numpy(np.asarray(bias)),
                                       tb(g), heads)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == (torch.float32 if name == "dbias" else torch.bfloat16), name
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        scale = max(np.abs(b).max(), 1e-3)
        assert np.abs(a - b).max() / scale < 2e-2, (name, float(np.abs(a - b).max()), float(scale))


def _block_case(rng, d=3, b_=8, m=49, c=32, heads=4):
    """The inputs of tests/test_pallas_attn.py::test_hybrid_block_backwards_match_twin_vjp,
    with a 4C-wide MLP."""
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)
    x, ctr, g = f(d, b_, m, c), f(b_, m, c), f(b_, m, c)
    ln = lambda: (f(c) + 1.0, f(c))
    lin = lambda i, o: (f(i, o) * i**-0.5, f(o))
    params = (ln(), ln(), lin(c, c), lin(c, c), lin(c, c), lin(c, c), ln(), lin(c, 4 * c),
              lin(4 * c, c), f(heads, m, d * m))
    return x, ctr, g, params


def _torch_params(params) -> SwinBlockParams:
    ln_q, ln_kv, w_q, w_k, w_v, w_p, ln2, fc1, fc2, bias = params
    t = lambda a: T(np.ascontiguousarray(a))
    return SwinBlockParams(
        t(ln_q[0]), t(ln_q[1]), t(ln_kv[0]), t(ln_kv[1]), t(w_q[0].T), t(w_q[1]),
        t(np.concatenate([w_k[0], w_v[0]], 1).T), t(np.concatenate([w_k[1], w_v[1]])),
        t(w_p[0].T), t(w_p[1]), t(ln2[0]), t(ln2[1]), t(fc1[0].T), t(fc1[1]),
        t(fc2[0].T), t(fc2[1]), t(bias),
    )


def _jax_grads_in_torch_layout(dparams) -> dict:
    """The JAX block's parameter cotangents, named and laid out like SwinBlockParams."""
    ln_q, ln_kv, w_q, w_k, w_v, w_p, ln2, fc1, fc2, bias = (
        jax.tree_util.tree_map(np.asarray, dparams))
    return dict(
        norm_q_w=ln_q[0], norm_q_b=ln_q[1], norm_kv_w=ln_kv[0], norm_kv_b=ln_kv[1],
        q_w=w_q[0].T, q_b=w_q[1], kv_w=np.concatenate([w_k[0], w_v[0]], 1).T,
        kv_b=np.concatenate([w_k[1], w_v[1]]), proj_w=w_p[0].T, proj_b=w_p[1],
        norm2_w=ln2[0], norm2_b=ln2[1], fc1_w=fc1[0].T, fc1_b=fc1[1], fc2_w=fc2[0].T,
        fc2_b=fc2[1], bias=bias,
    )


@pytest.mark.parametrize("masked", [False, True])
def test_block_autograd_matches_jax_vjp(rng, masked):
    """fused_swin_block under autograd (SwinBlockFunction over the twins)
    vs jax.vjp of the JAX fused_swin_block in interpret mode: every
    cotangent, at the bound of test_hybrid_block_backwards_match_twin_vjp."""
    d, b_, heads, q_ind = 3, 8, 4, 1
    x, ctr, g, params = _block_case(rng, d=d, b_=b_, heads=heads)
    masks = None
    if masked:
        keep = 0.75
        masks = tuple((rng.random(b_) < keep).astype(np.float32) / keep for _ in range(2))
    jmasks = None if masks is None else tuple(jnp.asarray(mk) for mk in masks)
    fn = lambda xx, cc, pp: jax_fused_swin_block(
        xx, cc, *pp[:-1], pp[-1], heads, q_ind, activation="gelu", interpret=True, masks=jmasks)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want_out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(ctr), jparams)
    want_dx, want_dctr, want_dp = vjp(jnp.asarray(g))

    p = SwinBlockParams(*[t.requires_grad_() for t in _torch_params(params)])
    xt, ct = T(x).requires_grad_(), T(ctr).requires_grad_()
    out = fused_swin_block(xt, ct, p, heads, q_ind,
                           masks=None if masks is None else tuple(T(mk) for mk in masks))
    assert type(out.grad_fn).__name__ == "SwinBlockFunctionBackward"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=2e-5, rtol=1e-4)
    out.backward(T(g))
    tol = dict(atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **tol, err_msg="x")
    assert not xt.grad[q_ind].any()  # the stale centre row is never read
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(want_dctr), **tol, err_msg="ctr")
    for name, want in _jax_grads_in_torch_layout(want_dp).items():
        np.testing.assert_allclose(getattr(p, name).grad.numpy(), want, **tol, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_acc_output_matches_pallas_with_acc(rng, masked):
    d, b_, heads, q_ind = 3, 8, 4, 1
    x, ctr, _, params = _block_case(rng, d=d, b_=b_, heads=heads)
    masks = (np.array([0.0, 1.25] * 4, np.float32), np.array([1.25, 1.25, 0.0, 1.25] * 2, np.float32))
    jm = tuple(jnp.asarray(mk) for mk in masks) if masked else None
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want_out, want_acc = _swin_block_pallas(heads, q_ind, "gelu", True, True, jnp.asarray(x),
                                            jnp.asarray(ctr), jparams, with_acc=True, masks=jm)
    tm = tuple(T(mk) for mk in masks) if masked else None
    out, acc = fused_swin_block(T(x), T(ctr), _torch_params(params), heads, q_ind, masks=tm,
                                with_acc=True)
    np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5, rtol=0)


def test_kernel_launcher_refuses_inputs_that_require_grad(rng):
    """Fault 1: a ctypes launch writes into fresh tensors that autograd knows
    nothing of, so a block whose inputs require grad came back without a
    grad_fn and the attention parameters got no gradient. The launchers now
    refuse such inputs (before they look at the device)."""
    x, ctr, g, params = _block_case(rng)
    p = SwinBlockParams(*[t.requires_grad_() for t in _torch_params(params)])
    with pytest.raises(RuntimeError, match="invisible to autograd"):
        wac._launch_swin_block(T(x), T(ctr), p, 4, 1, "gelu", None)
    q = T(g).requires_grad_()
    with pytest.raises(RuntimeError, match="invisible to autograd"):
        wac._launch_attn_core_backward(q, T(x[0]), T(x[1]), p.bias.detach(), T(g), 4)
    with torch.no_grad():  # no gradient wanted: the launcher goes on to its device check
        with pytest.raises(ValueError, match="cuda"):
            wac._launch_swin_block(T(x), T(ctr), p, 4, 1, "gelu", None)


def test_kernel_path_gives_every_attention_parameter_a_gradient(rng):
    """Fault 1, the repaired path: a Swin block on the kernel path in
    training gives every parameter of the block, the relative-position
    table included, a non-zero gradient, and passes one to its input."""
    c, heads, d = 16, 4, 3
    blk = twa.SwinTransformerBlock3D(c, heads, window_size=(d, 7, 7), use_kernel=True).train()
    x = T(rng.normal(size=(d, 2, 14, 14, c)).astype(np.float32)).requires_grad_()
    out = blk(x)
    assert out.grad_fn is not None
    out.square().mean().backward()
    for name, prm in blk.named_parameters():
        assert prm.grad is not None and prm.grad.abs().max() > 0, name
    assert x.grad.abs().max() > 0
