"""Head dims above 256 (ROADMAP C7, repaired) and the wide backward's
decomposition (head_dim above 32, ``attn_bwd_scores_kernel`` in
csrc/attn_core_bwd.cu).

On the CPU: the plans and launch checks at head_dim 320 to 1024 over rows of
343 and 1519 keys; the twins against the JAX package's fused attention in
interpret mode and its VJP at C 512 with one head; and the wide backward's
launches emulated in plain torch (per key tile statistics merged in tile
order, s and dp summed over 64-column chunks, round(p) and round(ds scale)
in the operand type, one ds plane a window summed in window order) against
the twin under the kernel-vs-twin gates.
The kernels themselves run in tests/test_torch_cuda.py and chip_smoke.py's
``head_dims`` phase, which also holds the flagship at base 64 with one head
(head_dim 512 at level 2) to the unfused path on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.ops.window_attn_pallas import fused_window_attention as jax_attention
from bde2vid_tpu_torch.ops.window_attn_cuda import (
    WIDE_THREADS,
    _MAX_SMEM,
    _check_head_dim,
    _heads,
    attn_core_backward_reference,
    attn_core_bwd_plan,
    attn_core_reference,
    attn_forward_plan,
    attn_key_tiled,
    bwd_counter,
)

WIDE_HEAD_DIMS = (320, 384, 512, 1024)
LOG2E = 1.4426950408889634


@pytest.mark.parametrize("hd", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("n", [343, 1519])
def test_plans_and_launch_checks_take_head_dims_up_to_1024(hd, n):
    """One head of head_dim 320 to 1024 (the flagship at base 64 and 128
    gives 512 and 1024 at level 2): both plans return, wide forward and
    wide backward, within one block's shared memory, and the launchers'
    check accepts the width."""
    _check_head_dim(hd, 1)
    for bf16 in (False, True):
        fwd = attn_forward_plan(20, 1, 49, n, hd, sms=132, blocks_per_sm=1, bf16=bf16)
        assert fwd.wide and fwd.threads == WIDE_THREADS and not attn_key_tiled(49, n, hd, bf16)
    bwd = attn_core_bwd_plan(49, n, hd, 1)
    assert bwd_counter(bwd, hd) == "attn_core_backward_wide"
    assert bwd.row_share == 0 and not bwd.key_tiles and bwd.smem_bytes <= _MAX_SMEM


def _seeded(shape, rng, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_twins_match_jax_fused_attention_and_its_vjp_at_head_dim_512():
    """attn_core_reference and attn_core_backward_reference against the JAX
    package's fused attention in interpret mode and its VJP at C 512 with
    one head (B_ 2, M 49, N 147): forward within 2e-4, gradients within
    1e-4."""
    rng = np.random.default_rng(512)
    b_, m, n, c = 2, 49, 147, 512
    q, k, v, g = _seeded((b_, m, c), rng), _seeded((b_, n, c), rng), _seeded((b_, n, c), rng), \
        _seeded((b_, m, c), rng)
    bias = _seeded((1, m, n), rng, 0.5)
    out, vjp = jax.vjp(lambda *a: jax_attention(*a, num_heads=1, interpret=True),
                       *map(jnp.asarray, (q, k, v, bias)))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv, tb, tg = map(torch.from_numpy, (q, k, v, bias, g))
    np.testing.assert_allclose(attn_core_reference(tq, tk, tv, tb, 1).numpy(), np.asarray(out),
                               atol=2e-4, rtol=0)
    for got_g, want_g in zip(attn_core_backward_reference(tq, tk, tv, tb, tg, 1), want_grads):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-4, rtol=0)


def wide_backward(q, k, v, bias, g, num_heads, key_tile=32, cols=64):
    """The wide backward's launches in plain torch: (1) per key tile of
    ``key_tile`` keys, s = q k^T scale + bias and dp = g v^T summed over
    head_dim chunks of ``cols`` columns, and each row's tile max (times log2
    e), sum of exp2 and sum of dp times exp2; (2) the statistics merged over
    the tiles in order; (3) p32, ds, dv = round(p)^T g and dk = round(ds
    scale)^T q; (4) dq = round(ds scale) k; dbias the ds planes summed over
    the windows in window order. round() is the cast to the operand type."""
    b_, m, c = q.shape
    n = k.shape[1]
    dt = q.dtype
    hd = c // num_heads
    scale = hd**-0.5
    qh, kh, vh, gh = (_heads(t, num_heads) for t in (q, k, v, g))
    s = torch.zeros(b_, num_heads, m, n)
    dp = torch.zeros(b_, num_heads, m, n)
    for d0 in range(0, hd, cols):
        s += qh[..., d0:d0 + cols] @ kh[..., d0:d0 + cols].transpose(-2, -1)
        dp += gh[..., d0:d0 + cols] @ vh[..., d0:d0 + cols].transpose(-2, -1)
    s = s * scale + bias.float()[None]
    tiles = []
    for t0 in range(0, n, key_tile):
        st = s[..., t0:t0 + key_tile]
        mxl = st.amax(-1) * LOG2E
        e = torch.exp2(st * LOG2E - mxl[..., None])
        tiles.append((mxl, e.sum(-1), (dp[..., t0:t0 + key_tile] * e).sum(-1)))
    mx = torch.stack([t[0] for t in tiles]).amax(0)
    total, dot = torch.zeros_like(mx), torch.zeros_like(mx)
    for mxl, tsum, tdot in tiles:
        f = torch.exp2(mxl - mx)
        total, dot = total + tsum * f, dot + tdot * f
    inv = 1.0 / total
    p32 = torch.exp2(s * LOG2E - mx[..., None]) * inv[..., None]
    ds = p32 * (dp - (dot * inv)[..., None])
    p = p32.to(dt).float()
    dsc = (ds * scale).to(dt).float()
    dv, dk, dq = p.transpose(-2, -1) @ gh, dsc.transpose(-2, -1) @ qh, dsc @ kh
    dbias = torch.zeros(num_heads, m, n)
    for w in range(b_):
        dbias = dbias + ds[w]

    def merge(t):
        return t.transpose(1, 2).reshape(b_, -1, c).to(dt)

    return merge(dq), merge(dk), merge(dv), dbias


@pytest.mark.parametrize("hd,heads", [(64, 4), (256, 1), (512, 1)])
def test_wide_backward_decomposition_meets_the_gates_against_the_twin(hd, heads):
    """The emulated wide backward against attn_core_backward_reference at
    head_dim 64, 256 and 512 (B_ 3, M 49, N 147: five key tiles, the last
    ragged), f32 within 1e-4 x max(1, max|twin|) and bf16 within 2e-2 x
    max|twin| (the kernel-vs-twin gates), for dq, dk, dv and dbias."""
    rng = np.random.default_rng(hd)
    b_, m, n, c = 3, 49, 147, heads * hd
    q, k, v, g = (torch.from_numpy(_seeded(s, rng)) for s in ((b_, m, c), (b_, n, c), (b_, n, c), (b_, m, c)))
    bias = torch.from_numpy(_seeded((heads, m, n), rng, 0.5))
    for dt in (torch.float32, torch.bfloat16):
        ins = [t.to(dt) for t in (q, k, v)]
        got = wide_backward(*ins, bias, g.to(dt), heads)
        want = attn_core_backward_reference(*ins, bias, g.to(dt), heads)
        for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, want):
            r = r.float()
            top = r.abs().max().item()
            bound = 1e-4 * max(1.0, top) if dt == torch.float32 else 2e-2 * top
            assert (a.float() - r).abs().max().item() <= bound, (name, dt)
