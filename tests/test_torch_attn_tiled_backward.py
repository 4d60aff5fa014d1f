"""The tiled attention backward (head_dim <= 32, the rows the register
kernel cannot take: ``attn_bwd_rows_kernel`` and ``attn_bwd_keys_kernel`` in
csrc/attn_core_bwd.cu) and head dims above 1024 (ROADMAP C8, repaired).

On the CPU: the launches emulated in plain torch in the kernels' order (a
lane's online statistics over its keys lane, lane + 32, ..., merged over the
lanes in a fixed butterfly; dk and dv of a key tile over the row warps in
warp order; dq over 32-key tiles in tile order; dbias over the windows in
window order) against the twin under the kernel-vs-twin
gates; the plans at every long-row and key-tile shape the card runs; and
the twins against the JAX package's fused attention in interpret mode and
its VJP at head_dim 2048 with one head. The kernels themselves run in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.ops.window_attn_pallas import fused_window_attention as jax_attention
from bde2vid_tpu_torch.ops.window_attn_cuda import (
    _MAX_SMEM,
    _heads,
    attn_core_backward_reference,
    attn_core_bwd_plan,
    attn_core_bwd_window_bytes,
    attn_core_reference,
    bwd_counter,
    tiled_keys_rows,
)

LOG2E = 1.4426950408889634


def _seeded(shape, rng, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.fixture
def one_thread():
    """Many small torch ops: one intra-op thread (beside other test workers
    each op's parallel region otherwise waits on descheduled threads)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiled_backward(q, k, v, bias, g, num_heads):
    """The tiled backward's launches in plain torch. Rows: a lane per key
    (keys lane + 32 t), each lane's running max (times log2 e), sum of exp2
    and sum of dp times exp2 in key order, rescaled when a score raises the
    max; the lanes merged in the kernel's butterfly. Keys: per window in
    order, p32 and ds from those statistics, dv = round(p)^T g and dk =
    round(ds scale)^T q summed per row warp (rows r0 + warp + warps t of a
    row group from r0) and then over the warps in order and the row groups
    in order, dq a 32-key tile's share at a time, the tiles added in order,
    dbias summed over the windows in order."""
    b_, m, c = q.shape
    n = k.shape[1]
    dt = q.dtype
    hd = c // num_heads
    scale = hd**-0.5
    qh, kh, vh, gh = (_heads(t, num_heads) for t in (q, k, v, g))
    s = (qh @ kh.transpose(-2, -1)) * scale + bias.float()[None]  # (B_, H, M, N)
    dp = gh @ vh.transpose(-2, -1)
    steps = -(-n // 32)
    pad = steps * 32 - n
    sp = torch.nn.functional.pad(s, (0, pad), value=float("-inf")).reshape(b_, num_heads, m, steps, 32)
    dpp = torch.nn.functional.pad(dp, (0, pad)).reshape(b_, num_heads, m, steps, 32)
    ml = torch.full((b_, num_heads, m, 32), -1e30)
    total = torch.zeros_like(ml)
    dot = torch.zeros_like(ml)
    for t in range(steps):
        st, dpt = sp[..., t, :], dpp[..., t, :]
        live = torch.isfinite(st)
        tl = st * LOG2E
        up = live & (tl > ml)
        f = torch.where(up, torch.exp2(ml - tl), torch.ones_like(ml))
        total, dot = total * f, dot * f
        ml = torch.where(up, tl, ml)
        e = torch.where(live, torch.exp2(st * LOG2E - ml), torch.zeros_like(ml))
        total = total + e
        dot = dot + torch.where(live, dpt, torch.zeros_like(dpt)) * e

    def merge_stats(a, b):
        mn = torch.maximum(a[0], b[0])
        f1, f2 = torch.exp2(a[0] - mn), torch.exp2(b[0] - mn)
        return mn, a[1] * f1 + b[1] * f2, a[2] * f1 + b[2] * f2

    stats = (ml, total, dot)
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        stats = merge_stats(stats, tuple(x[..., lanes ^ o] for x in stats))
    mxl, inv = stats[0][..., 0], 1.0 / stats[1][..., 0]
    rdot = stats[2][..., 0] * inv
    p32 = torch.exp2(s * LOG2E - mxl[..., None]) * inv[..., None]
    ds = p32 * (dp - rdot[..., None])
    p = p32.to(dt).float()
    dsc = (ds * scale).to(dt).float()
    # dq: each 32-key tile's share, then the tiles added in order
    dq = torch.zeros(b_, num_heads, m, hd)
    for t0 in range(0, n, 32):
        dq = dq + dsc[..., t0:t0 + 32] @ kh[:, :, t0:t0 + 32]
    # dk, dv: the row warps' partial sums in warp order, then the row groups in order
    warps, mg = tiled_keys_rows(m)
    dk = torch.zeros(b_, num_heads, n, hd)
    dv = torch.zeros(b_, num_heads, n, hd)
    for r0 in range(0, m, mg):
        gk, gv = torch.zeros_like(dk), torch.zeros_like(dv)
        for wp in range(warps):
            rows = torch.arange(r0 + wp, min(m, r0 + mg), warps)
            gk = gk + dsc[:, :, rows].transpose(-2, -1) @ qh[:, :, rows]
            gv = gv + p[:, :, rows].transpose(-2, -1) @ gh[:, :, rows]
        dk, dv = dk + gk, dv + gv
    dbias = torch.zeros(num_heads, m, n)
    for w in range(b_):
        dbias = dbias + ds[w]

    def merged(t):
        return t.transpose(1, 2).reshape(b_, -1, c).to(dt)

    return merged(dq), merged(dk), merged(dv), dbias


@pytest.mark.parametrize("hd,heads", [(4, 4), (16, 2)])
@pytest.mark.parametrize("m", [49, 64, 144])
def test_tiled_backward_decomposition_meets_the_gates_against_the_twin(one_thread, hd, heads, m):
    """The emulated tiled backward against attn_core_backward_reference at
    head_dim 4 and 16 (B_ 3, M 49, 64 and 144, the last in two row groups
    of 80 and 64 rows; N 147: five 32-key steps, the last ragged), f32 within 1e-4 x max(1, max|twin|) and bf16 within 2e-2 x
    max|twin| (the kernel-vs-twin gates), for dq, dk, dv and dbias."""
    rng = np.random.default_rng(hd * 100 + m)
    b_, n, c = 3, 147, heads * hd
    q, k, v, g = (torch.from_numpy(_seeded(s, rng)) for s in ((b_, m, c), (b_, n, c), (b_, n, c), (b_, m, c)))
    bias = torch.from_numpy(_seeded((heads, m, n), rng, 0.5))
    for dt in (torch.float32, torch.bfloat16):
        ins = [t.to(dt) for t in (q, k, v)]
        got = tiled_backward(*ins, bias, g.to(dt), heads)
        want = attn_core_backward_reference(*ins, bias, g.to(dt), heads)
        for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, want):
            r = r.float()
            top = r.abs().max().item()
            bound = 1e-4 * max(1.0, top) if dt == torch.float32 else 2e-2 * top
            assert (a.float() - r).abs().max().item() <= bound, (name, dt)


# (M, N, C, heads, counter): the long-row and key-tile shapes chip_smoke.py
# drives (LONG_FRAMES: the flagship's levels at 21 buffer frames and the 8x8
# config's at 17; TILED_BWD_ROWS and the key_tiles phase's level 2 at 31)
CARD_ROWS = (
    (49, 1029, 64, 16, "attn_core_backward_long_rows"),
    (49, 1029, 256, 16, "attn_core_backward_long_rows"),
    (64, 1088, 64, 16, "attn_core_backward_long_rows"),
    (64, 1088, 256, 16, "attn_core_backward_long_rows"),
    (49, 1519, 256, 16, "attn_core_backward_key_tiles"),
    (49, 7197, 64, 16, "attn_core_backward_key_tiles"),
    (49, 1401, 256, 16, "attn_core_backward_key_tiles"),
    (64, 7177, 64, 16, "attn_core_backward_key_tiles"),
    (64, 1385, 256, 16, "attn_core_backward_key_tiles"),
    (49, 2989, 256, 16, "attn_core_backward_key_tiles"),
    (49, 7399, 64, 16, "attn_core_backward_key_tiles"),
)


@pytest.mark.parametrize("m,n,c,heads,counter", CARD_ROWS)
def test_long_rows_and_key_tiles_take_the_tiled_backward(m, n, c, heads, counter):
    """Every long-row and key-tile shape takes the tiled backward (row share
    0, a 32-key tile where the window's rows would not fit in one block),
    counted as before, within one block's shared memory."""
    plan = attn_core_bwd_plan(m, n, c, heads)
    fits = attn_core_bwd_window_bytes(m, n, c // heads) <= _MAX_SMEM
    assert plan.row_share == 0 and plan.smem_bytes <= _MAX_SMEM
    assert plan.key_tiles == (not fits)
    assert bwd_counter(plan, c // heads) == counter


@pytest.mark.parametrize("m,n,c,heads", [(144, 432, 64, 16), (144, 432, 256, 16), (144, 1029, 64, 16),
                                         (144, 1029, 256, 16), (129, 4000, 64, 16), (144, 432, 96, 3),
                                         (343, 2744, 64, 16)])
def test_tiled_backward_plans_any_query_rows(m, n, c, heads):
    """Past 128 query rows (window_size (12, 12): M 144) the tiled
    backward's keys kernel takes the rows in groups of at most eight warps
    of 16 rows, split evenly, and its block fits at every head_dim <= 32."""
    plan = attn_core_bwd_plan(m, n, c, heads)
    warps, mg = tiled_keys_rows(m)
    groups = -(-m // mg)
    assert plan.row_share == 0 and plan.smem_bytes <= _MAX_SMEM
    assert warps <= 8 and mg == 16 * warps and groups == -(-m // 128)
    assert (groups - 1) * mg < m <= groups * mg
    assert tiled_keys_rows(128) == (8, 128) and tiled_keys_rows(49) == (4, 49)


def test_twins_match_jax_fused_attention_and_its_vjp_at_head_dim_2048():
    """attn_core_reference and attn_core_backward_reference against the JAX
    package's fused attention in interpret mode and its VJP at C 2048 with
    one head (B_ 2, M 49, N 98): forward within 2e-4, gradients within
    1e-4."""
    rng = np.random.default_rng(2048)
    b_, m, n, c = 2, 49, 98, 2048
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
