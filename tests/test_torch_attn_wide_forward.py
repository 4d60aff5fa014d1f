"""The wide forward attention above head_dim 256 (``attn_wide_scores_kernel``
and ``attn_wide_out_kernel`` in bde2vid_tpu_torch/ops/csrc/window_common.cuh).

On the CPU: the plan routes every head_dim above 256 to it, with its own
launch counter; the scratch size the wrappers allocate mirrors the planes'
layout (``WideFwdPlanes``); and a torch emulation of its two launches' arithmetic
(q k^T summed over 64-column chunks of head_dim, per 32-key tile row
statistics merged in tile order, p = exp(s - max) / sum rounded to the
operand type after the division, p v summed over 64-key tiles) is held to
the twin ``attn_core_reference`` under the kernel-vs-twin gates and to the
JAX package's ``_ref_window_attention`` at f32 2e-4, at head_dim 300, 384
and 2049 with one head (B_ 3, M 49, N 147: ragged last key tiles). The
kernels themselves run in tests/test_torch_cuda.py and chip_smoke.py's
``head_dims`` phase.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bde2vid_tpu.ops.window_attn_pallas import _ref_window_attention
from bde2vid_tpu_torch.ops.window_attn_cuda import (
    WIDE_FORWARD_HEAD_DIM,
    WIDE_THREADS,
    attn_core_reference,
    attn_forward_plan,
    attn_forward_scratch_floats,
    attn_key_tiled,
    attn_wide,
    fwd_counter,
)
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

LOG2E = 1.4426950408889634
SCORE_KEYS = 32  # keys of a scores tile (kWideFwdKeys)
SCORE_ROWS = 64  # rows of a scores tile (kWideFwdRows)
OUT_ROWS = 32  # rows of an output block (kWideOutRows)
OUT_KEYS = 64  # keys an output block takes at a time (kWideOutKeys)
COLS = 64  # head_dim columns of a chunk (kWideCols)
EMULATED = (300, 384, 2049)
LIBS = ("fused_window_attention", "fused_swin_block", "fused_window_block")


@pytest.mark.parametrize("hd", [257, 300, 384, 512, 1024, 2048, 2049])
def test_plan_routes_every_head_dim_above_the_hand_over_to_the_wide_forward(hd):
    """Above the hand-over every plan is the wide forward (its own blocks,
    not key-tiled), whatever the rows, keys and operand type, and each
    library counts it on its ``_wide`` counter; at the hand-over itself the
    key-tiled kernel stays."""
    assert attn_wide(hd) and not attn_wide(WIDE_FORWARD_HEAD_DIM)
    for m, n in ((49, 343), (64, 448), (144, 147), (49, 1519)):
        for bf16 in (False, True):
            plan = attn_forward_plan(20, 1, m, n, hd, sms=132, blocks_per_sm=1, bf16=bf16)
            assert plan.wide and not plan.key_tiled and plan.threads == WIDE_THREADS
            assert not attn_key_tiled(m, n, hd, bf16)
            assert [fwd_counter(lib, plan) for lib in LIBS] == [lib + "_wide" for lib in LIBS]
    edge = attn_forward_plan(20, 1, 49, 343, WIDE_FORWARD_HEAD_DIM, sms=132, blocks_per_sm=1)
    assert edge.key_tiled and not edge.wide
    assert fwd_counter("fused_swin_block", edge) == "fused_swin_block_key_tiles"


def _planes(b_, heads, m, n):
    """The wide forward's scratch laid out as WideFwdPlanes lays it out: the
    s plane (B_ H, M, np) with np = 32-key tiles x 32, then the tiles' row
    max and sum of exp, (B_ H, tiles, M) each, as views of one flat tensor
    of attn_forward_scratch_floats floats."""
    tiles = -(-n // SCORE_KEYS)
    np_ = tiles * SCORE_KEYS
    rows = b_ * heads * m
    flat = torch.zeros(attn_forward_scratch_floats(b_, heads, m, n, WIDE_FORWARD_HEAD_DIM + 1))
    s = flat[:rows * np_].view(b_ * heads, m, np_)
    tmx = flat[rows * np_:rows * (np_ + tiles)].view(b_ * heads, tiles, m)
    tsum = flat[rows * (np_ + tiles):].view(b_ * heads, tiles, m)
    return flat, s, tmx, tsum


@pytest.mark.parametrize("b_,heads,m,n", [(20, 1, 49, 343), (3, 1, 49, 147), (5, 2, 144, 1519),
                                          (1, 1, 1, 1), (7, 3, 64, 448)])
def test_scratch_size_mirrors_the_planes_layout(b_, heads, m, n):
    """The wrappers' scratch is exactly the s plane and the two statistics
    planes (no gap, nothing past them); every plane's rows start on 16
    bytes; below the hand-over there is none."""
    flat, s, tmx, tsum = _planes(b_, heads, m, n)
    tiles = -(-n // SCORE_KEYS)
    assert s.numel() + tmx.numel() + tsum.numel() == flat.numel()
    assert tsum.numel() == tmx.numel() == b_ * heads * tiles * m
    assert (s.shape[-1] * 4) % 16 == 0
    for hd in (257, 384, 2049):
        assert attn_forward_scratch_floats(b_, heads, m, n, hd) == flat.numel()
    for hd in (4, 64, 256):
        assert attn_forward_scratch_floats(b_, heads, m, n, hd) == 0


def wide_forward_emulation(q, k, v, bias, dt):
    """The two launches' arithmetic in plain torch, one head: q, k, v
    (B_, M|N, hd) in ``dt``, bias (1, M, N) f32 -> out (B_, M, hd) in ``dt``.
    Launch 1 per (32-key tile, 64-row tile): s = q k^T summed over 64-column
    chunks (the f32 products of dt operands), scale and bias, the plane
    (-inf past N), the tile's row max (times log2 e) and sum of exp. Launch
    2 per (32-row tile, 64-column chunk): the statistics merged in tile
    order, p = exp(s - max) / sum rounded to dt, out = sum over 64-key
    tiles of p v."""
    b_, m, hd = q.shape
    n = k.shape[1]
    scale = hd ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    tiles = -(-n // SCORE_KEYS)
    np_ = tiles * SCORE_KEYS
    _, splane, tmx, tsum = _planes(b_, 1, m, n)
    for kt in range(tiles):
        n0, n1 = kt * SCORE_KEYS, min(n, (kt + 1) * SCORE_KEYS)
        for r0 in range(0, m, SCORE_ROWS):
            r1 = min(m, r0 + SCORE_ROWS)
            s = torch.zeros(b_, r1 - r0, n1 - n0)
            for d0 in range(0, hd, COLS):
                s += qf[:, r0:r1, d0:d0 + COLS] @ kf[:, n0:n1, d0:d0 + COLS].transpose(1, 2)
            s = s * scale + bias[0, r0:r1, n0:n1]
            splane[:, r0:r1, n0:n1] = s
            splane[:, r0:r1, n1:(kt + 1) * SCORE_KEYS] = float("-inf")
            mxl = s.amax(-1) * LOG2E
            tmx[:, kt, r0:r1] = mxl
            tsum[:, kt, r0:r1] = torch.exp2(s * LOG2E - mxl[..., None]).sum(-1)
    assert splane.shape[-1] == np_
    out = torch.zeros(b_, m, hd)
    for r0 in range(0, m, OUT_ROWS):
        r1 = min(m, r0 + OUT_ROWS)
        mx = tmx[:, 0, r0:r1]
        for t in range(1, tiles):
            mx = torch.maximum(mx, tmx[:, t, r0:r1])
        total = torch.zeros_like(mx)
        for t in range(tiles):
            total = total + tsum[:, t, r0:r1] * torch.exp2(tmx[:, t, r0:r1] - mx)
        for d0 in range(0, hd, COLS):
            acc = torch.zeros(b_, r1 - r0, min(COLS, hd - d0))
            for n0 in range(0, n, OUT_KEYS):
                n1 = min(n, n0 + OUT_KEYS)
                p = torch.exp2(splane[:, r0:r1, n0:n1] * LOG2E - mx[..., None]) / total[..., None]
                acc += p.to(dt).float() @ vf[:, n0:n1, d0:d0 + COLS]
            out[:, r0:r1, d0:d0 + COLS] = acc
    return out.to(dt)


def _inputs(hd, seed, b_=3, m=49, n=147):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b_, rows, hd)).astype(np.float32) for rows in (m, n, n))
    bias = (rng.normal(size=(1, m, n)) * 0.5).astype(np.float32)
    return q, k, v, bias


def _gate(ref, dt):
    top = ref.float().abs().max().item()
    return 1e-4 * max(1.0, top) if dt == torch.float32 else 2e-2 * top


@pytest.mark.parametrize("hd", EMULATED)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_emulated_launches_hold_the_twin_at_the_kernel_gates(hd, dt):
    """The emulation of the two launches against attn_core_reference at the
    kernel-vs-twin gates (f32 1e-4 x max(1, max|twin|), bf16 2e-2 x
    max|twin|), head_dim 300, 384 and 2049 (a last chunk of 44, 0 and 1
    columns), one head, B_ 3, M 49, N 147 (ragged last key tiles)."""
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(hd, hd))
    q, k, v = (t.to(dt) for t in (q, k, v))
    got = wide_forward_emulation(q, k, v, bias, dt)
    ref = attn_core_reference(q, k, v, bias, 1)
    assert got.dtype == ref.dtype == dt and got.shape == ref.shape
    assert (got.float() - ref.float()).abs().max().item() <= _gate(ref, dt)


@pytest.mark.parametrize("hd", EMULATED)
def test_emulated_launches_match_jax_reference(hd):
    """The emulation against the JAX package's _ref_window_attention in f32
    within 2e-4 (same inputs from a numpy seed)."""
    q, k, v, bias = _inputs(hd, hd + 1)
    want = np.asarray(_ref_window_attention(*map(jnp.asarray, (q, k, v, bias)), num_heads=1))
    got = wide_forward_emulation(*(torch.from_numpy(a) for a in (q, k, v, bias)), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
