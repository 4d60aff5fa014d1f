"""The key counts at which the attention kernels stop staging a window's k
and v rows whole, pinned exactly on the CPU, and the key-tiled variants
that take every longer row (ROADMAP Queue C5, repaired).

Both untiled kernels stage a window's k and v rows in one block's shared
memory, so a row of N keys fits them only up to a limit: the forward
(``attn_forward_plan``) at head_dim 4 up to 7264 keys, at head_dim 16 up to
1452 in f32 and 2896 in bf16 (the tensor-core kernel's half-width rows); the
backward's long rows (``attn_core_bwd_plan``, which counts in f32 whatever
the operand type) at M 49 query rows up to 7196 at head_dim 4 and 1400 at
head_dim 16, and at M 64 up to 7176 and 1384. Each plan gives every longer
row the key-tiled kernel (the JAX package caps only at its 96 MB VMEM
limit): N + 1 and far rows of 61 and 151 frames of 7x7 windows (2989 and
7399 keys) plan, and neither plan raises. The backward's long rows and key
tiles both run the tiled backward (``attn_bwd_keys_kernel``), which stages
no window whole; the limit only separates their launch counters.
"""

import pytest
import torch

from bde2vid_tpu_torch.ops.window_attn_cuda import (
    FLASH_THREADS,
    _MAX_SMEM,
    attn_core_bwd_plan,
    attn_core_bwd_smem_bytes,
    attn_core_bwd_window_bytes,
    attn_forward_plan,
    attn_smem_bytes,
)

HEADS = 16
FAR = {16: 49 * 61, 4: 49 * 151}  # 61 and 151 buffer frames of 7x7 windows


def _last_untiled(tiled):
    """The largest N for which ``tiled(N)`` is false, by bisection (the
    untiled kernels' shared memory grows with N)."""
    lo, hi = 1, 1 << 14
    assert not tiled(lo) and tiled(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if tiled(mid):
            hi = mid
        else:
            lo = mid
    return lo


@pytest.mark.parametrize("head_dim,dtype,limit", [
    (4, torch.float32, 7264), (4, torch.bfloat16, 7264),
    (16, torch.float32, 1452), (16, torch.bfloat16, 2896),
])
def test_forward_plan_refuses_above_its_key_limit(head_dim, dtype, limit):
    """The untiled forward takes rows up to its limit and no further; the
    key-tiled kernel takes N + 1 and the far row, in a block that fits."""
    bf16 = dtype == torch.bfloat16

    def plan(n):
        return attn_forward_plan(20, HEADS, 49, n, head_dim, sms=132, blocks_per_sm=1, bf16=bf16)

    assert _last_untiled(lambda n: plan(n).key_tiled) == limit
    assert attn_smem_bytes(limit, head_dim, bf16) <= _MAX_SMEM < attn_smem_bytes(limit + 1, head_dim, bf16)
    for n in (limit + 1, FAR[head_dim], FAR[head_dim] + 1000):
        # the key-tiled kernel's shared memory is a constant of its build
        tiled = plan(n)
        assert tiled.key_tiled and tiled.threads == FLASH_THREADS


@pytest.mark.parametrize("head_dim,m,limit", [(4, 49, 7196), (16, 49, 1400), (4, 64, 7176),
                                              (16, 64, 1384)])
def test_backward_plan_refuses_above_its_key_limit(head_dim, m, limit):
    """Long rows are the last rows whose k, v, q and g would fit in a
    block; N + 1 and the far row count as key tiles. Both take the tiled
    backward, whose block is the same at every N."""
    def plan(n):
        return attn_core_bwd_plan(m, n, head_dim * HEADS, HEADS)

    assert _last_untiled(lambda n: plan(n).key_tiles) == limit
    assert plan(limit).row_share == 0  # the tiled backward takes the last long rows
    assert attn_core_bwd_window_bytes(m, limit + 1, head_dim) > _MAX_SMEM
    for n in (limit + 1, FAR[head_dim]):
        tiled = plan(n)
        assert tiled.row_share == 0 and tiled.key_tiles
        assert tiled.smem_bytes == attn_core_bwd_smem_bytes(m, n, head_dim, 0) == plan(limit).smem_bytes
        assert tiled.smem_bytes <= _MAX_SMEM
        assert tiled == plan(FAR[head_dim] + 1000)


def test_flagship_buffers_beyond_the_limits():
    """Buffers of -15..15 (31 frames of 7x7 windows, 1519 keys) and -30..30
    (61 frames, 2989 keys) plan in both directions at both levels, f32 and
    bf16: at head_dim 16 (level 2) the forward and the backward take key
    tiles, at head_dim 4 (level 0) the forward stages whole windows and the
    backward runs long rows."""
    for frames in (31, 61):
        n = 49 * frames
        for head_dim in (4, 16):
            for bf16 in (False, True):
                fwd = attn_forward_plan(20, HEADS, 49, n, head_dim, 132, 1, bf16)
                assert fwd.key_tiled == (head_dim == 16 and (frames == 61 or not bf16))
            bwd = attn_core_bwd_plan(49, n, head_dim * HEADS, HEADS)
            assert bwd.row_share == 0 and bwd.key_tiles == (head_dim == 16)
