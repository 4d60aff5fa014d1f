"""The key counts at which the attention kernels' plans start to refuse
(ROADMAP Queue C5), pinned exactly on the CPU.

Both plans stage a window's k and v rows in one block's shared memory, so a
row of N keys fits only up to a limit: the forward (``attn_forward_plan``)
at head_dim 4 takes 7264 keys, at head_dim 16 1452 in f32 and 2896 in bf16
(the tensor-core kernel's half-width rows); the backward
(``attn_core_bwd_plan``, which computes in f32 whatever the operand type) at
M 49 query rows takes 7196 at head_dim 4 and 1400 at head_dim 16, and at M
64 7176 and 1384. The JAX package caps only at its 96 MB VMEM limit, so
buffers beyond these run there and are refused here. A key-tiled variant of
both kernels lifts the limit, and must update this test when it lands.
"""

import pytest
import torch

from bde2vid_tpu_torch.ops.window_attn_cuda import (
    _MAX_SMEM,
    attn_core_bwd_plan,
    attn_forward_plan,
    attn_smem_bytes,
)

HEADS = 16


def _largest_accepted(plan):
    """The largest N the plan takes, by bisection (a plan's shared memory
    grows with N)."""
    lo, hi = 1, 1 << 14
    plan(lo)
    with pytest.raises(ValueError):
        plan(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            plan(mid)
            lo = mid
        except ValueError:
            hi = mid
    return lo


@pytest.mark.parametrize("head_dim,dtype,limit", [
    (4, torch.float32, 7264), (4, torch.bfloat16, 7264),
    (16, torch.float32, 1452), (16, torch.bfloat16, 2896),
])
def test_forward_plan_refuses_above_its_key_limit(head_dim, dtype, limit):
    bf16 = dtype == torch.bfloat16

    def plan(n):
        return attn_forward_plan(20, HEADS, 49, n, head_dim, sms=132, blocks_per_sm=1, bf16=bf16)

    assert _largest_accepted(plan) == limit
    assert attn_smem_bytes(limit, head_dim, bf16) <= _MAX_SMEM < attn_smem_bytes(limit + 1, head_dim, bf16)
    with pytest.raises(ValueError, match=f"{limit + 1} keys at head_dim {head_dim}"):
        plan(limit + 1)


@pytest.mark.parametrize("head_dim,m,limit", [(4, 49, 7196), (16, 49, 1400), (4, 64, 7176),
                                              (16, 64, 1384)])
def test_backward_plan_refuses_above_its_key_limit(head_dim, m, limit):
    def plan(n):
        return attn_core_bwd_plan(m, n, head_dim * HEADS, HEADS)

    assert _largest_accepted(plan) == limit
    assert plan(limit).row_share == 0  # the long-row variant takes the last rows
    with pytest.raises(ValueError, match=f"cannot take {limit + 1} keys at head_dim {head_dim}"):
        plan(limit + 1)


def test_flagship_buffers_beyond_the_limits():
    """In buffer frames of 7x7 windows (49 keys each): at level 2 the forward
    refuses from 30 frames in f32 (60 in bf16) and the backward from 29, so
    a ``buffer_index`` of -15..15 cannot evaluate and -14..14 cannot train."""
    fwd = lambda frames, bf16=False: attn_forward_plan(20, HEADS, 49, 49 * frames, 16, 132, 1, bf16)
    bwd = lambda frames: attn_core_bwd_plan(49, 49 * frames, 256, HEADS)
    fwd(29)
    fwd(59, bf16=True)
    bwd(28)
    for refused in (lambda: fwd(30), lambda: fwd(60, bf16=True), lambda: bwd(29),
                    lambda: fwd(31), lambda: bwd(31)):
        with pytest.raises(ValueError):
            refused()
