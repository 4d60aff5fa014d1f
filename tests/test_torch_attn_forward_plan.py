"""The forward attention core's launch plan (``attn_forward_plan``): a pure
function of the shapes and the card's slots that splits each window's
query rows into tiles. Checked on the CPU against a mirror of how
``attn_kernel`` and ``attn_kernel_mma`` (csrc/window_common.cuh) hand the
rows to blocks and warps."""

import collections

import pytest

from bde2vid_tpu_torch.ops.window_attn_cuda import FLASH_THREADS, attn_forward_plan, attn_rows, attn_smem_bytes

SMS = 132  # an H100's SMs


def _warp_rows(plan, m, hd, bf16):
    """The query rows each warp of each block of one (window, head) takes,
    as the kernels deal them: in block `tile`, warp `wp` takes the row items
    (R rows each: R = attn_rows, 1, or 16 on the tensor cores) tile * warps
    + wp, then every warps * tiles-th item on."""
    warps = plan.threads // 32
    r_ = attn_rows(hd, bf16)
    items = -(-m // r_)
    runs = []
    for t in range(plan.tiles):
        for wp in range(warps):
            runs.append([it * r_ + r for it in range(t * warps + wp, items, warps * plan.tiles)
                         for r in range(r_) if it * r_ + r < m])
    return runs


# (B_, heads, M, N, head_dim, resident blocks per SM, bf16): the
# flagship's and the 8x8 config's levels (f32, and bf16, whose head_dim 16
# takes 16-row tiles on the tensor cores), B_ 1, M 1 / 4 / 4096, N past one
# lane's register share, and other residencies
SHAPES = [
    (252, 16, 49, 343, 4, 4, False), (20, 16, 49, 343, 16, 2, False),
    (180, 16, 64, 448, 4, 4, False), (12, 16, 64, 448, 16, 2, False),
    (252, 16, 49, 343, 4, 4, True), (20, 16, 49, 343, 16, 4, True),
    (180, 16, 64, 448, 4, 4, True), (12, 16, 64, 448, 16, 4, True),
    (1, 16, 49, 343, 4, 2, False), (1, 1, 4, 1025, 4, 2, False), (1, 1, 1, 2048, 4, 2, False),
    (3, 4, 4, 1025, 8, 2, False), (5, 2, 64, 2048, 1, 2, False), (23, 16, 49, 343, 16, 1, False),
    (37, 16, 64, 448, 4, 1, False), (300, 16, 49, 343, 4, 3, False), (7, 300, 4, 343, 2, 2, False),
    (3, 4, 7, 1025, 32, 1, True), (1, 16, 1, 343, 16, 2, True), (1, 1, 4096, 49, 4, 4, False),
]


@pytest.mark.parametrize("b_,heads,m,n,hd,blocks_per_sm,bf16", SHAPES)
def test_plan_covers_every_window_head_and_row_once(b_, heads, m, n, hd, blocks_per_sm, bf16):
    """Blocks (window, head, tile) take every row of their (window, head)
    once between them; the grid holds every (window, head) once."""
    plan = attn_forward_plan(b_, heads, m, n, hd, SMS, blocks_per_sm, bf16)
    seen = collections.Counter(r for run in _warp_rows(plan, m, hd, bf16) for r in run)
    assert seen == collections.Counter(range(m))
    assert 1 <= plan.tiles <= 65535
    assert attn_smem_bytes(n, hd, bf16) <= 232448


@pytest.mark.parametrize("b_,heads,m,n,hd,blocks_per_sm,bf16", SHAPES)
def test_plan_fills_the_card_where_the_windows_allow(b_, heads, m, n, hd, blocks_per_sm, bf16):
    plan = attn_forward_plan(b_, heads, m, n, hd, SMS, blocks_per_sm, bf16)
    slots = SMS * blocks_per_sm
    blocks = b_ * heads * plan.tiles
    items = -(-m // attn_rows(hd, bf16))
    warps = plan.threads // 32
    most = max(1, items // warps)  # tiles that leave every warp an item
    assert plan.tiles <= most
    # two full waves wherever the rows allow as many tiles, and no more
    # tiles than two waves need
    assert blocks >= 2 * slots or plan.tiles == most
    assert plan.tiles == 1 or b_ * heads * (plan.tiles - 1) < 2 * slots


def test_plan_at_the_model_shapes():
    """On an H100 (132 SMs; four resident blocks at head_dim 4, two at 16 in
    f32, four on the tensor cores): level 0 has windows enough for one tile
    a window; level 2 in f32 splits each window's rows in two (flagship,
    640 blocks) or three (8x8, 576); the tensor-core kernel's four 16-row
    tiles a window stay in one block."""
    assert attn_forward_plan(252, 16, 49, 343, 4, SMS, 4).tiles == 1
    assert attn_forward_plan(180, 16, 64, 448, 4, SMS, 4).tiles == 1
    assert attn_forward_plan(20, 16, 49, 343, 16, SMS, 2).tiles == 2
    assert attn_forward_plan(12, 16, 64, 448, 16, SMS, 2).tiles == 3
    assert attn_forward_plan(20, 16, 49, 343, 16, SMS, 4, True).tiles == 1
    assert attn_forward_plan(12, 16, 64, 448, 16, SMS, 4, True).tiles == 1


@pytest.mark.parametrize("b_,heads,m,n,hd,blocks_per_sm,bf16", SHAPES)
def test_plan_is_a_function_of_its_arguments_alone(b_, heads, m, n, hd, blocks_per_sm, bf16):
    first = attn_forward_plan(b_, heads, m, n, hd, SMS, blocks_per_sm, bf16)
    for other in SHAPES:  # no state carried between calls
        attn_forward_plan(*other[:5], SMS, *other[5:])
    assert attn_forward_plan(b_, heads, m, n, hd, SMS, blocks_per_sm, bf16) == first


def test_plan_refuses_keys_that_do_not_fit_one_block():
    """Keys that do not fit one block take the key-tiled kernel (they
    raised before it existed). The one-sweep key-tiled kernel keeps its
    rows' statistics in registers and its tile is a constant of its build,
    so its shared memory does not grow with M and 1000 query rows plan too.
    Above head_dim 256 the wide forward, whose blocks tile the keys, rows
    and head_dim, takes every shape, so no head_dim is refused (ROADMAP C7
    and C8, repaired)."""
    plan = attn_forward_plan(1, 1, 4, 2000, 32, SMS, 1)
    assert plan.key_tiled and attn_smem_bytes(2000, 32) > 232448
    assert plan.threads == FLASH_THREADS
    assert attn_forward_plan(1, 1, 1000, 2000, 32, SMS, 1).key_tiled
    assert attn_forward_plan(1, 1, 4, 2000, 512, SMS, 1).wide
    assert attn_forward_plan(1, 1, 4, 2000, 2048, SMS, 1).wide
