"""The attention backward's kernel choice (``attn_core_bwd_plan``): a pure
function of (M, N, C, heads) that picks the row share J a lane of pass 1
keeps in registers, or the tiled backward (J 0) for rows above 32 x 32
keys or rows whose (M, N) dbias plane does not fit in a block's shared
memory beside the k/v rows, counted as long rows where a window's k/v and
q/g rows would fit in one block and as key tiles where they would not
(the same kernels, 32-key tiles at every shape). Checked on the CPU against the shared-memory layouts of
``attn_bwd_kernel`` and ``attn_bwd_keys_kernel`` (csrc/attn_core_bwd.cu)."""

import pytest

from bde2vid_tpu_torch.ops.window_attn_cuda import (
    BwdPlan,
    attn_core_bwd_plan,
    attn_core_bwd_smem_bytes,
    attn_core_bwd_window_bytes,
)

LIMIT = 232448  # bytes of shared memory one Hopper block may use


def _key_stride(hd):
    return hd + 1 if hd < 4 else hd if (hd // 4) % 2 else hd + 4


def _tiled_smem(m, hd):
    """The tiled backward's larger f32 block: attn_bwd_keys_kernel's (two
    stages of M float4 statistics, M q and g rows and 32 k and v rows of HD
    + 4 floats, rounded to 16 bytes, then (cdiv(M, 16), 32, 2 HD + 4)
    partial dk and dv and (M, 33) round(ds scale), rounded to 16 bytes) or
    attn_bwd_rows_kernel's (8 R q and g rows, two stages of 64 k and v rows
    and of the rows' bias, 68 floats a row, R = 8, 4 at HD 32)."""
    thd = max(4, hd)
    stage = -(-(16 * m + 4 * (2 * m + 64) * (thd + 4)) // 16) * 16
    keys = 2 * stage + 4 * -(-m // 16) * 32 * (2 * thd + 4) + 16 * -(-m * 33 // 4)
    rows_r = 8 * (8 if thd <= 16 else 4)
    rows = 4 * (thd + 4) * (2 * rows_r + 256) + 8 * rows_r * 68
    return max(keys, rows)


@pytest.mark.parametrize("m,n,c,want", [
    # the flagship's and the 8x8 config's levels keep the row shares they had
    (49, 343, 64, 12), (49, 343, 256, 12), (64, 448, 64, 16), (64, 448, 256, 16),
    # 21 buffer frames of 7x7 and 17 of 8x8 windows: long rows at both levels
    (49, 1029, 64, 0), (49, 1029, 256, 0), (64, 1088, 64, 0), (64, 1088, 256, 0),
    # 1024 keys: registers at head_dim 4; at head_dim 16 the plane does not fit
    (4, 1024, 16, 32), (64, 1024, 256, 0),
])
def test_plan_at_the_model_shapes(m, n, c, want):
    plan = attn_core_bwd_plan(m, n, c, 16 if c >= 64 else 4)
    assert plan.row_share == want
    assert plan.smem_bytes <= LIMIT


@pytest.mark.parametrize("hd", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("n", [1, 32, 384, 385, 512, 513, 1024, 1025, 1029, 1088, 2048])
def test_plan_picks_the_registers_where_they_fit_and_long_rows_elsewhere(n, hd):
    """J is the fewest of 12, 16, 32 with N <= 32 J whenever that kernel's
    shared memory fits; otherwise the tiled backward runs, whose shared
    memory holds neither an (M, N) plane nor a window's k/v rows, counted
    as key tiles where those rows would not fit in one block (it raised
    before that variant existed), else as long rows."""
    m, heads = 49, 4
    ks = _key_stride(hd)
    rows = 4 * (2 * (n + m) * ks + 3 * m)
    short_j = next((j for j in (12, 16, 32) if n <= 32 * j), 0)
    if short_j and rows + 4 * m * n <= LIMIT:
        want = BwdPlan(short_j, rows + 4 * m * n)
    else:
        want = BwdPlan(0, _tiled_smem(m, hd), rows > LIMIT)
        assert want.smem_bytes <= LIMIT
    assert attn_core_bwd_plan(m, n, hd * heads, heads) == want
    assert attn_core_bwd_smem_bytes(m, n, hd, want.row_share) == want.smem_bytes


@pytest.mark.parametrize("m,hd", [(49, 16), (64, 16), (64, 4), (4, 32)])
def test_long_rows_run_up_to_the_shared_memory_limit(m, hd):
    """The longest long row is the last whose k, v, q and g rows would fit
    in a block; one key more counts as key tiles (it raised before that
    variant existed). Both take the tiled backward, whose block
    does not grow with N."""
    ks = _key_stride(hd)
    most = (LIMIT // 4 - 3 * m) // (2 * ks) - m
    assert attn_core_bwd_window_bytes(m, most, hd) <= LIMIT < attn_core_bwd_window_bytes(m, most + 1, hd)
    assert attn_core_bwd_plan(m, most, hd, 1) == (0, attn_core_bwd_smem_bytes(m, most, hd, 0), False)
    tiled = attn_core_bwd_plan(m, most + 1, hd, 1)
    assert tiled == (0, attn_core_bwd_smem_bytes(m, most, hd, 0), True) and tiled.smem_bytes <= LIMIT


def test_plan_is_a_function_of_its_arguments():
    """Two calls agree, and a longer row never takes fewer keys a lane."""
    shares = [attn_core_bwd_plan(49, n, 64, 16) for n in range(1, 1100, 7)]
    assert shares == [attn_core_bwd_plan(49, n, 64, 16) for n in range(1, 1100, 7)]
    js = [p.row_share or 10**6 for p in shares]
    assert js == sorted(js)
