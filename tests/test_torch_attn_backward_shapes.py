"""The attention-core backward at the 8x8 config's shapes (M 64, N 448) on
the CPU: the port's twin ``attn_core_backward_reference`` vs the JAX
package's Pallas backward ``_attn_core_bwd_call`` in interpret mode, at
head_dim 4 (level 0) and 16 (level 2); and the backward kernel's choice of
window groups, a pure function of the shapes and the card's slots."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bde2vid_tpu.ops.window_attn_pallas import _attn_core_bwd_call
from bde2vid_tpu_torch.ops.window_attn_cuda import attn_core_backward, bwd_window_groups


@pytest.mark.parametrize("b_,heads,c", [(2, 16, 64), (3, 16, 256)])
def test_backward_twin_matches_pallas_backward_at_8x8_shapes(b_, heads, c):
    m, n = 64, 448
    rng = np.random.default_rng(b_ * 1000 + c)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v, g = f(b_, m, c), f(b_, n, c), f(b_, n, c), f(b_, m, c)
    bias = f(heads, m, n) * 0.5
    want = _attn_core_bwd_call(heads, True, True, *[jnp.asarray(a) for a in (q, k, v, bias, g)])
    got = attn_core_backward(*[torch.from_numpy(a) for a in (q, k, v, bias, g)], heads)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=1e-4, err_msg=name)


def _group_windows(b_, groups):
    """The windows block (group, head) takes in csrc/attn_core_bwd.cu."""
    return [range(grp * b_ // groups, (grp + 1) * b_ // groups) for grp in range(groups)]


# the four shapes of the model's levels (windows, heads, resident blocks per
# SM on an H100), a B_ no group count divides, and edge cases
@pytest.mark.parametrize("b_,heads,blocks_per_sm", [
    (252, 16, 2), (20, 16, 1), (180, 16, 1), (12, 16, 1), (23, 16, 1), (37, 16, 2),
    (5, 2, 2), (1, 16, 1), (3, 300, 1), (1000, 4, 3),
])
def test_bwd_window_groups_cover_every_window_once_in_one_wave(b_, heads, blocks_per_sm):
    sms = 132
    groups = bwd_window_groups(b_, heads, blocks_per_sm, sms)
    assert groups == bwd_window_groups(b_, heads, blocks_per_sm, sms)
    assert 1 <= groups <= b_
    parts = _group_windows(b_, groups)
    assert sorted(w for part in parts for w in part) == list(range(b_))
    assert min(len(p) for p in parts) >= 1
    slots = sms * blocks_per_sm
    if heads <= slots:
        assert groups * heads <= slots  # one wave
    # no count of groups that also fits one wave leaves a smaller fullest group
    fullest = max(len(p) for p in parts)
    for other in range(1, min(b_, max(1, slots // heads)) + 1):
        assert max(len(p) for p in _group_windows(b_, other)) >= fullest


def test_bwd_window_groups_at_the_flagship_shapes():
    """Level 0 keeps 16 groups (two blocks per SM: 256 of 264 slots); level 2
    packs its 20 windows into 7 groups of at most 3 windows, which fit one
    wave (112 blocks on 132 SMs); the 8x8 shapes take 8 and 6."""
    assert bwd_window_groups(252, 16, 2, 132) == 16
    assert bwd_window_groups(20, 16, 1, 132) == 7
    assert bwd_window_groups(180, 16, 1, 132) == 8
    assert bwd_window_groups(12, 16, 1, 132) == 6
