"""Every head_dim from 1 to 256 through the attention kernels' plans and
twins (ROADMAP C6, repaired): a head_dim between the instantiated ones (1,
2, 4, ..., 256) runs at the next one up with zero columns past its own, and
above 32 the forward takes the key-tiled kernel and the backward the wide
backward; above 256 the forward takes the wide forward and the backward
still the wide backward (ROADMAP C7 and C8, repaired; head dims 320 to
1024 in tests/test_torch_attn_wide_backward.py, head_dim 2048 in
tests/test_torch_attn_tiled_backward.py, the wide forward's arithmetic in
tests/test_torch_attn_wide_forward.py).

On the CPU: the plans at the head dims the flagship's widths give with 1 to
16 heads (3 to 256) and at the buffers of 7, 9, 31 and 61 frames; the twins
against the JAX package's fused attention in interpret mode and its VJP at
C 256 with 4 and 2 heads; a small BDE2VID whose level 2 has head_dim 64
against the JAX package; and an emulation of the key-tiled forward's
one-sweep recurrence, with its bf16 cast points, against the twin under the
kernel-vs-twin gates. The kernels themselves run in tests/test_torch_cuda.py
and chip_smoke.py's ``head_dims`` phase.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.ops.window_attn_pallas import fused_window_attention as jax_attention
from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
from bde2vid_tpu_torch.ops.window_attn_cuda import (
    FLASH_THREADS,
    WIDE_FORWARD_HEAD_DIM,
    WIDE_THREADS,
    _MAX_SMEM,
    _check_head_dim,
    _heads,
    _padded_head_dim,
    attn_core_backward_reference,
    attn_core_bwd_plan,
    attn_core_reference,
    attn_forward_plan,
    attn_smem_bytes,
    bwd_counter,
)
from tests.test_torch_config_surface import BASE, _port, nchw, seeded_variables
from tests.test_torch_parallel_nwindow import concrete_gathers  # noqa: F401  (a fixture)

HEAD_DIMS = (3, 6, 12, 24, 48, 64, 96, 128, 256)
KEYS = (343, 448, 1519, 2989)  # 7 frames of 7x7, of 8x8 windows; 31 and 61 of 7x7
HEADS = {3: 16, 6: 16, 12: 16, 24: 8, 48: 4, 64: 4, 96: 2, 128: 2, 256: 1}
KEY_TILES = (16, 32, 64)  # the key-tiled forward's tiles (flash_key_tile in csrc/window_common.cuh)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("bf16", [False, True])
def test_plans_take_every_head_dim_and_the_launch_checks_accept_them(hd, bf16):
    """The forward and backward plans return at every N, in a block that
    fits; the launchers' head_dim check accepts the shapes; above head_dim
    32 every row takes the wide backward and the key-tiled forward, above
    the hand-over (256) the wide forward."""
    heads = HEADS[hd]
    c = heads * hd
    _check_head_dim(c, heads)
    for n in KEYS:
        m = 64 if n == 448 else 49
        fwd = attn_forward_plan(20, heads, m, n, hd, sms=132, blocks_per_sm=1, bf16=bf16)
        if fwd.wide:
            assert fwd.threads == WIDE_THREADS and not fwd.key_tiled
        elif fwd.key_tiled:
            assert fwd.threads == FLASH_THREADS
        else:
            assert hd <= 32 and attn_smem_bytes(n, hd, bf16) <= _MAX_SMEM
        assert fwd.wide == (hd > WIDE_FORWARD_HEAD_DIM)
        assert fwd.key_tiled or fwd.wide or hd <= 32
        bwd = attn_core_bwd_plan(m, n, c, heads)
        assert bwd.smem_bytes <= _MAX_SMEM
        assert (bwd_counter(bwd, hd) == "attn_core_backward_wide") == (hd > 32)
        if hd > 32:  # the wide backward's tiles are its own
            assert not bwd.key_tiles and not bwd.row_share


@pytest.mark.parametrize("c,heads", [(256, 4), (256, 2), (256, 1), (96, 16), (192, 16), (48, 16)])
def test_head_dim_check_takes_the_flagship_widths_at_any_head_count(c, heads):
    _check_head_dim(c, heads)
    attn_core_bwd_plan(49, 343, c, heads)
    attn_forward_plan(20, heads, 49, 343, c // heads, sms=132, blocks_per_sm=1)


def test_head_dims_above_256_raise_value_error_in_both_plans():
    """ROADMAP C7 and C8, repaired: no head_dim raises any longer. One head
    at base 64 or 128 (head_dim 512 or 1024) and above 1024 (1536, 2048 and
    2049, which the wide forward runs as they are: padded_hd is the power
    of two of the kernels instantiated at one, none of them above 256)
    plans in both plans and passes the launch check: the wide forward and
    the wide backward."""
    for hd, padded in ((512, 512), (1024, 1024), (1536, 2048), (2048, 2048), (2049, 4096)):
        assert attn_forward_plan(20, 1, 49, 343, hd, sms=132, blocks_per_sm=1).wide
        plan = attn_core_bwd_plan(49, 343, hd, 1)
        assert plan.smem_bytes <= _MAX_SMEM and bwd_counter(plan, hd) == "attn_core_backward_wide"
        assert _padded_head_dim(hd) == padded
        _check_head_dim(hd, 1)


def _seeded(shape, rng, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("heads", [4, 2])
def test_twins_match_jax_fused_attention_and_its_vjp(heads):
    """attn_core_reference and attn_core_backward_reference against the JAX
    package's fused attention in interpret mode and its VJP (the
    interpret-mode Pallas backward) at C 256 (head_dim 64 and 128), B_ 2, M
    49, N 147: forward within 2e-4, gradients within 1e-4."""
    rng = np.random.default_rng(heads)
    b_, m, n, c = 2, 49, 147, 256
    q, k, v, g = _seeded((b_, m, c), rng), _seeded((b_, n, c), rng), _seeded((b_, n, c), rng), \
        _seeded((b_, m, c), rng)
    bias = _seeded((heads, m, n), rng, 0.5)
    out, vjp = jax.vjp(lambda *a: jax_attention(*a, num_heads=heads, interpret=True),
                       *map(jnp.asarray, (q, k, v, bias)))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv, tb, tg = map(torch.from_numpy, (q, k, v, bias, g))
    got = attn_core_reference(tq, tk, tv, tb, heads).numpy()
    np.testing.assert_allclose(got, np.asarray(out), atol=2e-4, rtol=0)
    for got_g, want_g in zip(attn_core_backward_reference(tq, tk, tv, tb, tg, heads), want_grads):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def head_dim_64_jax(concrete_gathers):
    """The JAX side of the head_dim-64 BDE2VID, run once for both attention
    paths of the port: (cfg, voxels, variables, images)."""
    cfg = {"generator": dict(BASE, num_encoders=3, depths=[1, 0, 1], num_heads=1)}
    vox = _seeded((2, 1, 32, 32, 5), np.random.default_rng(16))  # 32 = 4 x 2^3
    jmodel = jax_build("BDE2VID", cfg)
    variables = seeded_variables(jmodel, vox, seed=16)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(vox))[0]["image"])
    return cfg, vox, variables, want


@pytest.mark.parametrize("kernel", [False, True])
def test_bde2vid_with_head_dim_64_at_level_2_matches_jax(kernel, head_dim_64_jax):
    """A small BDE2VID with one head over three encoders (head_dim 16 at
    level 0, 64 at level 2), port vs the JAX package on the CPU in f32,
    both attention paths (the kernel path takes the kernels' twins here),
    within atol 2e-4 (tests/test_bde2vid.py:313)."""
    cfg, vox, variables, want = head_dim_64_jax
    model = _port(cfg, variables, train=False)
    set_attention_kernel(model, kernel)
    with torch.no_grad():
        got = model(nchw(vox))["image"].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want.transpose(0, 1, 4, 2, 3), atol=2e-4, rtol=0)


def one_sweep_attention(q, k, v, bias, num_heads, key_tile):
    """The key-tiled forward's recurrence in plain torch (attn_flash_kernel
    in csrc/window_common.cuh): per key tile, the running max rises to the
    tile's, the running sum and the output sums are rescaled by exp(old max
    - new max), p = exp(s - max) is rounded to the operand type before it
    multiplies v, and the division by the sum comes once, at the end. The
    twin (attn_core_reference) rounds p after that division."""
    b_, m, c = q.shape
    dt = q.dtype
    hd = c // num_heads
    s_all = (_heads(q, num_heads) @ _heads(k, num_heads).transpose(-2, -1)) * hd**-0.5
    s_all = s_all + bias.float()[None]
    vh = _heads(v, num_heads)
    mx = torch.full(s_all.shape[:-1], -1e30)
    total = torch.zeros(s_all.shape[:-1])
    o = torch.zeros(*s_all.shape[:-1], hd)
    for t0 in range(0, k.shape[1], key_tile):
        s = s_all[..., t0:t0 + key_tile]
        new = torch.maximum(mx, s.amax(-1))
        alpha = torch.exp(mx - new)
        p = torch.exp(s - new[..., None])
        total = total * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.to(dt).float() @ vh[..., t0:t0 + key_tile, :]
        mx = new
    out = o / total[..., None]
    return out.transpose(1, 2).reshape(b_, m, c).to(dt)


@pytest.fixture
def one_thread():
    """torch on one intra-op thread for the test: the recurrence is
    thousands of small ops, each a parallel region that, beside other test
    processes on the same cores, waits on descheduled threads (a hundred
    times slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_one_sweep_recurrence_meets_the_gates_against_the_twin(hd, one_thread):
    """The emulated one-sweep forward against the twin, f32 within 1e-4 x
    max(1, max|twin|) and bf16 within 2e-2 x max|twin| (the kernel-vs-twin
    gates), at every N of KEYS and every tile of KEY_TILES."""
    heads = HEADS[hd]
    c = heads * hd
    rng = np.random.default_rng(hd)
    for n in KEYS:
        m = 64 if n == 448 else 49
        q, k, v = (torch.from_numpy(_seeded(s, rng)) for s in ((2, m, c), (2, n, c), (2, n, c)))
        bias = torch.from_numpy(_seeded((heads, m, n), rng, 0.5))
        for dt in (torch.float32, torch.bfloat16):
            ins = [t.to(dt) for t in (q, k, v)]
            want = attn_core_reference(*ins, bias, heads).float()
            top = want.abs().max().item()
            for tile in KEY_TILES:
                got = one_sweep_attention(*ins, bias, heads, tile)
                err = (got.float() - want).abs().max().item()
                assert err <= (1e-4 * max(1.0, top) if dt == torch.float32 else 2e-2 * top), (n, dt, tile, err)
