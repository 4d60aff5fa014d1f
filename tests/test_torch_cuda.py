"""Checks of the hand-written CUDA kernels that need an NVIDIA GPU; they skip
elsewhere. This file imports neither JAX nor the JAX package, so it runs on a
GPU machine without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from bde2vid_tpu_torch.nn import window_attention as twa
from bde2vid_tpu_torch.ops import window_attn_cuda as wac
from bde2vid_tpu_torch.ops.window_attn_cuda import (
    SwinBlockParams,
    WindowBlockParams,
    attn_core_backward,
    attn_core_backward_reference,
    fused_swin_block,
    fused_window_attention,
    fused_window_block,
    launch_counts,
    swin_block_reference,
    window_attention_reference,
    window_block_reference,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, dilated, d=3, h=14, w=14, c=16, heads=4, win=(7, 7)):
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    part = twa.window_partition_dilated if dilated else twa.window_partition
    feats = f(d + 1, 1, h, w, c)
    m = win[0] * win[1]
    x = part(feats[:d], win).reshape(d, -1, m, c).contiguous()
    ctr = part(feats[d:], win)[0].reshape(-1, m, c).contiguous()
    hid = 4 * c
    p = SwinBlockParams(
        1 + f(c, scale=0.1), f(c, scale=0.1), 1 + f(c, scale=0.1), f(c, scale=0.1),
        f(c, c, scale=c**-0.5), f(c, scale=0.1), f(2 * c, c, scale=c**-0.5), f(2 * c, scale=0.1),
        f(c, c, scale=c**-0.5), f(c, scale=0.1), 1 + f(c, scale=0.1), f(c, scale=0.1),
        f(hid, c, scale=c**-0.5), f(hid, scale=0.1), f(c, hid, scale=hid**-0.5), f(c, scale=0.1),
        f(heads, m, d * m, scale=0.5),
    )
    return x, ctr, p


@pytest.mark.cuda
@pytest.mark.parametrize("dilated", [False, True])
@pytest.mark.parametrize("heads", [4, 2, 16])
def test_cuda_kernel_matches_twin(cuda_device, dilated, heads):
    x, ctr, p = _inputs(0, dilated, c=32 if heads == 16 else 16, heads=heads)
    p = SwinBlockParams(*[t.to(cuda_device) for t in p])
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        xd, cd = x.to(cuda_device, dt), ctr.to(cuda_device, dt)
        before = launch_counts["fused_swin_block"]
        got = fused_swin_block(xd, cd, p, heads, 1).float()
        torch.cuda.synchronize()
        assert launch_counts["fused_swin_block"] == before + 1
        ref = swin_block_reference(xd, cd, p, heads, 1).float()
        bound = tol if dt == torch.float32 else tol * ref.abs().max().item()
        assert (got - ref).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("win", [(4, 4), (8, 8)])
def test_cuda_even_dilated_window_launches_window_block(cuda_device, win):
    """An even dilated block on the kernel path launches the WindowAttention3D
    kernel once (and no Swin block kernel) and matches the same block on the
    CPU, where the kernel's twin runs; the output repeats bit for bit (the
    fold sums its taps in a fixed order)."""
    torch.manual_seed(0)
    blk = twa.SwinTransformerBlock3D(16, 4, window_size=(3, *win), dilate_win=True, use_kernel=True)
    x = torch.randn(3, 2, 2 * win[0] + 3, 2 * win[1] + 1, 16)
    with torch.no_grad():
        want = blk(x)
        blk.to(cuda_device)
        before = dict(launch_counts)
        got = blk(x.to(cuda_device))
        again = blk(x.to(cuda_device))
        torch.cuda.synchronize()
    assert launch_counts["fused_window_block"] == before.get("fused_window_block", 0) + 2
    assert launch_counts["fused_swin_block"] == before.get("fused_swin_block", 0)
    assert torch.equal(got, again)
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    x, ctr, p = _inputs(1, False)
    p = SwinBlockParams(*[t.to(cuda_device) for t in p])
    xd, cd = x.to(cuda_device), ctr.to(cuda_device)
    with pytest.raises(TypeError):
        fused_swin_block(xd.half(), cd.half(), p, 4, 1)
    with pytest.raises(ValueError):
        fused_swin_block(xd, cd[:1], p, 4, 1)
    with pytest.raises(NotImplementedError):
        fused_swin_block(xd, cd, p, 4, 1, activation="swish")


def _masks(b_, device, keep=0.75, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.bernoulli(torch.full((b_,), keep, device=device), generator=g) / keep
                 for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("dilated", [False, True])
@pytest.mark.parametrize("heads", [4, 16])
def test_cuda_masked_kernel_and_acc_match_twin(cuda_device, dilated, heads):
    x, ctr, p = _inputs(2, dilated, c=64, heads=heads)
    p = SwinBlockParams(*[t.to(cuda_device) for t in p])
    masks = _masks(x.shape[1], cuda_device)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        xd, cd = x.to(cuda_device, dt), ctr.to(cuda_device, dt)
        got = fused_swin_block(xd, cd, p, heads, 1, masks=masks, with_acc=True)
        ref = swin_block_reference(xd, cd, p, heads, 1, masks=masks, with_acc=True)
        torch.cuda.synchronize()
        for a, r in zip(got, ref):
            r = r.float()
            bound = tol * max(1.0, r.abs().max().item()) if dt == torch.float32 else tol * r.abs().max().item()
            assert (a.float() - r).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("b_,m,n,heads,c", [
    (20, 49, 343, 16, 256), (37, 49, 147, 16, 64), (5, 49, 98, 2, 16),
    (252, 49, 343, 16, 64),  # the flagship's level 0 (level 2 is the first case)
    (180, 64, 448, 16, 64), (12, 64, 448, 16, 256),  # the 8x8 config's levels 0 and 2
    (23, 49, 343, 16, 256),  # a B_ that no group count divides
    (6, 49, 196, 2, 64), (4, 16, 48, 16, 16), (4, 16, 48, 8, 16),  # head_dim 32, 1, 2
    (3, 49, 686, 4, 32),  # N above 512 keys: a lane keeps 32 of a row
])
def test_cuda_backward_kernel_matches_twin_and_repeats_exactly(cuda_device, b_, m, n, heads, c):
    g = torch.Generator(device=cuda_device).manual_seed(b_)
    f = lambda *s: torch.randn(*s, generator=g, device=cuda_device)
    q, k, v, gr, bias = f(b_, m, c), f(b_, n, c), f(b_, n, c), f(b_, m, c), f(heads, m, n) * 0.5
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        ins = [t.to(dt) for t in (q, k, v)]
        before = launch_counts["attn_core_backward"]
        got = attn_core_backward(*ins, bias, gr.to(dt), heads)
        again = attn_core_backward(*ins, bias, gr.to(dt), heads)
        torch.cuda.synchronize()
        assert launch_counts["attn_core_backward"] == before + 2
        ref = attn_core_backward_reference(*ins, bias, gr.to(dt), heads)
        for a, b, r in zip(got, again, ref):
            assert torch.equal(a, b)  # dbias sums in a fixed order: no atomics
            r = r.float()
            bound = tol * max(1.0, r.abs().max().item()) if dt == torch.float32 else tol * r.abs().max().item()
            assert (a.float() - r).abs().max().item() <= bound


@pytest.mark.cuda
def test_cuda_backward_refuses_rows_above_its_register_share(cuda_device):
    """A lane of the backward keeps at most 32 keys of a score row in
    registers: 1024 keys run, 1025 raise before any launch."""
    f = lambda *s: torch.randn(*s, device=cuda_device)
    for n, ok in ((1024, True), (1025, False)):
        q, k, v, bias = f(1, 4, 4), f(1, n, 4), f(1, n, 4), f(1, 4, n)
        before = launch_counts["attn_core_backward"]
        if ok:
            got = attn_core_backward(q, k, v, bias, q, 1)
            ref = attn_core_backward_reference(q, k, v, bias, q, 1)
            torch.cuda.synchronize()
            for a, r in zip(got, ref):
                assert (a - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item())
        else:
            with pytest.raises(ValueError):
                attn_core_backward(q, k, v, bias, q, 1)
        assert launch_counts["attn_core_backward"] == before + ok


@pytest.mark.cuda
def test_cuda_window_attention_with_grad_refuses_keys_its_backward_cannot_take(cuda_device):
    """With a gradient wanted, fused_window_attention refuses more keys than
    the backward takes before its forward launches; without one the forward
    kernel runs them."""
    f = lambda *s: torch.randn(*s, device=cuda_device)
    q, k, v, bias = f(1, 4, 4), f(1, 1025, 4), f(1, 1025, 4), f(1, 4, 1025)
    before = launch_counts["fused_window_attention"]
    with pytest.raises(ValueError):
        fused_window_attention(q.clone().requires_grad_(), k, v, bias, 1)
    assert launch_counts["fused_window_attention"] == before
    got = fused_window_attention(q, k, v, bias, 1)
    ref = window_attention_reference(q, k, v, bias, 1)
    torch.cuda.synchronize()
    assert launch_counts["fused_window_attention"] == before + 1
    assert (got - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
def test_cuda_backward_occupancy_is_that_of_the_named_card(cuda_device):
    """The backward's groups come from the launch device's SMs and slots."""
    index = torch.cuda.current_device()
    occ = wac.attn_core_backward_occupancy(49, 343, 64, 16, torch.float32, index)
    assert occ["sms"] == torch.cuda.get_device_properties(index).multi_processor_count
    assert occ["blocks_per_sm"] >= 1 and occ["row_share"] == 12


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_function_gradients_match_twin_autograd(cuda_device, masked):
    x, ctr, p = _inputs(4, False, c=32, heads=4)
    masks = _masks(x.shape[1], cuda_device) if masked else None
    grads = []
    for fn in (fused_swin_block, swin_block_reference):
        xl = x.to(cuda_device).requires_grad_()
        cl = ctr.to(cuda_device).requires_grad_()
        pl = SwinBlockParams(*[t.to(cuda_device).requires_grad_() for t in p])
        out = fn(xl, cl, pl, 4, 1, masks=masks)
        gout = torch.ones_like(out).mul_(0.01).add_(out.detach())
        grads.append(torch.autograd.grad(out, [xl, cl, *pl], gout))
    for a, r in zip(*grads):
        assert (a - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item())


@pytest.mark.cuda
def test_cuda_old_launch_dropped_gradients_and_the_function_repairs_it(cuda_device):
    """Fault 1 on the card: a bare launch returns a tensor autograd knows
    nothing of (no grad_fn), and with grad on the launcher now refuses
    inputs that require grad; through SwinBlockFunction every attention
    parameter gets a gradient."""
    x, ctr, p = _inputs(5, False)
    xd, cd = x.to(cuda_device), ctr.to(cuda_device)
    pd = SwinBlockParams(*[t.to(cuda_device).requires_grad_() for t in p])
    with torch.no_grad():
        out, _ = wac._launch_swin_block(xd, cd, pd, 4, 1, "gelu", None)
    assert out.grad_fn is None
    with pytest.raises(RuntimeError, match="invisible to autograd"):
        wac._launch_swin_block(xd, cd, pd, 4, 1, "gelu", None)

    blk = twa.SwinTransformerBlock3D(16, 4, window_size=(3, 7, 7), use_kernel=True).to(cuda_device)
    before = dict(launch_counts)
    out = blk(torch.randn(3, 2, 14, 14, 16, device=cuda_device, requires_grad=True))
    out.square().mean().backward()
    assert launch_counts["fused_swin_block"] == before.get("fused_swin_block", 0) + 1
    assert launch_counts["attn_core_backward"] == before.get("attn_core_backward", 0) + 1
    for name, prm in blk.named_parameters():
        assert prm.grad is not None and prm.grad.abs().max() > 0, name


def _block_params(p: SwinBlockParams) -> WindowBlockParams:
    return WindowBlockParams(*p[:10], p.bias)


def _bound(ref, dt):
    r = ref.float().abs().max().item()
    return 1e-4 * max(1.0, r) if dt == torch.float32 else 2e-2 * r


@pytest.mark.cuda
@pytest.mark.parametrize("win,heads,c", [((7, 7), 16, 64), ((8, 8), 16, 256), ((8, 8), 4, 16)])
def test_cuda_window_block_and_attention_match_twins(cuda_device, win, heads, c):
    """The WindowAttention3D kernel (with and without acc) and the bare
    attention kernel vs their twins, f32 and bf16, on dilated windows."""
    x, _, p = _inputs(6, True, d=3, h=2 * win[0] + 2, w=3 * win[1], c=c, heads=heads, win=win)
    pb = _block_params(SwinBlockParams(*[t.to(cuda_device) for t in p]))
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(cuda_device, dt)
        before = dict(launch_counts)
        out, acc = fused_window_block(xd, pb, heads, 1, with_acc=True)
        out2 = fused_window_block(xd, pb, heads, 1)
        ref_out, ref_acc = window_block_reference(xd, pb, heads, 1, with_acc=True)
        q, k, v = xd[1], xd[0], xd[2]
        bias = pb.bias[:, :, : q.shape[1]].contiguous()
        att = fused_window_attention(q, k, v, bias, heads)
        ref_att = window_attention_reference(q, k, v, bias, heads)
        torch.cuda.synchronize()
        assert launch_counts["fused_window_block"] == before.get("fused_window_block", 0) + 2
        assert launch_counts["fused_window_attention"] == before.get("fused_window_attention", 0) + 1
        assert torch.equal(out, out2)
        for got, ref in ((out, ref_out), (acc, ref_acc), (att, ref_att)):
            assert got.dtype == dt
            assert (got.float() - ref.float()).abs().max().item() <= _bound(ref, dt)


@pytest.mark.cuda
def test_cuda_window_functions_gradients_match_twin_autograd(cuda_device):
    """WindowBlockFunction and WindowAttentionFunction on the card (forward
    kernel, backward kernel around autograd of the pre/post stages) vs
    autograd through the twins: every input's gradient."""
    x, _, p = _inputs(7, False, c=32, heads=4)
    grads = []
    for fn in (fused_window_block, window_block_reference):
        xl = x.to(cuda_device).requires_grad_()
        pl = _block_params(SwinBlockParams(*[t.to(cuda_device).requires_grad_() for t in p]))
        out = fn(xl, pl, 4, 1)
        grads.append(torch.autograd.grad(out, [xl, *pl], torch.ones_like(out).mul_(0.01).add_(out.detach())))
    for a, r in zip(*grads):
        assert (a - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item())

    g = torch.Generator(device=cuda_device).manual_seed(8)
    f = lambda *s: torch.randn(*s, generator=g, device=cuda_device)
    ins = (f(5, 49, 32), f(5, 147, 32), f(5, 147, 32), f(4, 49, 147) * 0.5)
    gout = f(5, 49, 32)
    grads = []
    for fn in (fused_window_attention, window_attention_reference):
        leaves = [t.clone().requires_grad_() for t in ins]
        before = dict(launch_counts)
        out = fn(*leaves, 4)
        grads.append(torch.autograd.grad(out, leaves, gout))
        if fn is fused_window_attention:
            assert launch_counts["fused_window_attention"] == before.get("fused_window_attention", 0) + 1
            assert launch_counts["attn_core_backward"] == before.get("attn_core_backward", 0) + 1
    for a, r in zip(*grads):
        assert (a - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item())


@pytest.mark.cuda
def test_cuda_raw_launchers_refuse_inputs_that_require_grad(cuda_device):
    x, _, p = _inputs(9, False)
    xd = x.to(cuda_device)
    pd = SwinBlockParams(*[t.to(cuda_device).requires_grad_() for t in p])
    pb = _block_params(pd)
    k, v, bias = xd[0], xd[2], pd.bias.detach()[:, :, :49].contiguous()
    q = xd[1].clone().requires_grad_()
    for launch in (lambda: wac._launch_swin_block(xd, xd[1], pd, 4, 1, "gelu", None),
                   lambda: wac._launch_window_block(xd, pb, 4, 1),
                   lambda: wac._launch_window_attention(q, k, v, bias, 4),
                   lambda: wac._launch_attn_core_backward(q, k, v, bias, q.detach(), 4)):
        with pytest.raises(RuntimeError, match="invisible to autograd"):
            launch()
    with torch.no_grad():
        out, acc = wac._launch_window_block(xd, pb, 4, 1)
    assert out.grad_fn is None and acc.shape == out.shape


def _flat_inputs(seed, d, b_, m, c, heads, device):
    """x (D, B_, M, C), ctr (B_, M, C) and block weights drawn on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    f = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    hid = 4 * c
    p = SwinBlockParams(
        1 + f(c, scale=0.1), f(c, scale=0.1), 1 + f(c, scale=0.1), f(c, scale=0.1),
        f(c, c, scale=c**-0.5), f(c, scale=0.1), f(2 * c, c, scale=c**-0.5), f(2 * c, scale=0.1),
        f(c, c, scale=c**-0.5), f(c, scale=0.1), 1 + f(c, scale=0.1), f(c, scale=0.1),
        f(hid, c, scale=c**-0.5), f(hid, scale=0.1), f(c, hid, scale=hid**-0.5), f(c, scale=0.1),
        f(heads, m, d * m, scale=0.5),
    )
    return f(d, b_, m, c), f(b_, m, c), p


@pytest.mark.cuda
@pytest.mark.parametrize("activation", sorted(wac._ACT_CODES))
def test_cuda_kernel_matches_twin_for_each_activation(cuda_device, activation):
    """Every registry activation runs in the MLP's fc1 epilogue, f32 and bf16."""
    x, ctr, p = _flat_inputs(11, 3, 6, 49, 32, 4, cuda_device)
    for dt in (torch.float32, torch.bfloat16):
        xd, cd = x.to(dt), ctr.to(dt)
        before = launch_counts["fused_swin_block"]
        got = fused_swin_block(xd, cd, p, 4, 1, activation=activation)
        ref = swin_block_reference(xd, cd, p, 4, 1, activation=activation)
        torch.cuda.synchronize()
        assert launch_counts["fused_swin_block"] == before + 1
        assert (got.float() - ref.float()).abs().max().item() <= _bound(ref, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("b_,c,heads", [(37, 32, 4), (37, 96, 6), (3, 96, 24), (5, 12, 3)])
def test_cuda_gemm_core_edges_match_twins(cuda_device, b_, c, heads):
    """The GEMM core at its edges: 37 windows of 49 tokens (1813 rows, a
    multiple of no tile), widths 32 and 96 (no multiple of 64) with hidden
    4C, and C 12, whose rows are no multiple of 16 bytes (plain loads instead
    of cp.async); the Swin block masked with acc and the WindowAttention3D
    body, f32 and bf16."""
    x, ctr, p = _flat_inputs(b_ + c, 3, b_, 49, c, heads, cuda_device)
    masks = _masks(b_, cuda_device)
    pb = _block_params(p)
    for dt in (torch.float32, torch.bfloat16):
        xd, cd = x.to(dt), ctr.to(dt)
        got = fused_swin_block(xd, cd, p, heads, 1, masks=masks, with_acc=True)
        ref = swin_block_reference(xd, cd, p, heads, 1, masks=masks, with_acc=True)
        got_w = fused_window_block(xd, pb, heads, 1)
        ref_w = window_block_reference(xd, pb, heads, 1)
        torch.cuda.synchronize()
        for a, r in (*zip(got, ref), (got_w, ref_w)):
            assert a.dtype == dt
            assert (a.float() - r.float()).abs().max().item() <= _bound(r, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b_,c", [(252, 64), (20, 256)])
def test_cuda_swin_block_repeats_bitwise(cuda_device, b_, c, masked):
    """Two launches on the flagship's level-0 and level-2 shapes give the
    same bits, f32 and bf16: no split-K, no atomics."""
    x, ctr, p = _flat_inputs(13, 7, b_, 49, c, 16, cuda_device)
    masks = _masks(b_, cuda_device) if masked else None
    for dt in (torch.float32, torch.bfloat16):
        xd, cd = x.to(dt), ctr.to(dt)
        first = fused_swin_block(xd, cd, p, 16, 3, masks=masks, with_acc=True)
        second = fused_swin_block(xd, cd, p, 16, 3, masks=masks, with_acc=True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def _attn_inputs(seed, b_, m, n, c, heads, device):
    g = torch.Generator(device=device).manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, device=device)
    return f(b_, m, c), f(b_, n, c), f(b_, n, c), f(heads, m, n) * 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [1, 2, 4, 8, 16, 32])
def test_cuda_window_attention_matches_twin_at_each_head_dim(cuda_device, hd):
    """The bare attention kernel vs its twin at every head_dim it takes,
    f32 and bf16, with a window count no group size divides and M not a
    multiple of a warp's rows."""
    heads = 4
    q, k, v, bias = _attn_inputs(20 + hd, 23, 49, 147, heads * hd, heads, cuda_device)
    for dt in (torch.float32, torch.bfloat16):
        ins = [t.to(dt) for t in (q, k, v)]
        before = launch_counts["fused_window_attention"]
        got = fused_window_attention(*ins, bias, heads)
        ref = window_attention_reference(*ins, bias, heads)
        torch.cuda.synchronize()
        assert launch_counts["fused_window_attention"] == before + 1
        assert got.dtype == dt
        assert (got.float() - ref.float()).abs().max().item() <= _bound(ref, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [384, 385, 512, 513, 1024, 1025, 2048])
def test_cuda_window_attention_at_row_share_boundaries(cuda_device, n):
    """N at each boundary of a lane's register share (32 x 12, 16, 32 keys)
    and past the last, where rows run in chunks: no gradient, so no key
    limit of the backward applies."""
    q, k, v, bias = _attn_inputs(n, 3, 7, n, 16, 4, cuda_device)
    for dt in (torch.float32, torch.bfloat16):
        ins = [t.to(dt) for t in (q, k, v)]
        got = fused_window_attention(*ins, bias, 4)
        ref = window_attention_reference(*ins, bias, 4)
        torch.cuda.synchronize()
        assert (got.float() - ref.float()).abs().max().item() <= _bound(ref, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("b_,c", [(252, 64), (20, 256)])
def test_cuda_window_attention_and_swin_block_repeat_bitwise(cuda_device, b_, c):
    """B4 and B1 at the flagship's level shapes give the same bits on two
    runs, f32 and bf16: each output sums in a fixed order in one warp."""
    q, k, v, bias = _attn_inputs(30, b_, 49, 343, c, 16, cuda_device)
    x, ctr, p = _flat_inputs(31, 7, b_, 49, c, 16, cuda_device)
    for dt in (torch.float32, torch.bfloat16):
        ins = [t.to(dt) for t in (q, k, v)]
        first = fused_window_attention(*ins, bias, 16)
        second = fused_window_attention(*ins, bias, 16)
        xd, cd = x.to(dt), ctr.to(dt)
        block = fused_swin_block(xd, cd, p, 16, 3)
        block2 = fused_swin_block(xd, cd, p, 16, 3)
        torch.cuda.synchronize()
        assert torch.equal(first, second) and torch.equal(block, block2)


@pytest.mark.cuda
@pytest.mark.parametrize("lib", ["window_attention", "swin_block", "window_block"])
@pytest.mark.parametrize("b_,m,n,c", [(252, 49, 343, 64), (20, 49, 343, 256), (180, 64, 448, 64),
                                     (12, 64, 448, 256)])
def test_cuda_forward_occupancy_is_that_of_the_named_card(cuda_device, lib, b_, m, n, c):
    """The forward attention's occupancy comes from the launch device, and
    the library agrees with the host plan: its threads, its shared memory
    and its resident blocks, from which the plan's tiles follow."""
    index = torch.cuda.current_device()
    for dt in (torch.float32, torch.bfloat16):
        bf16 = dt == torch.bfloat16
        mma = bf16 and c // 16 >= 16  # the tensor-core kernel: no row share
        occ = wac.attn_forward_occupancy(lib, m, n, c, 16, dt, index)
        assert occ["sms"] == torch.cuda.get_device_properties(index).multi_processor_count
        assert occ["blocks_per_sm"] >= 1
        assert occ["row_share"] == (0 if mma else 12 if n <= 384 else 16)
        assert occ["smem_bytes"] == wac.attn_smem_bytes(n, c // 16, bf16)
        plan = wac.attn_plan_for(lib, b_, m, n, c, 16, dt, index)
        assert occ["threads"] == plan.threads == wac.ATTN_THREADS
        assert plan == wac.attn_forward_plan(b_, 16, m, n, c // 16, occ["sms"],
                                             occ["blocks_per_sm"], bf16)
