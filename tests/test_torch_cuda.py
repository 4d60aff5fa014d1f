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
    # long rows: 21 buffer frames of 7x7 windows at the flagship's levels,
    # 17 of 8x8 at the 8x8 config's, 1025 keys at head_dim 1, and 1024 keys
    # whose (M, N) plane does not fit in shared memory
    (252, 49, 1029, 16, 64), (20, 49, 1029, 16, 256), (180, 64, 1088, 16, 64),
    (12, 64, 1088, 16, 256), (5, 16, 1025, 16, 16), (3, 64, 1024, 16, 256),
])
def test_cuda_backward_kernel_matches_twin_and_repeats_exactly(cuda_device, b_, m, n, heads, c):
    g = torch.Generator(device=cuda_device).manual_seed(b_)
    f = lambda *s: torch.randn(*s, generator=g, device=cuda_device)
    q, k, v, gr, bias = f(b_, m, c), f(b_, n, c), f(b_, n, c), f(b_, m, c), f(heads, m, n) * 0.5
    key = wac.bwd_counter(wac.attn_core_bwd_plan(m, n, c, heads), c // heads)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        ins = [t.to(dt) for t in (q, k, v)]
        before = launch_counts[key]
        got = attn_core_backward(*ins, bias, gr.to(dt), heads)
        again = attn_core_backward(*ins, bias, gr.to(dt), heads)
        torch.cuda.synchronize()
        assert launch_counts[key] == before + 2
        ref = attn_core_backward_reference(*ins, bias, gr.to(dt), heads)
        for a, b, r in zip(got, again, ref):
            assert torch.equal(a, b)  # dbias sums in a fixed order: no atomics
            r = r.float()
            bound = tol * max(1.0, r.abs().max().item()) if dt == torch.float32 else tol * r.abs().max().item()
            assert (a.float() - r).abs().max().item() <= bound


@pytest.mark.cuda
def test_cuda_backward_refuses_rows_above_its_register_share(cuda_device):
    """A lane of the backward keeps at most 32 keys of a score row in
    registers: 1024 keys run that kernel, 1025 the long-row variant, and
    rows whose k and v exceed a block's shared memory the key-tiled
    variant (they raised before it existed)."""
    f = lambda *s: torch.randn(*s, device=cuda_device)
    for n, heads, c, key in ((1024, 1, 4, "attn_core_backward"),
                             (1025, 1, 4, "attn_core_backward_long_rows"),
                             (1800, 1, 32, "attn_core_backward_key_tiles")):
        q, k, v, bias = f(1, 4, c), f(1, n, c), f(1, n, c), f(heads, 4, n)
        before = dict(launch_counts)
        got = attn_core_backward(q, k, v, bias, q, heads)
        ref = attn_core_backward_reference(q, k, v, bias, q, heads)
        torch.cuda.synchronize()
        for a, r in zip(got, ref):
            assert (a - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item())
        assert dict(launch_counts) == {**before, key: before.get(key, 0) + 1}


@pytest.mark.cuda
def test_cuda_window_attention_with_grad_refuses_keys_its_backward_cannot_take(cuda_device):
    """With a gradient wanted, fused_window_attention trains rows of 1025
    keys (the backward's long-row variant) like its twin's autograd, and
    rows of 1450 keys at head_dim 16, whose k, v, q and g rows exceed a
    block's shared memory (they were refused before their forward launched
    until the backward's key-tiled variant took them)."""
    f = lambda *s: torch.randn(*s, device=cuda_device)
    for n, c, fwd, bwd in ((1025, 4, "fused_window_attention", "attn_core_backward_long_rows"),
                           (1450, 16, "fused_window_attention", "attn_core_backward_key_tiles")):
        q, k, v, bias = f(2, 4, c), f(2, n, c), f(2, n, c), f(1, 4, n)
        grads = []
        for fn in (fused_window_attention, window_attention_reference):
            before = dict(launch_counts)
            leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
            out = fn(*leaves, 1)
            grads.append(torch.autograd.grad(out, leaves, torch.ones_like(out) + out.detach()))
            torch.cuda.synchronize()
            launched = {key: val - before.get(key, 0) for key, val in launch_counts.items()
                        if val != before.get(key, 0)}
            assert launched == ({fwd: 1, bwd: 1} if fn is fused_window_attention else {})
        for a, r in zip(*grads):
            assert (a - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,c,heads", [(49, 343, 64, 16), (64, 448, 256, 16), (49, 1029, 64, 16),
                                         (64, 1088, 256, 16), (64, 1024, 256, 16),
                                         (49, 1401, 256, 16), (49, 7399, 64, 16), (49, 343, 512, 1),
                                         (64, 1519, 1024, 1), (144, 432, 64, 16), (144, 1029, 256, 16)])
def test_cuda_backward_plan_is_the_librarys(cuda_device, m, n, c, heads):
    """The planner's shared memory is the library's for the kernel it picks,
    and the occupancy query reports that kernel's row share and key tile
    (the tiled backward's 32 keys, at every shape it takes)."""
    plan = wac.attn_core_bwd_plan(m, n, c, heads)
    lib = wac._lib("attn_core_bwd")
    assert lib.attn_core_bwd_smem_bytes(m, n, c, heads, plan.row_share) == plan.smem_bytes
    occ = wac.attn_core_backward_occupancy(m, n, c, heads, torch.float32, torch.cuda.current_device())
    assert occ["row_share"] == plan.row_share and occ["smem_bytes"] == plan.smem_bytes
    tiled = not plan.row_share and c // heads <= 32
    assert occ["key_tile"] == (32 if tiled else 0) and (plan.key_tiles <= tiled)
    assert occ["blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("win,frames,c", [((7, 7), 21, 64), ((7, 7), 21, 256), ((8, 8), 17, 64),
                                          ((8, 8), 17, 256)])
def test_cuda_long_buffer_blocks_train_on_the_kernel_path(cuda_device, win, frames, c):
    """Fault C3: a Swin block and an even dilated block (8x8: the
    WindowAttention3D kernel) over long buffers (N = 1029 or 1088 keys)
    train on the kernel path, the backward taking its long-row variant; the
    gradients are within 1e-3 relative of the unfused path's."""
    torch.manual_seed(7)
    h, w = 2 * win[0], 2 * win[1]
    x = torch.randn(frames, 1, h, w, c, device=cuda_device)
    for dilate in (False, True):
        blk = twa.SwinTransformerBlock3D(c, 16, (frames, *win), dilate_win=dilate,
                                         use_kernel=True).to(cuda_device)
        even_dilated = dilate and win[0] % 2 == 0
        grads = []
        for kernel in (True, False):
            twa.set_attention_kernel(blk, kernel)
            blk.zero_grad(set_to_none=True)
            xl = x.clone().requires_grad_()
            before = dict(launch_counts)
            out = blk(xl)
            out.square().mean().backward()
            torch.cuda.synchronize()
            launched = {k: v - before.get(k, 0) for k, v in launch_counts.items() if v != before.get(k, 0)}
            if kernel:
                fwd = "fused_window_block" if even_dilated else "fused_swin_block"
                assert launched == {fwd: 1, "attn_core_backward_long_rows": 1}
            else:
                assert launched == {}
            grads.append({"x": xl.grad, **{k: p.grad for k, p in blk.named_parameters()}})
        for key, gu in grads[1].items():
            gk = grads[0][key]
            if key == "attn.kv.bias":
                gk, gu = gk[c:], gu[c:]  # the key half is analytically zero
            rel = (gk - gu).abs().max().item() / max(gu.abs().max().item(), 1e-30)
            assert rel <= 1e-3, (key, dilate, rel)


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


@pytest.mark.cuda
def test_cuda_e2vid_recurrent_full_width_matches_cpu_and_threads_state(cuda_device):
    """E2VIDRecurrent at the released E2VID widths (base 32, 3 encoders, 2
    residual blocks, BN, transposed-conv decoders) over T=4 frames of
    184x240: images and final state on the card within 2e-4 of the CPU's,
    no hand-written kernel launched. Then the eval driver on a synthetic
    sequence: chunks of 3 steps give the numbers of one dispatch (the state
    carries across chunks)."""
    from bde2vid_tpu_torch.data.pipeline import EventSequence
    from bde2vid_tpu_torch.eval.driver import EvalConfig, evaluate_sequence
    from bde2vid_tpu_torch.models import ModelSpec, build_model, run_sequence

    cfg = {"num_bins": 5, "base_num_channels": 32, "num_encoders": 3, "num_residual_blocks": 2,
           "norm": "BN", "use_upsample_conv": False}
    torch.manual_seed(0)
    cpu = build_model("E2VIDRecurrent", cfg, device="cpu")
    for name, buf in cpu.named_buffers():
        if name.endswith("running_var"):
            buf.uniform_(0.5, 1.5)
        elif name.endswith("running_mean"):
            buf.normal_(0.0, 0.1)
    card = build_model("E2VIDRecurrent", cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    vox = torch.randn(4, 1, 5, 184, 240)
    launch_counts.clear()
    with torch.no_grad():
        want, want_state = run_sequence(cpu, vox, cpu.initial_state(1, 184, 240))
        got, got_state = run_sequence(card, vox.to(cuda_device), card.initial_state(1, 184, 240))
    torch.cuda.synchronize()
    assert not any(launch_counts.values())
    assert (got.cpu() - want).abs().max().item() <= 2e-4
    for g, w in zip([t for s in got_state for t in s], [t for s in want_state for t in s]):
        assert (g.cpu() - w).abs().max().item() <= 2e-4

    class Reader:  # 7 frames of 180x240, 3000 events a window
        sensor_size, num_frames = (180, 240), 7

        def __init__(self):
            rng = np.random.default_rng(3)
            n = 6 * 3000
            self.ev = (rng.integers(0, 240, n), rng.integers(0, 180, n),
                       np.sort(rng.uniform(0, 1, n)), rng.integers(0, 2, n))
            self.imgs = rng.uniform(0, 1, (7, 180, 240)).astype(np.float32)

        def raw_events(self, i0, i1):
            return tuple(a[i0:i1] for a in self.ev)

        def frame(self, i):
            return self.imgs[i]

    seq = EventSequence(Reader(), np.stack([np.arange(6) * 3000, np.arange(1, 7) * 3000], 1))
    spec = ModelSpec("E2VIDRecurrent", card, num_encoders=3)
    chunked = evaluate_sequence(spec, seq, EvalConfig(subseq_L=3))[1]
    whole = evaluate_sequence(spec, seq, EvalConfig(subseq_L=None))[1]
    for metric in ("mse", "ssim"):
        assert len(chunked[metric]) == 6
        np.testing.assert_allclose(chunked[metric], whole[metric], atol=1e-6, rtol=0)


_EITR_SMALL = {"num_bins": 5, "norm": None, "d_model": 32, "dim_feedforward": 64, "nhead": 4,
               "channels": [8, 16, 32, 32]}


def _float_tensors(state):
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in _float_tensors(state[k])]
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _float_tensors(s)]
    return [state] if state.is_floating_point() else []


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg", [("SPADEE2VID", {}), ("EITR", _EITR_SMALL)])
def test_cuda_spade_and_eitr_match_cpu_and_launch_no_kernel(cuda_device, name, cfg):
    """SPADE-E2VID (its fixed widths) and EITR (small widths) over T=3
    frames of 36x44 (EITR pads to 40x48 inside):
    images and final state, SPADE's pred included, on the card within 2e-4
    of the CPU's; no hand-written kernel launched."""
    from bde2vid_tpu_torch.models import build_model, run_sequence

    torch.manual_seed(0)
    cpu = build_model(name, cfg, device="cpu")
    for key, buf in cpu.named_buffers():
        if key.endswith("running_var"):
            buf.uniform_(0.5, 1.5)
        elif key.endswith("running_mean"):
            buf.normal_(0.0, 0.1)
    card = build_model(name, cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    h, w = 36, 44
    vox = torch.randn(3, 1, 5, h, w)
    launch_counts.clear()
    with torch.no_grad():
        want, want_state = run_sequence(cpu, vox, cpu.initial_state(1, h, w))
        got, got_state = run_sequence(card, vox.to(cuda_device), card.initial_state(1, h, w))
    torch.cuda.synchronize()
    assert not any(launch_counts.values())
    assert got.shape == (3, 1, 1, h, w)
    assert (got.cpu() - want).abs().max().item() <= 2e-4
    got_st, want_st = _float_tensors(got_state), _float_tensors(want_state)
    assert len(got_st) == len(want_st) == (9 if name == "SPADEE2VID" else 6)
    for g, wt in zip(got_st, want_st):
        assert (g.cpu() - wt).abs().max().item() <= 2e-4


def _write_mmp(path, rng, num_frames=6, events_per_frame=2000, hw=(36, 44), fps=25.0):
    """A memmap sequence directory (``events/tools.py``'s layout) with
    uniform timestamps: ``events_per_frame`` events a window on average."""
    import json
    import os

    os.makedirs(path)
    h, w = hw
    n = num_frames * events_per_frame
    frame_ts = 1000.0 + (np.arange(num_frames) + 1) / fps
    np.save(os.path.join(path, "t.npy"), np.sort(rng.uniform(1000.0, frame_ts[-1], size=n)))
    np.save(os.path.join(path, "xy.npy"),
            np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], axis=1).astype(np.int16))
    np.save(os.path.join(path, "p.npy"), rng.integers(0, 2, n).astype(np.uint8))
    np.save(os.path.join(path, "images.npy"),
            rng.integers(0, 256, (num_frames, h, w, 1)).astype(np.uint8))
    np.save(os.path.join(path, "timestamps.npy"), frame_ts)
    with open(os.path.join(path, "dataset_config.json"), "w") as fp:
        json.dump({"sensor_resolution": [h, w]}, fp)


@pytest.mark.cuda
def test_cuda_event_rate_driver_on_a_tiny_mmp_tree(cuda_device, tmp_path):
    """SPADE through the eval driver on a 36x44 MMP sequence split at
    ev_rate 0.35 (554 events a sub-voxel, about 2000 a window: 3 sub-voxels
    an item): finite numbers, one per item, the same at subseq_L 2 as in
    one dispatch (within 1e-6), no hand-written kernel launched."""
    from bde2vid_tpu_torch.data.pipeline import load_sequence
    from bde2vid_tpu_torch.eval.driver import EvalConfig, evaluate_sequence
    from bde2vid_tpu_torch.models import ModelSpec, build_model

    _write_mmp(str(tmp_path / "seq"), np.random.default_rng(4))
    seq = load_sequence(str(tmp_path / "seq"), ltype="MMP", ev_rate=0.35, normalize=True)
    assert len(seq) == 5
    assert np.diff(np.concatenate([[-1], seq.item_last])).tolist() == [3] * 5
    torch.manual_seed(0)
    spec = ModelSpec("SPADEE2VID", build_model("SPADEE2VID", {}, device=cuda_device),
                     num_encoders=3, normalize=True)
    launch_counts.clear()
    chunked = evaluate_sequence(spec, seq, EvalConfig(subseq_L=2, normalize=True))[1]
    whole = evaluate_sequence(spec, seq, EvalConfig(subseq_L=None, normalize=True))[1]
    assert not any(launch_counts.values())
    for metric in ("mse", "ssim"):
        assert len(chunked[metric]) == 5 and np.isfinite(chunked[metric]).all()
        np.testing.assert_allclose(chunked[metric], whole[metric], atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_cuda_voxels_from_pinned_buffers_match_cpu(cuda_device, tmp_path):
    """Batches of 2 windows, each packed into pinned buffers and copied
    asynchronously: every batch's voxels equal the CPU's (the pinned cache
    must not hand a buffer to the next batch while its copy runs)."""
    from bde2vid_tpu_torch.data.pipeline import load_sequence
    from bde2vid_tpu_torch.native import pack_counts

    _write_mmp(str(tmp_path / "seq"), np.random.default_rng(5))
    seq = load_sequence(str(tmp_path / "seq"), ltype="MMP")
    assert all(b.is_pinned() for b in seq._pack(0, 3, pin=True))
    before = pack_counts["native"]
    for _ in range(3):
        got = seq.voxels(device=cuda_device, batch=2)
        want = seq.voxels(device="cpu", batch=2)
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    assert pack_counts["native"] == before + 6 * -(-len(seq.windows) // 2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["EVSNN", "PAEVSNN"])
def test_cuda_snn_matches_cpu_and_launches_no_kernel(cuda_device, name):
    """Full width at 64x80, T=2: the pre-spike drive within 2e-4, at least
    99.9 % of image pixels within 2e-4 and the images within 1e-2 by
    relative L2 (a membrane at the threshold may fire on one device only)."""
    from bde2vid_tpu_torch.models import build_model, run_sequence
    from bde2vid_tpu_torch.utils.norm import legacy_norm

    torch.manual_seed(0)
    model = build_model(name, {}, device="cpu").eval()
    with torch.no_grad():
        for key, t in model.state_dict().items():
            if t.is_floating_point() and t.ndim > 1:
                t.copy_(torch.randn(t.shape) / t[0].numel() ** 0.5)
    card = build_model(name, {}, device=cuda_device).eval()
    card.load_state_dict(model.state_dict())
    vox = torch.randn(2, 1, 5, 64, 80)
    launch_counts.clear()
    with torch.no_grad():
        got, _ = run_sequence(card, vox.to(cuda_device), card.initial_state(1, 64, 80))
        want, _ = run_sequence(model, vox, model.initial_state(1, 64, 80))
        x0 = legacy_norm(vox[0], unbiased=True, batched=True)[:, :1]
        drive = (card.static_conv(x0.to(cuda_device)).cpu() - model.static_conv(x0)).abs().max()
    assert not any(launch_counts.values())
    diff = (got.cpu() - want).abs()
    assert drive <= 2e-4
    assert (diff <= 2e-4).double().mean() >= 0.999
    assert diff.norm() / want.norm() <= 1e-2


# Key tiles (ROADMAP C5): the first N past each old limit and the far rows
# (61 and 151 frames of 7x7 windows), per head_dim.
_TILED_KEYS = {16: (1453, 2897, 2989), 4: (7265, 7399)}
# the same in whole frames of 49 keys, for the block kernels (N = D M)
_TILED_FRAMES = {16: (30, 60, 61), 4: (149, 151)}


def _launched(before):
    return {k: v - before.get(k, 0) for k, v in launch_counts.items() if v != before.get(k, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 4])
def test_cuda_key_tiled_window_attention_matches_twin(cuda_device, hd):
    """The bare attention core (k and v in their own layout) above its old
    key limits, f32 and bf16: the key-tiled kernel wherever the plan picks
    it, its own launch counter, within the kernel-vs-twin gates."""
    heads = 16
    for n in _TILED_KEYS[hd]:
        q, k, v, bias = _attn_inputs(n, 3, 49, n, heads * hd, heads, cuda_device)
        for dt in (torch.float32, torch.bfloat16):
            plan = wac.attn_forward_plan(3, heads, 49, n, hd, 132, 1, dt == torch.bfloat16)
            ins = [t.to(dt) for t in (q, k, v)]
            before = dict(launch_counts)
            got = fused_window_attention(*ins, bias, heads)
            ref = window_attention_reference(*ins, bias, heads)
            torch.cuda.synchronize()
            want = "fused_window_attention_key_tiles" if plan.key_tiled else "fused_window_attention"
            assert _launched(before) == {want: 1}, (n, dt)
            assert (got.float() - ref.float()).abs().max().item() <= _bound(ref, dt), (n, dt)
    assert plan.key_tiled  # the far rows take the tiles in bf16 too


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 4])
@pytest.mark.parametrize("lib", ["swin_block", "window_block"])
def test_cuda_key_tiled_block_attention_matches_twin(cuda_device, hd, lib):
    """The Swin block's and the WindowAttention3D body's attention stage
    (k and v in the k|v scratch) above the old key limits, f32 and bf16,
    with and without acc: repeat bit for bit and match the twins."""
    heads, m = 16, 49
    for frames in _TILED_FRAMES[hd]:
        x, ctr, p = _flat_inputs(frames, frames, 2, m, heads * hd, heads, cuda_device)
        for dt in (torch.float32, torch.bfloat16):
            plan = wac.attn_forward_plan(2, heads, m, frames * m, hd, 132, 1, dt == torch.bfloat16)
            xd, cd = x.to(dt), ctr.to(dt)
            before = dict(launch_counts)
            if lib == "swin_block":
                got = fused_swin_block(xd, cd, p, heads, frames // 2, with_acc=True)
                again = fused_swin_block(xd, cd, p, heads, frames // 2, with_acc=True)
                ref = swin_block_reference(xd, cd, p, heads, frames // 2, with_acc=True)
                name = "fused_swin_block"
            else:
                pb = _block_params(p)
                got = fused_window_block(xd, pb, heads, frames // 2, with_acc=True)
                again = fused_window_block(xd, pb, heads, frames // 2, with_acc=True)
                ref = window_block_reference(xd, pb, heads, frames // 2, with_acc=True)
                name = "fused_window_block"
            torch.cuda.synchronize()
            assert _launched(before) == {name + ("_key_tiles" if plan.key_tiled else ""): 2}
            for a, b, r in zip(got, again, ref):
                assert torch.equal(a, b)
                assert (a.float() - r.float()).abs().max().item() <= _bound(r, dt), (frames, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,m,n", [(4, 49, 7197), (16, 49, 1401), (4, 64, 7177), (16, 64, 1385),
                                    (16, 49, 2989), (4, 49, 7399), (16, 49, 1519)])
def test_cuda_key_tiled_backward_matches_twin_and_repeats_exactly(cuda_device, hd, m, n):
    """The backward above its old key limits (the first N past each, the
    far rows, and the flagship's 31 buffer frames at level 2): the tiled
    backward counted as key tiles, f32 and bf16, within the gates of
    attn_core_backward_reference, two runs bit for bit."""
    heads, b_ = 16, 5
    c = heads * hd
    plan = wac.attn_core_bwd_plan(m, n, c, heads)
    assert plan.key_tiles and not plan.row_share
    g = torch.Generator(device=cuda_device).manual_seed(n)
    f = lambda *s: torch.randn(*s, generator=g, device=cuda_device)
    q, k, v, gr, bias = f(b_, m, c), f(b_, n, c), f(b_, n, c), f(b_, m, c), f(heads, m, n) * 0.5
    for dt in (torch.float32, torch.bfloat16):
        ins = [t.to(dt) for t in (q, k, v)]
        before = dict(launch_counts)
        got = attn_core_backward(*ins, bias, gr.to(dt), heads)
        again = attn_core_backward(*ins, bias, gr.to(dt), heads)
        torch.cuda.synchronize()
        assert _launched(before) == {"attn_core_backward_key_tiles": 2}
        ref = attn_core_backward_reference(*ins, bias, gr.to(dt), heads)
        for a, b, r in zip(got, again, ref):
            assert torch.equal(a, b)
            assert (a.float() - r.float()).abs().max().item() <= _bound(r, dt), dt


@pytest.mark.cuda
@pytest.mark.parametrize("win,c", [((7, 7), 256), ((7, 7), 64), ((8, 8), 256)])
def test_cuda_key_tiled_blocks_train_on_the_kernel_path(cuda_device, win, c):
    """Fault C5: a flagship-width block over 31 buffer frames (buffer_index
    -15..15) forward and backward on the kernel path vs the unfused path:
    at head_dim 16 both attention kernels run key-tiled (7x7: the Swin
    block; 8x8 dilated: the WindowAttention3D body), at head_dim 4 the
    forward stages whole windows and the backward takes long rows; outputs
    within 2e-4, gradients within 1e-3 relative."""
    torch.manual_seed(9)
    frames = 31
    h, w = 2 * win[0], 2 * win[1]
    x = torch.randn(frames, 1, h, w, c, device=cuda_device)
    for dilate in (False, True):
        blk = twa.SwinTransformerBlock3D(c, 16, (frames, *win), dilate_win=dilate,
                                         use_kernel=True).to(cuda_device)
        fwd = "fused_window_block" if dilate and win[0] % 2 == 0 else "fused_swin_block"
        plan_f = wac.attn_forward_plan(1, 16, win[0] * win[1], frames * win[0] * win[1], c // 16, 132, 1)
        plan_b = wac.attn_core_bwd_plan(win[0] * win[1], frames * win[0] * win[1], c, 16)
        outs, grads = [], []
        for kernel in (True, False):
            twa.set_attention_kernel(blk, kernel)
            blk.zero_grad(set_to_none=True)
            xl = x.clone().requires_grad_()
            before = dict(launch_counts)
            out = blk(xl)
            out.square().mean().backward()
            torch.cuda.synchronize()
            if kernel:
                assert _launched(before) == {fwd + ("_key_tiles" if plan_f.key_tiled else ""): 1,
                                             wac.bwd_counter(plan_b, c // 16): 1}
            else:
                assert _launched(before) == {}
            outs.append(out.detach())
            grads.append({"x": xl.grad, **{k: p.grad for k, p in blk.named_parameters()}})
        assert (outs[0] - outs[1]).abs().max().item() <= 2e-4
        for key, gu in grads[1].items():
            gk = grads[0][key]
            if key == "attn.kv.bias":
                gk, gu = gk[c:], gu[c:]  # the key half is analytically zero
            rel = (gk - gu).abs().max().item() / max(gu.abs().max().item(), 1e-30)
            assert rel <= 1e-3, (key, dilate, rel)
    assert plan_f.key_tiled == plan_b.key_tiles == (c == 256)


@pytest.mark.cuda
@pytest.mark.parametrize("lib", ["window_attention", "swin_block", "window_block"])
def test_cuda_key_tiled_forward_occupancy_and_smem_are_the_plans(cuda_device, lib):
    """Where the plan picks key tiles, the occupancy query reports the
    tiled instantiation (its key tile, its threads, the shared memory the
    library's query gives for a key-tiled launch) and the shared memory
    does not grow with N."""
    index = torch.cuda.current_device()
    lib_ = wac._lib("window_attention")
    for hd, n in ((16, 2989), (4, 7399)):
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            occ = wac.attn_forward_occupancy(lib, 49, n, 16 * hd, 16, dt, index)
            assert wac.attn_key_tiled(49, n, hd, bf16)
            assert occ["key_tile"] in (16, 32, 64) and occ["blocks_per_sm"] >= 1
            smem = lib_.window_attention_smem_bytes(int(bf16), 49, n, 16 * hd, 16, 1)
            assert occ["smem_bytes"] == smem <= wac._MAX_SMEM
            assert smem == lib_.window_attention_smem_bytes(int(bf16), 49, 2 * n, 16 * hd, 16, 1)
            assert occ["threads"] == wac.FLASH_THREADS
            plan = wac.attn_plan_for(lib, 3, 49, n, 16 * hd, 16, dt, index)
            assert plan.key_tiled and plan.threads == wac.FLASH_THREADS


# Head dims between and above the instantiated ones (ROADMAP C6 and C7,
# repaired): each runs at the next instantiated head_dim with zero columns
# past its own; above 32 the forward takes the key-tiled kernel (above 256
# the wide forward) and the backward the wide backward. Heads per head_dim,
# so that C stays at most 256 up to head_dim 256 (one head above it).
_HEAD_DIM_HEADS = {3: 16, 6: 16, 12: 16, 24: 8, 48: 4, 64: 4, 96: 2, 128: 2, 256: 1, 384: 1, 512: 1,
                   1024: 1, 1536: 1, 2048: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", sorted(_HEAD_DIM_HEADS))
def test_cuda_forward_libraries_match_twins_at_each_head_dim(cuda_device, hd):
    """The bare core, the Swin block and the WindowAttention3D body (with
    acc) at head_dim 3 to 2048 (above 256 the wide forward, and above 1024
    B1's and B3's LN GEMMs streaming their rows: ROADMAP C8 and C9), M 49
    and N 147, f32 and bf16: each matches its twin, repeats bit for bit and
    counts the variant its plan names (key-tiled exactly from head_dim 33 to
    256, wide above)."""
    heads, m, d, b_ = _HEAD_DIM_HEADS[hd], 49, 3, 5
    c = heads * hd
    q, k, v, bias = _attn_inputs(hd, b_, m, d * m, c, heads, cuda_device)
    x, ctr, p = _flat_inputs(hd, d, b_, m, c, heads, cuda_device)
    pb = _block_params(p)
    for dt in (torch.float32, torch.bfloat16):
        plan = wac.attn_forward_plan(b_, heads, m, d * m, hd, 132, 1, dt == torch.bfloat16)
        assert plan.key_tiled == (32 < hd <= 256) and plan.wide == (hd > 256)
        ins = [t.to(dt) for t in (q, k, v)]
        xd, cd = x.to(dt), ctr.to(dt)
        cases = (
            ("fused_window_attention", lambda: (fused_window_attention(*ins, bias, heads),),
             lambda: (window_attention_reference(*ins, bias, heads),)),
            ("fused_swin_block", lambda: fused_swin_block(xd, cd, p, heads, 1, with_acc=True),
             lambda: swin_block_reference(xd, cd, p, heads, 1, with_acc=True)),
            ("fused_window_block", lambda: fused_window_block(xd, pb, heads, 1, with_acc=True),
             lambda: window_block_reference(xd, pb, heads, 1, with_acc=True)),
        )
        for name, fn, twin in cases:
            before = dict(launch_counts)
            got, again, ref = fn(), fn(), twin()
            torch.cuda.synchronize()
            assert _launched(before) == {wac.fwd_counter(name, plan): 2}, (name, dt)
            for a, b, r in zip(got, again, ref):
                assert torch.equal(a, b), (name, dt)
                assert (a.float() - r.float()).abs().max().item() <= _bound(r, dt), (name, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", sorted(_HEAD_DIM_HEADS))
def test_cuda_backward_matches_twin_at_each_head_dim(cuda_device, hd):
    """The attention backward at head_dim 3 to 2048, N 147 and 1519, f32 and
    bf16: within the gates of attn_core_backward_reference, two runs bit
    for bit, the wide kernel counted above head_dim 32."""
    heads, m, b_ = _HEAD_DIM_HEADS[hd], 49, 5
    c = heads * hd
    for n in (147, 1519):
        plan = wac.attn_core_bwd_plan(m, n, c, heads)
        counter = wac.bwd_counter(plan, hd)
        assert (counter == "attn_core_backward_wide") == (hd > 32)
        q, k, v, bias = _attn_inputs(n + hd, b_, m, n, c, heads, cuda_device)
        gr = torch.randn(b_, m, c, device=cuda_device)
        for dt in (torch.float32, torch.bfloat16):
            ins = [t.to(dt) for t in (q, k, v)]
            before = dict(launch_counts)
            got = attn_core_backward(*ins, bias, gr.to(dt), heads)
            again = attn_core_backward(*ins, bias, gr.to(dt), heads)
            torch.cuda.synchronize()
            assert _launched(before) == {counter: 2}
            ref = attn_core_backward_reference(*ins, bias, gr.to(dt), heads)
            for a, b, r in zip(got, again, ref):
                assert torch.equal(a, b)
                assert (a.float() - r.float()).abs().max().item() <= _bound(r, dt), (n, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,heads", [(36, 2), (64, 4), (512, 1)])
def test_cuda_wide_backward_past_one_row_tile(cuda_device, hd, heads):
    """The wide backward where a window's rows span several of its row
    tiles (M 81 and 130: 9x9 windows, and more rows than two tiles of 64)
    and its keys a ragged last tile (N 567 and 130), with head_dim 36
    (bf16 rows not whole 16-byte chunks: plain copies), 64 and 512, f32 and
    bf16: within the gates of attn_core_backward_reference, two runs bit for
    bit."""
    c, b_ = heads * hd, 3
    for m, n in ((81, 567), (130, 130)):
        q, k, v, bias = _attn_inputs(m + hd, b_, m, n, c, heads, cuda_device)
        gr = torch.randn(b_, m, c, device=cuda_device)
        for dt in (torch.float32, torch.bfloat16):
            ins = [t.to(dt) for t in (q, k, v)]
            before = dict(launch_counts)
            got = attn_core_backward(*ins, bias, gr.to(dt), heads)
            again = attn_core_backward(*ins, bias, gr.to(dt), heads)
            torch.cuda.synchronize()
            assert _launched(before) == {"attn_core_backward_wide": 2}
            ref = attn_core_backward_reference(*ins, bias, gr.to(dt), heads)
            for a, b, r in zip(got, again, ref):
                assert torch.equal(a, b)
                assert (a.float() - r.float()).abs().max().item() <= _bound(r, dt), (m, n, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,m,n", [(4, 81, 1029), (16, 128, 1100), (32, 100, 1500)])
def test_cuda_tiled_backward_past_four_row_warps(cuda_device, hd, m, n):
    """The tiled backward where a window has more than 64 rows (9x9 windows
    and up to its 128: six to eight row warps of its keys kernel, rows
    kernel blocks past the first) and a ragged last key tile, f32 and bf16:
    within the gates of attn_core_backward_reference, two runs bit for bit."""
    heads, b_ = 4, 3
    c = heads * hd
    plan = wac.attn_core_bwd_plan(m, n, c, heads)
    assert not plan.row_share
    counter = wac.bwd_counter(plan, hd)
    q, k, v, bias = _attn_inputs(m + hd, b_, m, n, c, heads, cuda_device)
    gr = torch.randn(b_, m, c, device=cuda_device)
    for dt in (torch.float32, torch.bfloat16):
        ins = [t.to(dt) for t in (q, k, v)]
        before = dict(launch_counts)
        got = attn_core_backward(*ins, bias, gr.to(dt), heads)
        again = attn_core_backward(*ins, bias, gr.to(dt), heads)
        torch.cuda.synchronize()
        assert _launched(before) == {counter: 2}
        ref = attn_core_backward_reference(*ins, bias, gr.to(dt), heads)
        for a, b, r in zip(got, again, ref):
            assert torch.equal(a, b)
            assert (a.float() - r.float()).abs().max().item() <= _bound(r, dt), (m, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,n", [(4, 432), (16, 432), (4, 1029), (16, 1029), (32, 432)])
def test_cuda_tiled_backward_past_128_rows(cuda_device, hd, n):
    """The tiled backward at M 144 (window_size (12, 12); T=3 gives N 432),
    past its keys kernel's 128 rows a block: two row groups of 80 and 64
    rows, dk and dv summed over them through the scratch, f32 and bf16,
    within the gates of attn_core_backward_reference, two runs bit for bit."""
    heads, b_, m = 4, 3, 144
    c = heads * hd
    plan = wac.attn_core_bwd_plan(m, n, c, heads)
    assert not plan.row_share and wac.tiled_keys_rows(m) == (5, 80)
    counter = wac.bwd_counter(plan, hd)
    q, k, v, bias = _attn_inputs(m + n + hd, b_, m, n, c, heads, cuda_device)
    gr = torch.randn(b_, m, c, device=cuda_device)
    for dt in (torch.float32, torch.bfloat16):
        ins = [t.to(dt) for t in (q, k, v)]
        before = dict(launch_counts)
        got = attn_core_backward(*ins, bias, gr.to(dt), heads)
        again = attn_core_backward(*ins, bias, gr.to(dt), heads)
        torch.cuda.synchronize()
        assert _launched(before) == {counter: 2}
        ref = attn_core_backward_reference(*ins, bias, gr.to(dt), heads)
        for a, b, r in zip(got, again, ref):
            assert torch.equal(a, b)
            assert (a.float() - r.float()).abs().max().item() <= _bound(r, dt), (n, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 16])
def test_cuda_blocks_at_c2048_match_twins(cuda_device, heads):
    """B1 and B3 at C 2048 (head_dim 256 and 128; ROADMAP C9, repaired):
    their LN GEMMs stream the rows that no longer fit resident, f32 and
    bf16 (B1's LN2 -> MLP with its f32 y rows), matching the twins bit for
    bit on repeat; the attention on the key-tiled forward's counter."""
    m, d, b_, c = 49, 3, 4, 2048
    x, ctr, p = _flat_inputs(heads, d, b_, m, c, heads, cuda_device)
    pb = _block_params(p)
    for dt in (torch.float32, torch.bfloat16):
        plan = wac.attn_forward_plan(b_, heads, m, d * m, c // heads, 132, 1, dt == torch.bfloat16)
        assert plan.key_tiled
        xd, cd = x.to(dt), ctr.to(dt)
        for name, fn, twin in (
                ("fused_swin_block", lambda: fused_swin_block(xd, cd, p, heads, 1, with_acc=True),
                 lambda: swin_block_reference(xd, cd, p, heads, 1, with_acc=True)),
                ("fused_window_block", lambda: fused_window_block(xd, pb, heads, 1, with_acc=True),
                 lambda: window_block_reference(xd, pb, heads, 1, with_acc=True))):
            before = dict(launch_counts)
            got, again, ref = fn(), fn(), twin()
            torch.cuda.synchronize()
            assert _launched(before) == {wac.fwd_counter(name, plan): 2}, (name, dt)
            for a, b, r in zip(got, again, ref):
                assert torch.equal(a, b), (name, dt)
                assert (a.float() - r.float()).abs().max().item() <= _bound(r, dt), (name, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 256, 384, 512])
def test_cuda_key_tiled_forward_at_large_head_dims(cuda_device, hd):
    """The key-tiled forward at head_dim 64 to 256, and the wide forward
    at 384 and 512, over rows of 343, 1519 and 2989 keys (7, 31 and 61
    frames of 7x7 windows), two heads, f32 and bf16, repeated bit for bit."""
    heads = 2
    for n in (343, 1519, 2989):
        q, k, v, bias = _attn_inputs(n, 3, 49, n, heads * hd, heads, cuda_device)
        for dt in (torch.float32, torch.bfloat16):
            ins = [t.to(dt) for t in (q, k, v)]
            before = dict(launch_counts)
            got = fused_window_attention(*ins, bias, heads)
            again = fused_window_attention(*ins, bias, heads)
            ref = window_attention_reference(*ins, bias, heads)
            torch.cuda.synchronize()
            want = "fused_window_attention" + ("_wide" if hd > 256 else "_key_tiles")
            assert _launched(before) == {want: 2}
            assert torch.equal(got, again)
            assert (got.float() - ref.float()).abs().max().item() <= _bound(ref, dt), (n, dt)


# The wide forward above head_dim 256 (attn_wide_scores_kernel and
# attn_wide_out_kernel): head dims whose rows are no whole 64-column chunks
# (257, 300, 2049: no 16-byte copies in bf16, none at all at 257 and 2049)
# and whole ones (384, 1024), one head.
_WIDE_HEAD_DIMS = (257, 300, 384, 1024, 2049)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", _WIDE_HEAD_DIMS)
def test_cuda_wide_forward_matches_twin_and_repeats_exactly(cuda_device, hd):
    """The bare core on the wide forward at M 49, 64 and 144 (one to five
    row tiles of its two launches) against N 147, 343 and 1519 (ragged last
    key tiles), f32 and bf16: within the kernel-vs-twin gates, two runs bit
    for bit, exactly one launch a call on its own counter."""
    b_ = 3
    for m, n in ((49, 147), (64, 343), (144, 1519)):
        q, k, v, bias = _attn_inputs(hd + m + n, b_, m, n, hd, 1, cuda_device)
        for dt in (torch.float32, torch.bfloat16):
            assert wac.attn_forward_plan(b_, 1, m, n, hd, 132, 1, dt == torch.bfloat16).wide
            ins = [t.to(dt) for t in (q, k, v)]
            before = dict(launch_counts)
            got = fused_window_attention(*ins, bias, 1)
            again = fused_window_attention(*ins, bias, 1)
            torch.cuda.synchronize()
            assert _launched(before) == {"fused_window_attention_wide": 2}, (m, n, dt)
            ref = window_attention_reference(*ins, bias, 1)
            assert torch.equal(got, again), (m, n, dt)
            assert (got.float() - ref.float()).abs().max().item() <= _bound(ref, dt), (m, n, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", _WIDE_HEAD_DIMS)
@pytest.mark.parametrize("lib", ["swin_block", "window_block"])
def test_cuda_wide_forward_as_the_block_attention_stage(cuda_device, hd, lib):
    """B1's and B3's attention stage on the wide forward (k and v in the k|v
    scratch): windows of 49 rows over 3 and 7 frames (N 147, 343) and of 144
    rows (12x12) over 3 (N 432), f32 and bf16, with acc: within the gates of
    the twins, two runs bit for bit, exactly one launch a call on the
    library's wide counter."""
    b_ = 2
    for m, frames in ((49, 3), (49, 7), (144, 3)):
        x, ctr, p = _flat_inputs(hd + m + frames, frames, b_, m, hd, 1, cuda_device)
        for dt in (torch.float32, torch.bfloat16):
            xd, cd = x.to(dt), ctr.to(dt)
            before = dict(launch_counts)
            if lib == "swin_block":
                fn = lambda: fused_swin_block(xd, cd, p, 1, frames // 2, with_acc=True)
                ref = swin_block_reference(xd, cd, p, 1, frames // 2, with_acc=True)
            else:
                pb = _block_params(p)
                fn = lambda: fused_window_block(xd, pb, 1, frames // 2, with_acc=True)
                ref = window_block_reference(xd, pb, 1, frames // 2, with_acc=True)
            got, again = fn(), fn()
            torch.cuda.synchronize()
            assert _launched(before) == {f"fused_{lib}_wide": 2}, (m, frames, dt)
            for a, b, r in zip(got, again, ref):
                assert torch.equal(a, b), (m, frames, dt)
                assert (a.float() - r.float()).abs().max().item() <= _bound(r, dt), (m, frames, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("lib", ["window_attention", "swin_block", "window_block"])
def test_cuda_wide_forward_scratch_and_occupancy(cuda_device, lib):
    """The wrappers' scratch size (attn_forward_scratch_floats) is the
    library's own (window_attention_scratch_floats: WideFwdPlanes::floats)
    above head_dim 256 and 0 at and below it; the occupancy query reports
    the wide forward's blocks (its threads, the scores tile's 32 keys, the
    shared memory the library's query gives, which grows with nothing)."""
    index = torch.cuda.current_device()
    lib_ = wac._lib("window_attention")
    for b_, m, n, c, heads in ((20, 49, 343, 384, 1), (3, 144, 1519, 2049, 1), (5, 64, 448, 1024, 2),
                               (20, 49, 343, 256, 1), (20, 49, 343, 128, 1), (7, 49, 147, 64, 4)):
        assert lib_.window_attention_scratch_floats(b_, m, n, c, heads) == \
            wac.attn_forward_scratch_floats(b_, heads, m, n, c // heads)
    for hd, n in ((300, 343), (2049, 1519)):
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            occ = wac.attn_forward_occupancy(lib, 49, n, hd, 1, dt, index)
            assert occ["threads"] == wac.WIDE_THREADS and occ["key_tile"] == 32
            assert occ["blocks_per_sm"] >= 1 and occ["spill_bytes"] == 0
            smem = lib_.window_attention_smem_bytes(int(bf16), 49, n, hd, 1, 0)
            assert occ["smem_bytes"] == smem <= wac._MAX_SMEM
            assert smem == lib_.window_attention_smem_bytes(int(bf16), 144, 2 * n, 2 * hd, 1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dilate", [False, True])
def test_cuda_four_head_block_at_c256_trains_on_the_kernel_path(cuda_device, dilate):
    """A 4-head block at C 256 (head_dim 64, the flagship's level 2 with
    num_heads 4) over 7 frames of 7x7 windows, forward and backward on the
    kernel path (the key-tiled forward, the wide backward) vs the unfused
    path: outputs within 2e-4, gradients within 1e-3 relative."""
    torch.manual_seed(4)
    c, frames, win = 256, 7, (7, 7)
    x = torch.randn(frames, 1, 14, 14, c, device=cuda_device)
    blk = twa.SwinTransformerBlock3D(c, 4, (frames, *win), dilate_win=dilate,
                                     use_kernel=True).to(cuda_device)
    outs, grads = [], []
    for kernel in (True, False):
        twa.set_attention_kernel(blk, kernel)
        blk.zero_grad(set_to_none=True)
        xl = x.clone().requires_grad_()
        before = dict(launch_counts)
        out = blk(xl)
        out.square().mean().backward()
        torch.cuda.synchronize()
        want = {"fused_swin_block_key_tiles": 1, "attn_core_backward_wide": 1} if kernel else {}
        assert _launched(before) == want
        outs.append(out.detach())
        grads.append({"x": xl.grad, **{k: p.grad for k, p in blk.named_parameters()}})
    assert (outs[0] - outs[1]).abs().max().item() <= 2e-4
    for key, gu in grads[1].items():
        gk = grads[0][key]
        if key == "attn.kv.bias":
            gk, gu = gk[c:], gu[c:]  # the key half is analytically zero
        rel = (gk - gu).abs().max().item() / max(gu.abs().max().item(), 1e-30)
        assert rel <= 1e-3, (key, rel)


@pytest.mark.cuda
def test_cuda_prefetch_hands_over_finished_tensors(cuda_device):
    """The prefetch thread assembles on its own stream, each item behind a
    chain of GEMMs that keeps that stream busy: the consumer's stream waits
    for the item's event, so it reads every item whole, and nothing of the
    thread is left after the consumer stops early."""
    import threading

    from bde2vid_tpu_torch.data.prefetch import Prefetcher

    eye = torch.eye(2048, device=cuda_device)

    def items():
        k = 0
        while True:
            x = torch.full((2048, 2048), float(k), device=cuda_device)
            for _ in range(16):
                x = x @ eye
            yield x, {"k": torch.tensor(k, device=cuda_device)}
            k += 1

    with Prefetcher(items(), size=2, device=cuda_device) as pf:
        for k in range(6):
            x, extra = next(pf)
            assert int(extra["k"]) == k
            assert torch.equal(x, torch.full_like(x, float(k)))
    assert not [t for t in threading.enumerate() if t.name == "prefetch"]


def _seeded_lpips(net, seed):
    """An LPIPS network on the CPU with seeded weights marked as loaded."""
    from bde2vid_tpu_torch.metrics.lpips import LPIPS

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = LPIPS(net)
        for w in module.lin_weights():
            torch.nn.init.uniform_(w)
    module.load_state_dict(module.state_dict())
    return module.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_cuda_lpips_matches_cpu_at_180x240(cuda_device, net):
    """LPIPS (cuDNN convolutions, no hand-written kernel) on the card vs the
    CPU at 180x240: within 1e-5 relative (max |diff| over max |CPU|)."""
    import copy

    from bde2vid_tpu_torch.metrics.lpips import to_pm1_3ch

    cpu = _seeded_lpips(net, 5)
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(6)
    pred, gt = (torch.from_numpy(rng.uniform(size=(3, 1, 180, 240)).astype(np.float32))
                for _ in range(2))
    before = dict(launch_counts)
    with torch.no_grad():
        want = cpu(to_pm1_3ch(gt, True), to_pm1_3ch(pred, True))
        got = card(to_pm1_3ch(gt.to(cuda_device), True), to_pm1_3ch(pred.to(cuda_device), True))
    assert _launched(before) == {}
    assert got.shape == (3,) and torch.isfinite(got).all()
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_cuda_flagship_perceptual_loss_step_on_the_kernel_path(cuda_device):
    """A flagship train step (base 32, depths [4, 0, 6], 16 heads, 7x7; T=3
    at 184x240) with [L1, PerceptualLoss]: the kernel path's loss and
    gradients within 1e-3 relative of the unfused path's, with exactly 10
    B1 and 10 B2 launches a frame; LPIPS launches no kernel. (At 96x128 two
    runs of one path gave the head conv's weight gradients 1.3e-3 to 2.0e-3
    apart on an H100, L1 alone, without deterministic algorithms, and the
    kernel path's 3.8e-3 from the unfused path's with them; at 184x240 5e-7
    and 1.5e-5: ROADMAP Queue C, C11.)"""
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.train import SequenceLossComputer

    gen = {"num_bins": 5, "basechannels": 32, "num_encoders": 3, "ks": 5, "num_res_blocks": 2,
           "buffer_index": [-3, -2, -1, 0, 1, 2, 3], "depths": [4, 0, 6], "num_heads": 16,
           "window_size": [7, 7], "drop_path_rate": 0.0}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = build_model("BDE2VID", {"generator": gen, "use_pallas_attention": True},
                            device=cuda_device, train=True)
    comp = SequenceLossComputer([{"type": "L1Loss"}, {"type": "PerceptualLoss"}],
                                lpips=_seeded_lpips("alex", 7).to(cuda_device))
    rng = np.random.default_rng(8)
    t = 3
    vox = torch.from_numpy(rng.normal(size=(t, 1, 5, 184, 240)).astype(np.float32)).to(cuda_device)
    tgt = torch.from_numpy(rng.uniform(size=(t, 1, 1, 184, 240)).astype(np.float32)).to(cuda_device)
    runs = []
    for kernel in (True, False):
        twa.set_attention_kernel(model, kernel)
        model.zero_grad(set_to_none=True)
        before = dict(launch_counts)
        loss, parts = comp(model(vox)["image"], tgt)
        loss.backward()
        torch.cuda.synchronize()
        want = {"fused_swin_block": 10 * t, "attn_core_backward": 10 * t} if kernel else {}
        assert _launched(before) == want
        assert parts["L_PL"].item() > 0
        runs.append((loss.item(), {k: p.grad for k, p in model.named_parameters()
                                   if p.grad is not None}))
    (loss_k, grads_k), (loss_u, grads_u) = runs
    assert abs(loss_k - loss_u) <= 1e-3 * abs(loss_u)
    assert set(grads_k) == set(grads_u)
    for key, gu in grads_u.items():
        gk = grads_k[key]
        if key.endswith("attn.kv.bias"):
            c = gu.shape[0] // 2
            assert max(gk[:c].abs().max().item(), gu[:c].abs().max().item()) <= 1e-5, key
            gk, gu = gk[c:], gu[c:]  # the key half is analytically zero
        rel = (gk - gu).abs().max().item() / max(gu.abs().max().item(), 1e-30)
        assert rel <= 1e-3, (key, rel)


@pytest.mark.cuda
def test_cuda_flagship_step_repeats_bit_for_bit_at_96x128_deterministic(cuda_device, monkeypatch):
    """The flagship train step of the test above at 96x128, T=3, [L1,
    PerceptualLoss], under ``torch.use_deterministic_algorithms``
    and ``cudnn.deterministic``: two runs of each path (kernel and unfused)
    give bit-equal losses and gradients, with 30 B1 + 30 B2 launches a
    kernel run. Without deterministic algorithms two runs of one path lie
    1.3e-3 to 2.0e-3 apart (relative) in the head conv's weight gradient
    there, whose terms cancel: library nondeterminism (ROADMAP Queue C,
    C11)."""
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.train import SequenceLossComputer

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    gen = {"num_bins": 5, "basechannels": 32, "num_encoders": 3, "ks": 5, "num_res_blocks": 2,
           "buffer_index": [-3, -2, -1, 0, 1, 2, 3], "depths": [4, 0, 6], "num_heads": 16,
           "window_size": [7, 7], "drop_path_rate": 0.0}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = build_model("BDE2VID", {"generator": gen, "use_pallas_attention": True},
                            device=cuda_device, train=True)
    comp = SequenceLossComputer([{"type": "L1Loss"}, {"type": "PerceptualLoss"}],
                                lpips=_seeded_lpips("alex", 7).to(cuda_device))
    rng = np.random.default_rng(8)
    t = 3
    vox = torch.from_numpy(rng.normal(size=(t, 1, 5, 96, 128)).astype(np.float32)).to(cuda_device)
    tgt = torch.from_numpy(rng.uniform(size=(t, 1, 1, 96, 128)).astype(np.float32)).to(cuda_device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for kernel in (True, False):
            twa.set_attention_kernel(model, kernel)
            runs = []
            for _ in range(2):
                model.zero_grad(set_to_none=True)
                before = dict(launch_counts)
                loss, _ = comp(model(vox)["image"], tgt)
                loss.backward()
                torch.cuda.synchronize()
                want = {"fused_swin_block": 10 * t, "attn_core_backward": 10 * t} if kernel else {}
                assert _launched(before) == want
                runs.append((loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()
                                           if p.grad is not None}))
            (loss_a, grads_a), (loss_b, grads_b) = runs
            assert loss_a == loss_b and grads_a.keys() == grads_b.keys()
            for key, g in grads_a.items():
                assert torch.equal(g, grads_b[key]), (kernel, key)
    finally:
        torch.use_deterministic_algorithms(False)


_BUNDLE_GEN = {"num_bins": 5, "basechannels": 32, "num_encoders": 3, "ks": 5, "num_res_blocks": 2,
               "buffer_index": [-3, -2, -1, 0, 1, 2, 3], "depths": [4, 0, 6], "num_heads": 16}


@pytest.mark.cuda
@pytest.mark.parametrize("win,per_frame", [((7, 7), {"fused_swin_block": 10}),
                                           ((8, 8), {"fused_swin_block": 5,
                                                     "fused_window_block": 5})])
def test_cuda_kernel_path_bundle_matches_eager_and_launches_per_frame(cuda_device, tmp_path, win,
                                                                      per_frame):
    """A bundle of the flagship widths (and of its 8x8 config) exported on
    the kernel path, saved and loaded, runs B1 (and B3 on the even dilated
    blocks) through the registered operators: the launches a frame of the
    eager forward, one operator node a block a frame, and the eager eval
    forward's images within 2e-4 (they differ in the last bit at 96x128
    even under deterministic algorithms: the exported graph's matmuls of
    the uncovered pixels' MLP are not eager's), for the full chunk and the
    1-frame tail (96x128, T=2)."""
    from bde2vid_tpu_torch.models import ModelSpec, build_model
    from bde2vid_tpu_torch.serving import export_spec_bundle, load_bundle, run_voxels, save_bundle

    torch.manual_seed(0)
    cfg = {"generator": dict(_BUNDLE_GEN, window_size=list(win)), "use_pallas_attention": True}
    spec = ModelSpec("BDE2VID", build_model("BDE2VID", cfg, device=cuda_device), 5, 3, True)
    path = str(tmp_path / "b.zip")
    save_bundle(path, export_spec_bundle(spec, 96, 128, seq_len=2, platforms=("cuda",)))
    bundle = load_bundle(path)
    blocks = {"fused_swin_block": "swin_block", "fused_window_block": "window_block"}
    for name, t in (("forward", 2), ("forward_tail_1", 1)):
        targets = [str(n.target) for n in bundle.functions[name].graph.nodes]
        for counter, op in blocks.items():
            assert targets.count(f"bde2vid_torch.{op}.default") == per_frame.get(counter, 0) * t
    vox = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 1, 5, 96, 128))
                           .astype(np.float32)).to(cuda_device)
    for t in (2, 1):
        with torch.no_grad():
            want = spec.module(vox[:t])["image"]
        before = dict(launch_counts)
        got = run_voxels(bundle, vox[:t])
        torch.cuda.synchronize()
        assert _launched(before) == {k: n * t for k, n in per_frame.items()}
        np.testing.assert_allclose(got, want.cpu().numpy(), atol=2e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_bundle_refuses_a_process_without_cuda(cuda_device, tmp_path):
    """A bundle exported on the card loads only where CUDA is: with the cards
    hidden, ``load_bundle`` raises and nothing runs on the CPU."""
    import os
    import subprocess
    import sys

    from bde2vid_tpu_torch.models import ModelSpec, build_model
    from bde2vid_tpu_torch.serving import export_spec_bundle, save_bundle

    cfg = {"generator": {"num_bins": 5, "basechannels": 8, "num_encoders": 2, "ks": 3,
                         "buffer_index": [-1, 0, 1], "depths": [1, 1], "num_heads": 2,
                         "window_size": [4, 4]}, "use_pallas_attention": True}
    spec = ModelSpec("BDE2VID", build_model("BDE2VID", cfg, device=cuda_device), 5, 2, True)
    path = str(tmp_path / "b.zip")
    save_bundle(path, export_spec_bundle(spec, 32, 48, seq_len=2))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\nsys.path.insert(0, sys.argv[1])\n"
            "from bde2vid_tpu_torch.serving import load_bundle\n"
            "try:\n    load_bundle(sys.argv[2])\nexcept RuntimeError as e:\n"
            "    print('refused:', e)\n    sys.exit(0)\nsys.exit(1)\n")
    res = subprocess.run([sys.executable, "-c", code, root, path], capture_output=True, text=True,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0 and "exported for cuda" in res.stdout, res.stdout + res.stderr


_SCALE_OUT_CFG = {"generator": {"num_bins": 5, "basechannels": 8, "num_encoders": 2, "ks": 3,
                                 "num_res_blocks": 1, "buffer_index": [-1, 0, 1],
                                 "depths": [2, 2], "num_heads": 4, "window_size": [7, 7],
                                 "drop_path_rate": 0.0},
                   "use_pallas_attention": True}


def _scale_out_folder(tmp_path, case, model):
    import json

    folder = tmp_path / case
    folder.mkdir()
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, folder / "model.pt")
    (folder / "model.json").write_text(json.dumps({"name": "BDE2VID", "config": _SCALE_OUT_CFG,
                                                   "train": True}))
    return folder


@pytest.mark.cuda
def test_cuda_scale_out_dp_train_step_matches_one_process(cuda_device, tmp_path):
    """Two ranks on one gloo group on the card, a row of a batch of 2 each,
    run ``make_dp_train_step`` (no clip) through B1 and B2: the loss within
    1e-6, Adam's first moments (0.1 g: a gradient averaged wrongly is off
    by 0.5 or more) within 1e-2 and the weights within 1e-3 (the relative
    L2 of all of them) of one process's step on the whole batch, and each
    rank's launches those of the one-process step."""
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.train import SequenceLossComputer, train_step
    from tests.torch_scale_out_ranks import spawn_group

    torch.manual_seed(0)
    model = build_model("BDE2VID", _SCALE_OUT_CFG, device=cuda_device, train=True)
    folder = _scale_out_folder(tmp_path, "cuda_dp_step", model)
    rng = np.random.default_rng(2)
    vox = torch.from_numpy(rng.normal(size=(3, 2, 5, 56, 56)).astype(np.float32))
    tgt = torch.from_numpy(rng.uniform(size=(3, 2, 1, 56, 56)).astype(np.float32))
    torch.save({"voxels": vox, "frames": tgt}, folder / "batch.pt")
    spawn_group(tmp_path, ["cuda_dp_step"], ranks=2)

    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    before = dict(launch_counts)
    want = train_step(model, opt, SequenceLossComputer([{"type": "L1Loss"}]), vox.cuda(),
                      tgt.cuda())
    torch.cuda.synchronize()
    moments = {k: opt.state[p]["exp_avg"].cpu() for k, p in model.named_parameters()
               if p in opt.state}
    launched = _launched(before)
    assert launched == {"fused_swin_block": 12, "attn_core_backward": 12}
    for r in range(2):
        got = torch.load(folder / f"rank{r}.pt")
        assert {k: v for k, v in got["launches"].items() if v} == launched
        assert abs(got["loss"] - want["loss"].item()) <= 1e-6 * abs(want["loss"].item())
        keys = [k for k, v in model.state_dict().items() if v.is_floating_point()]
        diff = torch.cat([(got["state"][k] - model.state_dict()[k].cpu()).flatten() for k in keys])
        norm = torch.cat([model.state_dict()[k].cpu().flatten() for k in keys]).norm()
        assert diff.norm() <= 1e-3 * norm
        assert got["moments"].keys() == moments.keys()
        diff = torch.cat([(got["moments"][k] - v).flatten() for k, v in moments.items()])
        assert diff.norm() <= 1e-2 * torch.cat([v.flatten() for v in moments.values()]).norm()


@pytest.mark.cuda
def test_cuda_scale_out_dp_bundle_matches_the_live_forward(cuda_device, tmp_path):
    """A kernel-path bundle exported at batch 2 with ``data_parallel`` 2,
    run by two ranks on one gloo group on the card: every rank returns the
    whole batch, within 2e-4 of the eager forward (the tolerance of the
    one-card bundle test), each rank launching B1 for its own row."""
    from bde2vid_tpu_torch.models import ModelSpec, build_model
    from bde2vid_tpu_torch.serving import export_spec_bundle, save_bundle
    from tests.torch_scale_out_ranks import spawn_group

    torch.manual_seed(1)
    model = build_model("BDE2VID", _SCALE_OUT_CFG, device=cuda_device).eval()
    folder = tmp_path / "cuda_serving"
    folder.mkdir()
    spec = ModelSpec("BDE2VID", model, 5, 2, True)
    save_bundle(str(folder / "bundle.zip"),
                export_spec_bundle(spec, 56, 56, seq_len=2, batch=2, data_parallel=2))
    vox = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 2, 5, 56, 56))
                           .astype(np.float32))
    torch.save(vox, folder / "voxels.pt")
    spawn_group(tmp_path, ["cuda_serving"], ranks=2)
    with torch.no_grad():
        want = model(vox.cuda())["image"].cpu()
    for r in range(2):
        got = torch.load(folder / f"rank{r}.pt")
        assert {k: v for k, v in got["launches"].items() if v} == {"fused_swin_block": 8}
        np.testing.assert_allclose(got["images"].numpy(), want.numpy(), atol=2e-4, rtol=0)


def _events_180x240(seed, n=150_000, capacity=None):
    """``n`` events over 180x240 (float coordinates, a few out of range),
    sorted ts, +-1 polarity, padded past ``n``; CPU tensors."""
    from bde2vid_tpu_torch.events.voxel import pad_events

    rng = np.random.default_rng(seed)
    xs = rng.uniform(-2, 242, n).astype(np.float32)
    ys = rng.uniform(-2, 182, n).astype(np.float32)
    ts = np.sort(rng.uniform(0, 0.05, n)).astype(np.float32)
    ps = rng.choice(np.array([-1.0, 1.0], np.float32), n)
    *bufs, nv = pad_events(xs, ys, ts, ps, capacity=capacity)
    return [torch.from_numpy(b) for b in bufs], nv


def _rel_close(got, want, rel):
    got, want = got.detach().float().cpu(), want.detach().float()
    return (got - want).abs().max().item() <= rel * max(want.abs().max().item(), 1e-30)


@pytest.mark.cuda
def test_cuda_event_images_match_cpu_at_180x240(cuda_device):
    """Every event image, the drv planes, the timestamp images and the
    hard-binned voxels on the card vs the CPU, 150 000 events at 180x240,
    within 1e-5 relative (``index_add`` adds in no fixed order on the card);
    no hand-written kernel launches."""
    from bde2vid_tpu_torch.events import voxel as tv

    (xs, ys, ts, ps), n = _events_180x240(0)
    jx, jy = (torch.from_numpy(np.random.default_rng(s).normal(size=(2, len(xs))).astype(np.float32))
              for s in (1, 2))
    flow = torch.from_numpy(np.random.default_rng(3).normal(size=(180, 240, 2)).astype(np.float32))
    ix, iy = xs.floor().int(), ys.floor().int()
    calls = {
        "image": lambda a: tv.events_to_image(a["ix"], a["iy"], a["ps"], n),
        "bilinear": lambda a: tv.events_to_image_bilinear(a["xs"], a["ys"], a["ps"], n),
        "bilinear_unclipped": lambda a: tv.events_to_image_bilinear(a["xs"], a["ys"], a["ps"], n,
                                                                    clip_weights=False),
        "drv": lambda a: tv.events_to_image_drv(a["xs"], a["ys"], a["ps"], a["jx"], a["jy"], n),
        "timestamp": lambda a: tv.events_to_timestamp_image(a["xs"], a["ys"], a["ts"], a["ps"], n),
        "accumulate": lambda a: tv.events_to_voxel_accumulate(a["ix"], a["iy"], a["ts"], a["ps"], n),
        "warp": lambda a: tv.warp_events_by_flow(a["xs"].clamp(0, 239), a["ys"].clamp(0, 179),
                                                 a["ts"], a["flow"], n_events=n),
    }
    cpu = dict(xs=xs, ys=ys, ts=ts, ps=ps, ix=ix, iy=iy, jx=jx, jy=jy, flow=flow)
    card = {k: v.to(cuda_device) for k, v in cpu.items()}
    before = dict(launch_counts)
    for name, fn in calls.items():
        want, got = fn(cpu), fn(card)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.is_cuda and g.shape == w.shape
            assert _rel_close(g, w, 1e-5), name
    torch.cuda.synchronize()
    assert _launched(before) == {}


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["variance", "rms", "sos", "soe", "moa", "isoa", "sosa", "zhu"])
def test_cuda_cmax_objective_matches_cpu(cuda_device, objective):
    """Each objective's value and gradient on the card vs the CPU at 180x240
    with 150 000 events, within 1e-4 relative."""
    from bde2vid_tpu_torch.events import cmax

    events, n = _events_180x240(4)
    f = cmax.objective_fn(objective, (180, 240), True, None if objective == "zhu" else 1.0)
    out = {}
    for dev in ("cpu", cuda_device):
        params = torch.tensor([40.0, -25.0], device=dev, requires_grad=True)
        v = f(params, *(e.to(dev) for e in events), n)
        (g,) = torch.autograd.grad(v, params)
        out[str(dev)] = (v, g)
    (v_cpu, g_cpu), (v_card, g_card) = out["cpu"], out[str(cuda_device)]
    assert _rel_close(v_card, v_cpu, 1e-4) and _rel_close(g_card, g_cpu, 1e-4)


@pytest.mark.cuda
def test_cuda_blur_holds_f32_with_tf32_on(cuda_device):
    """The blur is explicit f32 multiply-adds: with cuDNN's TF32 switched on
    it stays within 1e-6 x max(1, max |CPU|) of the CPU, where a TF32
    convolution would drift by ~1e-3 relative."""
    from bde2vid_tpu_torch.events.cmax import gaussian_blur

    img = torch.from_numpy(np.random.default_rng(5).uniform(0, 8, (181, 241)).astype(np.float32))
    was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for sigma in (1.0, 2.0):
            want = gaussian_blur(img, sigma)
            got = gaussian_blur(img.to(cuda_device), sigma).cpu()
            assert (got - want).abs().max().item() <= 1e-6 * max(1.0, want.abs().max().item())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was


@pytest.mark.cuda
def test_cuda_deform_conv2d_and_align_add2_match_cpu(cuda_device):
    """deform_conv2d (offsets sampling outside the image too) and AlignAdd2
    at C 64, forward and gradients, on the card vs the CPU with TF32 off,
    within 1e-5 relative (forward) and 1e-4 (gradients)."""
    import copy

    from bde2vid_tpu_torch.nn.deform import AlignAdd2, deform_conv2d

    rng = np.random.default_rng(6)
    f = lambda *s, scale=1.0: torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))
    x, off, w = f(2, 16, 23, 31), f(2, 2 * 2 * 9, 12, 16, scale=4.0), f(24, 16, 3, 3, scale=0.1)
    grads = {}
    for dev in ("cpu", cuda_device):
        xs = [t.detach().to(dev).requires_grad_() for t in (x, off, w)]
        y = deform_conv2d(*xs, stride=2, padding=1, deform_groups=2)
        y.square().sum().backward()
        grads[str(dev)] = [y] + [t.grad for t in xs]
    for i, (g, c) in enumerate(zip(grads[str(cuda_device)], grads["cpu"])):
        assert _rel_close(g, c, 1e-5 if i == 0 else 1e-4), i

    torch.manual_seed(7)
    cpu = AlignAdd2(128, 64)
    for p in cpu.parameters():
        torch.nn.init.normal_(p, std=0.02)
    card = copy.deepcopy(cpu).to(cuda_device)
    feats = f(1, 128, 46, 60)
    with torch.no_grad():
        want, got = cpu(feats), card(feats.to(cuda_device))
    assert _rel_close(got, want, 1e-5)


@pytest.mark.cuda
def test_cuda_bench_voxel_runs_on_the_card(cuda_device, capsys):
    from bde2vid_tpu_torch.events import bench_voxel

    assert bench_voxel.main(["--n_events", "20000", "--iters", "4"]) == 0
    out = capsys.readouterr().out
    assert torch.cuda.get_device_name(0) in out
    assert out.count("Mev/s") == 8
