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
    attn_core_backward,
    attn_core_backward_reference,
    fused_swin_block,
    launch_counts,
    swin_block_reference,
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
def test_cuda_even_dilated_window_with_kernel_raises(cuda_device):
    blk = twa.SwinTransformerBlock3D(16, 4, window_size=(3, 4, 4), dilate_win=True,
                                     use_kernel=True).to(cuda_device)
    x = torch.randn(3, 1, 8, 8, 16, device=cuda_device)
    with pytest.raises(NotImplementedError):
        blk(x)


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
        fused_swin_block(xd, cd, p, 4, 1, activation="tanh")


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
@pytest.mark.parametrize("b_,n,heads,c", [(20, 343, 16, 256), (37, 147, 16, 64), (5, 98, 2, 16)])
def test_cuda_backward_kernel_matches_twin_and_repeats_exactly(cuda_device, b_, n, heads, c):
    m = 49
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
