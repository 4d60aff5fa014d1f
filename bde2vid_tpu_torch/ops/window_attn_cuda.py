"""Whole Swin transformer block over a group of windows and the backward of
its attention core: the CUDA kernels (``csrc/swin_block.cu``,
``csrc/attn_core_bwd.cu``), their plain PyTorch twins, and the autograd
Function that joins them.

Counterparts in ``bde2vid_tpu/ops/window_attn_pallas.py``:

- ``fused_swin_block``: kernel ``_fused_swin_kernel``, twin
  ``_ref_swin_block``, with the stochastic-depth masks and the saved ``acc``;
- ``attn_core_backward``: kernel ``_bwd_kernel``, math
  ``_attn_core_bwd_body``, launcher ``_attn_core_bwd_call``;
- ``SwinBlockFunction``: the custom_vjp pairs ``_swin_block_fwd`` /
  ``_swin_block_bwd`` and their masked twins. The forward runs the block
  and keeps ``acc``; the backward runs the cheap ``pre`` stage (centre
  substitution, LNs, q and k|v projections) and ``post`` stage (out
  projection, m1, residual, LN2, MLP, m2) under torch autograd, and the
  attention-core backward between them.

Each public function launches its kernel for CUDA tensors and runs its twin
for CPU tensors; any other device raises. There is no fallback from a kernel
to a twin. A kernel launch is invisible to autograd, so the launchers refuse
inputs that require grad: those go through ``SwinBlockFunction``, which
``fused_swin_block`` picks whenever a gradient is wanted.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from bde2vid_tpu_torch.nn.layers import get_activation

# launches of each hand-written kernel wrapper in this process
launch_counts: collections.Counter = collections.Counter()

_ACT_CODES = {"gelu": 0, "relu": 1}
_HEAD_DIMS = (1, 2, 4, 8, 16, 32)
_MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use
_DBIAS_GROUPS = 16  # window groups of the backward; 16 heads x 16 groups fill 132 SMs


class SwinBlockParams(NamedTuple):
    """One block's weights in torch layout: matrices are (out, in) like
    ``nn.Linear.weight``; ``bias`` is the sliced relative-position bias
    (H, M, N)."""

    norm_q_w: torch.Tensor
    norm_q_b: torch.Tensor
    norm_kv_w: torch.Tensor
    norm_kv_b: torch.Tensor
    q_w: torch.Tensor  # (C, C)
    q_b: torch.Tensor
    kv_w: torch.Tensor  # (2C, C)
    kv_b: torch.Tensor
    proj_w: torch.Tensor  # (C, C)
    proj_b: torch.Tensor
    norm2_w: torch.Tensor
    norm2_b: torch.Tensor
    fc1_w: torch.Tensor  # (Hd, C)
    fc1_b: torch.Tensor
    fc2_w: torch.Tensor  # (C, Hd)
    fc2_b: torch.Tensor
    bias: torch.Tensor  # (H, M, N)


_PRE = ("norm_q_w", "norm_q_b", "norm_kv_w", "norm_kv_b", "q_w", "q_b", "kv_w", "kv_b")
_POST = ("proj_w", "proj_b", "norm2_w", "norm2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")

Masks = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _layer_norm(x, g, b, eps=1e-5):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * g.float() + b.float()


def _erf_approx(x):
    """erf by Abramowitz & Stegun 7.1.26 (|err| <= 1.5e-7), as in the kernel."""
    s = torch.sign(x)
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = (
        ((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t - 0.284496736) * t
        + 0.254829592
    ) * t
    return s * (1.0 - poly * torch.exp(-a * a))


def _kernel_activation(name: str):
    if name in ("gelu", "default"):
        return lambda x: 0.5 * x * (1.0 + _erf_approx(x * 0.7071067811865476))
    return get_activation(name)


# ---------------------------------------------------------------------------
# plain twins, with the Pallas bodies' cast points: each product is an f32
# matmul of operands rounded to the operand type, which is what
# ``preferred_element_type=f32`` computes for bf16 operands
# ---------------------------------------------------------------------------


def _rowdot(a, w, bias, dt):
    return a.to(dt).float() @ w.to(dt).float().t() + bias.float()


def _pre_stage(x, ctr, p: SwinBlockParams, num_heads: int, q_ind: int):
    """Centre substitution, LN_kv and k|v, LN_q and q: returns q (B_, M, C)
    and k, v (B_, N, C) in ``x.dtype``."""
    d, b_, m, c = x.shape
    dt = x.dtype
    xs = torch.cat([x[:q_ind], ctr[None], x[q_ind + 1:]]).float()
    kv = _rowdot(_layer_norm(xs, p.norm_kv_w, p.norm_kv_b), p.kv_w, p.kv_b, dt).to(dt)
    q = _rowdot(_layer_norm(ctr.float(), p.norm_q_w, p.norm_q_b), p.q_w, p.q_b, dt).to(dt)
    k = kv[..., :c].permute(1, 0, 2, 3).reshape(b_, d * m, c)
    v = kv[..., c:].permute(1, 0, 2, 3).reshape(b_, d * m, c)
    return q, k, v


def _post_stage(acc, ctr, p: SwinBlockParams, masks: Masks, activation: str):
    """Out projection, m1, residual, LN2, MLP, m2, residual -> ctr.dtype."""
    dt = acc.dtype
    m1, m2 = (None, None) if masks is None else (masks[0][:, None, None], masks[1][:, None, None])
    proj = _rowdot(acc, p.proj_w, p.proj_b, dt)
    y = ctr.float() + (proj if m1 is None else m1 * proj)
    z = _layer_norm(y, p.norm2_w, p.norm2_b)
    h1 = _kernel_activation(activation)(_rowdot(z, p.fc1_w, p.fc1_b, dt))
    mlp = _rowdot(h1, p.fc2_w, p.fc2_b, dt)
    return (y + (mlp if m2 is None else m2 * mlp)).to(ctr.dtype)


def _heads(t, num_heads):
    """(B_, L, C) -> (B_, H, L, hd) f32."""
    b_, l, c = t.shape
    return t.float().reshape(b_, l, num_heads, c // num_heads).transpose(1, 2)


def _probs(q, k, bias, num_heads):
    """softmax(q k^T hd^-0.5 + bias) per head: (B_, H, M, N) f32."""
    hd = q.shape[-1] // num_heads
    s = (_heads(q, num_heads) @ _heads(k, num_heads).transpose(-2, -1)) * hd**-0.5
    s = s + bias.float()[None]
    s = s - s.amax(-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(-1, keepdim=True)


def attn_core_reference(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """Attention core of one block: q (B_, M, C), k, v (B_, N, C), bias
    (H, M, N) -> acc (B_, M, C) in q.dtype (twin of ``_attn_core``)."""
    b_, m, c = q.shape
    p = _probs(q, k, bias, num_heads).to(q.dtype).float()
    acc = (p @ _heads(v, num_heads)).transpose(1, 2).reshape(b_, m, c)
    return acc.to(q.dtype)


def attn_core_backward_reference(q, k, v, bias, g, num_heads: int):
    """Plain twin of the backward kernel (``_attn_core_bwd_body``): the
    cotangents (dq, dk, dv) in q.dtype and dbias (H, M, N) f32 summed over
    windows, with p and ``ds * scale`` rounded to the operand type."""
    b_, m, c = q.shape
    dt = q.dtype
    scale = (c // num_heads) ** -0.5
    p32 = _probs(q, k, bias, num_heads)
    p = p32.to(dt).float()
    do = _heads(g, num_heads)
    dv = p.transpose(-2, -1) @ do
    dp = do @ _heads(v, num_heads).transpose(-2, -1)
    ds = p32 * (dp - (dp * p32).sum(-1, keepdim=True))
    dsc = (ds * scale).to(dt).float()
    dq = dsc @ _heads(k, num_heads)
    dk = dsc.transpose(-2, -1) @ _heads(q, num_heads)

    def merge(t):
        return t.transpose(1, 2).reshape(b_, -1, c).to(dt)

    return merge(dq), merge(dk), merge(dv), ds.sum(0).to(bias.dtype)


def swin_block_reference(
    x: torch.Tensor,
    ctr: torch.Tensor,
    params: SwinBlockParams,
    num_heads: int,
    q_ind: int,
    activation: str = "gelu",
    masks: Masks = None,
    with_acc: bool = False,
):
    """Plain PyTorch twin of the block kernel. x: (D, B_, M, C) buffer tokens
    (row ``q_ind`` is ignored); ctr: (B_, M, C) live centre tokens; masks:
    the per-window multipliers (m1, m2), each (B_,) f32. Returns the block
    output tokens (B_, M, C), and with ``with_acc`` also the pre-projection
    attention output ``acc`` (B_, M, C)."""
    q, k, v = _pre_stage(x, ctr, params, num_heads, q_ind)
    acc = attn_core_reference(q, k, v, params.bias, num_heads)
    out = _post_stage(acc, ctr, params, masks, activation)
    return (out, acc) if with_acc else out


# ---------------------------------------------------------------------------
# kernel launchers (CUDA tensors only)
# ---------------------------------------------------------------------------


def _lib(name: str):
    from bde2vid_tpu_torch.ops import build

    lib = build.load(name)
    if getattr(lib, "_argtypes_set", False):
        return lib
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "swin_block":
        # 9 ints, the score scale, 23 tensor pointers, 2 mask pointers and the stream
        lib.swin_block_forward.argtypes = [ci] * 9 + [cf] + [vp] * 26
        lib.swin_block_forward.restype = ci
        lib.swin_block_smem_bytes.argtypes = [ci] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
        lib.swin_block_smem_bytes.restype = None
    else:
        # 7 ints, the score scale, 10 tensor pointers and the stream
        lib.attn_core_backward.argtypes = [ci] * 7 + [cf] + [vp] * 11
        lib.attn_core_backward.restype = ci
        lib.attn_core_bwd_smem_bytes.argtypes = [ci] * 4
        lib.attn_core_bwd_smem_bytes.restype = ctypes.c_longlong
    lib._argtypes_set = True
    return lib


def _check_device(x: torch.Tensor, name: str) -> None:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {x.device}")


def _refuse_grad(name: str, tensors) -> None:
    """A ctypes launch writes into ``torch.empty`` outputs that autograd
    knows nothing of: with grad on, inputs that require grad would get no
    gradient, silently. Refuse them."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: a kernel launch is invisible to autograd; inputs that require grad "
            "must go through fused_swin_block, which wraps the launch in SwinBlockFunction"
        )


def _check_head_dim(c: int, num_heads: int) -> None:
    if c % num_heads or c // num_heads not in _HEAD_DIMS:
        raise NotImplementedError(f"head_dim {c}/{num_heads} not in {_HEAD_DIMS}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_swin_block(x, ctr, params: SwinBlockParams, num_heads: int, q_ind: int,
                       activation: str, masks: Masks):
    """Launch the block kernel: returns (out, acc), each (B_, M, C)."""
    _refuse_grad("fused_swin_block", (x, ctr, *params, *(masks or ())))
    if x.device.type != "cuda":
        raise ValueError(f"the swin block kernel runs on cuda tensors, got {x.device}")
    d, b_, m, c = x.shape
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_swin_block takes float32 or bfloat16, got {dt}")
    if ctr.dtype != dt or ctr.shape != (b_, m, c) or ctr.device != x.device:
        raise ValueError(f"ctr must be {(b_, m, c)} {dt} on {x.device}, got {tuple(ctr.shape)} {ctr.dtype} on {ctr.device}")
    if activation not in _ACT_CODES:
        raise NotImplementedError(f"the CUDA swin block supports {sorted(_ACT_CODES)}, got {activation!r}")
    _check_head_dim(c, num_heads)
    if not 0 <= q_ind < d:
        raise ValueError(f"q_ind {q_ind} outside 0..{d - 1}")
    hidden = params.fc1_w.shape[0]
    n = d * m
    shapes = {
        "norm_q_w": (c,), "norm_q_b": (c,), "norm_kv_w": (c,), "norm_kv_b": (c,),
        "q_w": (c, c), "q_b": (c,), "kv_w": (2 * c, c), "kv_b": (2 * c,),
        "proj_w": (c, c), "proj_b": (c,), "norm2_w": (c,), "norm2_b": (c,),
        "fc1_w": (hidden, c), "fc1_b": (hidden,), "fc2_w": (c, hidden), "fc2_b": (c,),
        "bias": (num_heads, m, n),
    }
    prepared = {}
    for name, shape in shapes.items():
        t = getattr(params, name)
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name} must be {shape} on {x.device}, got {tuple(t.shape)} on {t.device}")
        is_matrix = name.endswith("_w") and len(shape) == 2
        prepared[name] = (t.to(dt) if is_matrix else t.float()).contiguous()
    mask_ptrs = [None, None]
    if masks is not None:
        mk = [t.float().contiguous() for t in masks]
        if any(t.shape != (b_,) or t.device != x.device for t in mk):
            raise ValueError(f"masks must be two ({b_},) tensors on {x.device}")
        mask_ptrs = [t.data_ptr() for t in mk]

    lib = _lib("swin_block")
    smem = (ctypes.c_longlong * 3)()
    lib.swin_block_smem_bytes(d, m, c, num_heads, hidden, smem)
    if max(smem) > _MAX_SMEM:
        raise ValueError(f"shapes need {max(smem)} B of shared memory per block (limit {_MAX_SMEM})")

    x = x.contiguous()
    ctr = ctr.contiguous()
    kv = torch.empty((d, b_, m, 2 * c), dtype=dt, device=x.device)
    q = torch.empty((b_, m, c), dtype=dt, device=x.device)
    acc = torch.empty((b_, m, c), dtype=dt, device=x.device)
    out = torch.empty((b_, m, c), dtype=dt, device=x.device)
    p = prepared
    ptrs = [
        x, ctr, p["norm_q_w"], p["norm_q_b"], p["norm_kv_w"], p["norm_kv_b"],
        p["q_w"], p["q_b"], p["kv_w"], p["kv_b"], p["proj_w"], p["proj_b"],
        p["norm2_w"], p["norm2_b"], p["fc1_w"], p["fc1_b"], p["fc2_w"], p["fc2_b"],
        p["bias"], kv, q, acc, out,
    ]
    rc = lib.swin_block_forward(
        int(dt == torch.bfloat16), _ACT_CODES[activation], d, b_, m, c, num_heads,
        hidden, q_ind, float((c // num_heads) ** -0.5),
        *[t.data_ptr() for t in ptrs], *mask_ptrs, _stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"swin_block kernel launch failed: CUDA error {rc}")
    launch_counts["fused_swin_block"] += 1
    return out, acc


def _launch_attn_core_backward(q, k, v, bias, g, num_heads: int):
    """Launch the backward kernel and its dbias reduction."""
    _refuse_grad("attn_core_backward", (q, k, v, bias, g))
    if q.device.type != "cuda":
        raise ValueError(f"the attention backward kernel runs on cuda tensors, got {q.device}")
    b_, m, c = q.shape
    n = k.shape[1]
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attn_core_backward takes float32 or bfloat16, got {dt}")
    for name, t, shape in (("k", k, (b_, n, c)), ("v", v, (b_, n, c)), ("g", g, (b_, m, c))):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != q.device:
            raise ValueError(f"{name} must be {shape} {dt} on {q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if tuple(bias.shape) != (num_heads, m, n) or bias.device != q.device:
        raise ValueError(f"bias must be {(num_heads, m, n)} on {q.device}, got {tuple(bias.shape)}")
    _check_head_dim(c, num_heads)
    lib = _lib("attn_core_bwd")
    smem = lib.attn_core_bwd_smem_bytes(m, n, c, num_heads)
    if smem > _MAX_SMEM:
        raise ValueError(f"shapes need {smem} B of shared memory per block (limit {_MAX_SMEM})")

    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    bias32 = bias.float().contiguous()
    groups = min(_DBIAS_GROUPS, b_)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    partial = torch.empty((groups, num_heads, m, n), dtype=torch.float32, device=q.device)
    dbias = torch.empty((num_heads, m, n), dtype=torch.float32, device=q.device)
    rc = lib.attn_core_backward(
        int(dt == torch.bfloat16), b_, m, n, c, num_heads, groups,
        float((c // num_heads) ** -0.5),
        *[t.data_ptr() for t in (q, k, v, bias32, g, dq, dk, dv, partial, dbias)], _stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"attn_core_backward kernel launch failed: CUDA error {rc}")
    launch_counts["attn_core_backward"] += 1
    return dq, dk, dv, dbias.to(bias.dtype)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def attn_core_backward(q, k, v, bias, g, num_heads: int):
    """Cotangents of the attention core: q, g (B_, M, C), k, v (B_, N, C),
    bias (H, M, N) -> (dq, dk, dv, dbias). CUDA tensors launch the
    hand-written kernel; CPU tensors run :func:`attn_core_backward_reference`."""
    _check_device(q, "attn_core_backward")
    if q.device.type == "cpu":
        return attn_core_backward_reference(q, k, v, bias, g, num_heads)
    return _launch_attn_core_backward(q, k, v, bias, g, num_heads)


class SwinBlockFunction(torch.autograd.Function):
    """The block with a gradient: the forward runs the block (kernel on CUDA,
    twin on the CPU) and keeps ``acc``; the backward is the hybrid of
    ``_swin_block_bwd``: autograd of the ``pre`` and ``post`` stages around
    :func:`attn_core_backward`. The q_ind row of ``x`` gets a zero gradient
    (the centre substitution drops it) and its cotangent goes to ``ctr``;
    ``bias`` gets the summed dbias, so the gradient reaches the
    relative-position table through the caller's gather."""

    @staticmethod
    def forward(ctx, num_heads, q_ind, activation, x, ctr, m1, m2, *params):
        p = SwinBlockParams(*params)
        masks = None if m1 is None else (m1, m2)
        if x.device.type == "cpu":
            out, acc = swin_block_reference(x, ctr, p, num_heads, q_ind, activation, masks, True)
        else:
            out, acc = _launch_swin_block(x, ctr, p, num_heads, q_ind, activation, masks)
        ctx.save_for_backward(x, ctr, acc, m1, m2, *params)
        ctx.cfg = (num_heads, q_ind, activation)
        return out

    @staticmethod
    def backward(ctx, g):
        num_heads, q_ind, activation = ctx.cfg
        x, ctr, acc, m1, m2, *params = ctx.saved_tensors
        p = SwinBlockParams(*params)
        masks = None if m1 is None else (m1, m2)

        def leaf(t):
            return t.detach().requires_grad_()

        with torch.enable_grad():
            x_l, ctr_pre = leaf(x), leaf(ctr)
            pre = {n: leaf(getattr(p, n)) for n in _PRE}
            q, k, v = _pre_stage(x_l, ctr_pre, p._replace(**pre), num_heads, q_ind)
            acc_l, ctr_post = leaf(acc), leaf(ctr)
            post = {n: leaf(getattr(p, n)) for n in _POST}
            out = _post_stage(acc_l, ctr_post, p._replace(**post), masks, activation)
        dacc, dctr_post, *dpost = torch.autograd.grad(out, [acc_l, ctr_post, *post.values()], g)
        dq, dk, dv, dbias = attn_core_backward(
            q.detach(), k.detach(), v.detach(), p.bias.detach(), dacc, num_heads)
        dx, dctr_pre, *dpre = torch.autograd.grad((q, k, v), [x_l, ctr_pre, *pre.values()],
                                                  (dq, dk, dv))
        grads = {**dict(zip(_PRE, dpre)), **dict(zip(_POST, dpost)), "bias": dbias}
        return (None, None, None, dx, dctr_pre + dctr_post, None, None,
                *[grads[n] for n in SwinBlockParams._fields])


def fused_swin_block(
    x: torch.Tensor,
    ctr: torch.Tensor,
    params: SwinBlockParams,
    num_heads: int,
    q_ind: int,
    activation: str = "gelu",
    masks: Masks = None,
    with_acc: bool = False,
):
    """One whole Swin block per window: x (D, B_, M, C), ctr (B_, M, C) ->
    (B_, M, C), and with ``with_acc`` also ``acc``. ``masks`` = (m1, m2), the
    per-window stochastic-depth multipliers, each (B_,) f32. CUDA tensors
    launch the hand-written kernel, CPU tensors run
    :func:`swin_block_reference`; when grad mode is on and an input
    requires grad, the call goes through :class:`SwinBlockFunction`."""
    _check_device(x, "fused_swin_block")
    if masks is not None and any(t.requires_grad for t in masks):
        raise ValueError("stochastic-depth masks are constants; they must not require grad")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, ctr, *params)):
        if with_acc:
            raise ValueError("with_acc is an output of no-grad calls; the Function keeps acc itself")
        m1, m2 = (None, None) if masks is None else masks
        return SwinBlockFunction.apply(num_heads, q_ind, activation, x, ctr, m1, m2, *params)
    if x.device.type == "cpu":
        return swin_block_reference(x, ctr, params, num_heads, q_ind, activation, masks, with_acc)
    out, acc = _launch_swin_block(x, ctr, params, num_heads, q_ind, activation, masks)
    return (out, acc) if with_acc else out
