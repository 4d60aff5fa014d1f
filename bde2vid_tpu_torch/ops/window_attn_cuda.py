"""The window-attention CUDA kernels (``csrc/swin_block.cu``,
``csrc/window_block.cu``, ``csrc/window_attention.cu``,
``csrc/attn_core_bwd.cu``), their plain PyTorch twins, and the autograd
Functions around them.

Counterparts in ``bde2vid_tpu/ops/window_attn_pallas.py``:

- ``fused_swin_block``: kernel ``_fused_swin_kernel``, twin
  ``_ref_swin_block``, with the stochastic-depth masks and the saved ``acc``;
- ``fused_window_block``: kernel ``_fused_block_kernel``, twin
  ``_ref_window_block``, with the optional ``acc`` output (the
  WindowAttention3D body: no residual, no MLP);
- ``fused_window_attention``: kernel ``_kernel`` (math ``_attn_core``),
  twin ``_ref_window_attention``;
- ``attn_core_backward``: kernel ``_bwd_kernel``, math
  ``_attn_core_bwd_body``, launcher ``_attn_core_bwd_call``;
- ``SwinBlockFunction`` and ``WindowBlockFunction``: the custom_vjp pairs
  ``_swin_block_fwd`` / ``_swin_block_bwd`` and ``_window_block_bwd``. The
  forward runs the block and keeps ``acc``; the backward runs the cheap
  ``pre`` stage (centre substitution, LNs, q and k|v projections) and
  ``post`` stage (out projection, and for the Swin block m1, residual, LN2,
  MLP, m2) under torch autograd, and the attention-core backward between
  them. ``WindowAttentionFunction`` (``_window_attention_fwd`` /
  ``_window_attention_bwd``) is the attention core with that backward.

Each public function launches its kernel for CUDA tensors and runs its twin
for CPU tensors; any other device raises. There is no fallback from a kernel
to a twin. A kernel launch is invisible to autograd, so the launchers refuse
inputs that require grad: the public functions route those through their
Function whenever a gradient is wanted. The no-grad forwards of the two
block kernels are the registered operators ``bde2vid_torch::swin_block``
and ``bde2vid_torch::window_block`` (``swin_block_op``, ``window_block_op``:
a fake implementation for tracing, a FLOP formula for ``FlopCounterMode``),
so an eager call and a ``torch.export`` program run the same code.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from bde2vid_tpu_torch.nn.layers import get_activation

# launches of each hand-written kernel wrapper in this process
launch_counts: collections.Counter = collections.Counter()

# the kernels' activation codes (``Act`` in csrc/window_common.cuh): every
# name of the registry (``nn.layers.get_activation``), with "default" the
# A&S GELU as in ``_kernel_activation``
_ACT_CODES = {
    "gelu": 0, "default": 0, "relu": 1, "relu6": 2, "sigmoid": 3, "tanh": 4, "lrelu": 5,
    "leaky_relu": 5, "elu": 6, "softplus": 7, "identity": 8, "none": 8,
}
_MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use
_TILE_KEYS = 32  # keys of one block of the tiled backward's keys kernel (kTileKeys)
_KEYS_WARPS = 8  # its most warps of 16 rows: a row group of at most 128 rows (kKeysWarps)
# the wide backward's (head_dim > 32) largest block (f32, the dk/dv kernel's:
# wide_dkdv_smem in csrc/attn_core_bwd.cu): 64 rows of g and q in 64-column
# chunks and their round(p) and round(ds scale) against 32 keys
_WIDE_SMEM = 4 * 64 * (2 * (64 + 4) + 2 * (32 + 4))
ATTN_THREADS = 256  # threads of a forward attention block (kAttnThreads in csrc/window_common.cuh)
FLASH_THREADS = 128  # threads of a key-tiled forward block, four 16-row tiles (kFlashThreads)
WIDE_THREADS = 128  # threads of a wide forward block (kWideThreads in csrc/device_common.cuh)
WIDE_FORWARD_HEAD_DIM = 256  # the wide forward takes every head_dim above this (kWideFwdMinHd)
_WIDE_FWD_KEYS = 32  # keys of the wide forward's scores tile (kWideFwdKeys)


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


class WindowBlockParams(NamedTuple):
    """The WindowAttention3D weights in torch layout: matrices are (out, in)
    like ``nn.Linear.weight``; ``bias`` is the sliced relative-position bias
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


# the twin of ``_ref_window_attention``: the attention core of the block
# kernels is the same function
window_attention_reference = attn_core_reference


def _post(acc, p: WindowBlockParams, dt):
    return _rowdot(acc, p.proj_w, p.proj_b, dt).to(dt)


def window_block_reference(x: torch.Tensor, params: WindowBlockParams, num_heads: int,
                           q_ind: int, with_acc: bool = False):
    """Plain PyTorch twin of the WindowAttention3D body kernel. x:
    (D, B_, M, C) window token stacks, queries from frame ``q_ind``. Returns (B_, M, C) in x.dtype, and
    with ``with_acc`` also the pre-projection attention output ``acc``."""
    q, k, v = _pre_stage(x, x[q_ind], params, num_heads, q_ind)
    acc = attn_core_reference(q, k, v, params.bias, num_heads)
    out = _post(acc, params, x.dtype)
    return (out, acc) if with_acc else out


# ---------------------------------------------------------------------------
# kernel launchers (CUDA tensors only)
# ---------------------------------------------------------------------------


_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL, _LLP = ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)
# (argtypes, restype) of each library's C functions
_SIGNATURES = {
    "swin_block": {
        # 11 ints, the score scale, 25 tensor pointers, 2 mask pointers, the
        # attention scratch and the stream
        "swin_block_forward": ([_CI] * 11 + [_CF] + [_VP] * 29, _CI),
        "swin_block_smem_bytes": ([_CI] * 6 + [_LLP], None),
        "swin_block_attn_occupancy": ([_CI] * 6 + [_LLP], _CI),
    },
    "window_block": {
        # 9 ints, the score scale, 16 tensor pointers, the attention scratch and the stream
        "window_block_forward": ([_CI] * 9 + [_CF] + [_VP] * 18, _CI),
        "window_block_smem_bytes": ([_CI] * 6 + [_LLP], None),
        "window_block_attn_occupancy": ([_CI] * 6 + [_LLP], _CI),
    },
    "window_attention": {
        # 8 ints, the score scale, 5 tensor pointers, the scratch and the stream
        "window_attention_forward": ([_CI] * 8 + [_CF] + [_VP] * 7, _CI),
        "window_attention_smem_bytes": ([_CI] * 6, _LL),
        "window_attention_occupancy": ([_CI] * 6 + [_LLP], _CI),
        "window_attention_scratch_floats": ([_CI] * 5, _LL),
    },
    "attn_core_bwd": {
        # 8 ints, the score scale, 11 tensor pointers and the stream
        "attn_core_backward": ([_CI] * 8 + [_CF] + [_VP] * 12, _CI),
        "attn_core_bwd_smem_bytes": ([_CI] * 5, _LL),
        "attn_core_bwd_occupancy": ([_CI] * 6 + [_LLP], _CI),
        "attn_core_bwd_scratch_floats": ([_CI] * 6, _LL),
    },
}


def _lib(name: str):
    from bde2vid_tpu_torch.ops import build

    lib = build.load(name)
    if getattr(lib, "_argtypes_set", False):
        return lib
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
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
            f"must go through the public {name}, which wraps the launch in its autograd Function"
        )


def _padded_head_dim(head_dim: int) -> int:
    """The head_dim the kernels instantiated at powers of two run
    ``head_dim`` at (``padded_hd`` in csrc/device_common.cuh): the least
    power of two that holds it, the columns past ``head_dim`` zeros (the
    forward up to head_dim 256, the backward up to 32; above those the wide
    kernels take any head_dim as it is)."""
    if head_dim < 1:
        raise ValueError(f"head_dim {head_dim}: the attention kernels take head_dim 1 or more")
    return 1 << (head_dim - 1).bit_length()


def _check_head_dim(c: int, num_heads: int) -> None:
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"{num_heads} heads do not divide C {c}")


def _prepare_params(params, shapes: dict, dt: torch.dtype, device) -> dict:
    """Check each named parameter's shape and device; weight matrices in the
    operand type ``dt``, vectors and the bias in f32, all contiguous."""
    prepared = {}
    for name, shape in shapes.items():
        t = getattr(params, name)
        if tuple(t.shape) != shape or t.device != device:
            raise ValueError(f"{name} must be {shape} on {device}, got {tuple(t.shape)} on {t.device}")
        is_matrix = name.endswith("_w") and len(shape) == 2
        prepared[name] = (t.to(dt) if is_matrix else t.float()).contiguous()
    return prepared


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _attn_scratch(b_: int, heads: int, m: int, n: int, c: int, device) -> Optional[torch.Tensor]:
    """The forward attention's f32 scratch from the torch allocator
    (``attn_forward_scratch_floats``), or None where it needs none."""
    floats = attn_forward_scratch_floats(b_, heads, m, n, c // heads)
    return torch.empty((floats,), dtype=torch.float32, device=device) if floats else None


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
    act = _ACT_CODES.get("none" if activation is None else activation.lower())
    if act is None:
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
    prepared = _prepare_params(params, shapes, dt, x.device)
    mask_ptrs = [None, None]
    if masks is not None:
        mk = [t.float().contiguous() for t in masks]
        if any(t.shape != (b_,) or t.device != x.device for t in mk):
            raise ValueError(f"masks must be two ({b_},) tensors on {x.device}")
        mask_ptrs = [t.data_ptr() for t in mk]

    lib = _lib("swin_block")
    plan = attn_plan_for("swin_block", b_, m, n, c, num_heads, dt, x.device.index)
    smem = (ctypes.c_longlong * 3)()
    lib.swin_block_smem_bytes(int(dt == torch.bfloat16), d, m, c, num_heads, int(plan.key_tiled), smem)
    if max(smem) > _MAX_SMEM:
        raise ValueError(f"shapes need {max(smem)} B of shared memory per block (limit {_MAX_SMEM})")

    x = x.contiguous()
    ctr = ctr.contiguous()
    kv = torch.empty((d, b_, m, 2 * c), dtype=dt, device=x.device)
    q = torch.empty((b_, m, c), dtype=dt, device=x.device)
    acc = torch.empty((b_, m, c), dtype=dt, device=x.device)
    out = torch.empty((b_, m, c), dtype=dt, device=x.device)
    attn_scratch = _attn_scratch(b_, num_heads, m, n, c, x.device)
    # the MLP's scratch: the residual stream y (f32, as in the Pallas body)
    # and the hidden rows h (rounded to the operand type)
    y = torch.empty((b_, m, c), dtype=torch.float32, device=x.device)
    h = torch.empty((b_, m, hidden), dtype=dt, device=x.device)
    p = prepared
    ptrs = [
        x, ctr, p["norm_q_w"], p["norm_q_b"], p["norm_kv_w"], p["norm_kv_b"],
        p["q_w"], p["q_b"], p["kv_w"], p["kv_b"], p["proj_w"], p["proj_b"],
        p["norm2_w"], p["norm2_b"], p["fc1_w"], p["fc1_b"], p["fc2_w"], p["fc2_b"],
        p["bias"], kv, q, acc, out, y, h,
    ]
    rc = lib.swin_block_forward(
        int(dt == torch.bfloat16), act, d, b_, m, c, num_heads,
        hidden, q_ind, plan.tiles, int(plan.key_tiled), float((c // num_heads) ** -0.5),
        *[t.data_ptr() for t in ptrs], *mask_ptrs, _ptr(attn_scratch), _stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"swin_block kernel launch failed: CUDA error {rc}")
    launch_counts[fwd_counter("fused_swin_block", plan)] += 1
    return out, acc


def _launch_attn_core_backward(q, k, v, bias, g, num_heads: int):
    """Launch the backward kernel the plan picks and its dbias reduction."""
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
    plan = attn_core_bwd_plan(m, n, c, num_heads)
    lib = _lib("attn_core_bwd")

    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    bias32 = bias.float().contiguous()
    # the wide backward (head_dim > 32) writes a ds plane a window, which the
    # reduction sums in window order, and its other planes into scratch; the
    # tiled backward (row share 0) keeps its row statistics in scratch and
    # writes dbias itself; the register kernel sums dbias per window group
    scratch_floats = lib.attn_core_bwd_scratch_floats(b_, m, n, c, num_heads, plan.row_share)
    if plan.row_share:
        occ = attn_core_backward_occupancy(m, n, c, num_heads, dt, q.device.index)
        groups = bwd_window_groups(b_, num_heads, occ["blocks_per_sm"], occ["sms"])
    else:
        groups = b_
    tiled = not plan.row_share and _padded_head_dim(c // num_heads) <= 32
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    partial = None if tiled else torch.empty((groups, num_heads, m, n), dtype=torch.float32, device=q.device)
    scratch = torch.empty((scratch_floats,), dtype=torch.float32, device=q.device) if scratch_floats else None
    dbias = torch.empty((num_heads, m, n), dtype=torch.float32, device=q.device)
    rc = lib.attn_core_backward(
        int(dt == torch.bfloat16), b_, m, n, c, num_heads, groups, plan.row_share,
        float((c // num_heads) ** -0.5),
        *[t.data_ptr() for t in (q, k, v, bias32, g, dq, dk, dv)],
        *[None if t is None else t.data_ptr() for t in (partial, dbias, scratch)], _stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"attn_core_backward kernel launch failed: CUDA error {rc}")
    launch_counts[bwd_counter(plan, c // num_heads)] += 1
    return dq, dk, dv, dbias.to(bias.dtype)


# keys a lane of the backward's pass 1 may keep of a score row in registers
# (kRowShares in csrc/device_common.cuh)
_BWD_ROW_SHARES = (12, 16, 32)


class BwdPlan(NamedTuple):
    """Which backward kernel a launch takes: ``row_share`` J is the keys a
    lane keeps of a score row in registers (12, 16 or 32), or 0: at head_dim
    <= 32 the tiled backward (three launches, ``attn_bwd_rows_kernel``,
    ``attn_bwd_keys_kernel`` and ``attn_bwd_dq_reduce_kernel`` in
    csrc/attn_core_bwd.cu, whose blocks take 32-key tiles at every shape),
    above it the wide backward (four launches whose tiles are its own,
    ``attn_bwd_scores_kernel``); ``smem_bytes`` is the shared memory of the
    kernel's largest block in f32; ``key_tiles`` only names the tiled
    backward's launch counter: True where a window's k, v, q and g rows
    would not fit in one block (``attn_core_bwd_window_bytes``), counted as
    key tiles, False where they would (long rows) and for the other
    kernels."""

    row_share: int
    smem_bytes: int
    key_tiles: bool = False


def bwd_counter(plan: BwdPlan, head_dim: int) -> str:
    """The launch counter of the backward kernel ``plan`` takes at
    ``head_dim``."""
    if _padded_head_dim(head_dim) > 32:
        return "attn_core_backward_wide"
    if plan.row_share:
        return "attn_core_backward"
    return "attn_core_backward_key_tiles" if plan.key_tiles else "attn_core_backward_long_rows"


def _tiled_hd(head_dim: int) -> int:
    """The HD the tiled backward runs ``head_dim`` at (``tiled_hd``): 4, 8,
    16 or 32."""
    return max(4, _padded_head_dim(head_dim))


def tiled_keys_rows(m: int) -> tuple[int, int]:
    """Warps of the tiled backward's keys kernel at M query rows and the rows
    of its largest row group (``keys_warps`` and ``keys_group_rows`` in
    csrc/attn_core_bwd.cu): the fewest groups of at most 8 warps of 16 rows,
    the rows split evenly over them; one group holds M rows."""
    groups = -(-m // (16 * _KEYS_WARPS))
    per_group = -(-m // groups)
    warps = -(-per_group // 16)
    return warps, (m if groups == 1 else 16 * warps)


def attn_core_bwd_smem_bytes(m: int, n: int, head_dim: int, row_share: int) -> int:
    """Shared memory of the backward's largest block in f32
    (``attn_core_bwd_smem_bytes`` in csrc/attn_core_bwd.cu) at the padded
    head_dim: with a row share, the padded k, v, q and g rows, three row
    statistics and the (M, N) dbias plane; with none, the larger block of
    the tiled backward: its keys kernel (two stages of a row group's
    statistics and q and g rows and the tile's k and v rows, then the warps'
    partial dk and dv and the tile's (rows, 33) round(ds scale)) or its rows
    kernel (8 R q and g rows, R 8 and 4 at head_dim 32, two stages of 64 k
    and v rows and of the rows' bias against them); above head_dim 32, the
    wide backward's largest block, whatever the shapes."""
    hd = _padded_head_dim(head_dim)
    if hd > 32:
        return _WIDE_SMEM
    if not row_share:
        thd = _tiled_hd(head_dim)
        warps, mg = tiled_keys_rows(m)
        stage = -(-(16 * mg + 4 * (2 * mg + 2 * _TILE_KEYS) * (thd + 4)) // 16) * 16
        keys = 2 * stage + 4 * warps * _TILE_KEYS * (2 * thd + 4) + 16 * -(-mg * (_TILE_KEYS + 1) // 4)
        rows_r = 8 * (8 if thd <= 16 else 4)
        rows = 4 * (thd + 4) * (2 * rows_r + 4 * 64) + 4 * 2 * rows_r * 68
        return max(keys, rows)
    return 4 * (2 * (n + m) * _key_stride(hd) + 3 * m + m * n)


def attn_core_bwd_window_bytes(m: int, n: int, head_dim: int) -> int:
    """Bytes of one window's k, v, q and g rows (padded, f32) and three row
    statistics. Only the launch counter reads it: the tiled backward counts
    rows as long rows where this fits in one block's shared memory (the
    rows an earlier long-row kernel took), as key tiles where it does not;
    the kernels are the same."""
    return 4 * (2 * (n + m) * _key_stride(_padded_head_dim(head_dim)) + 3 * m)


def attn_core_bwd_plan(m: int, n: int, c: int, num_heads: int) -> BwdPlan:
    """The backward kernel for windows of M query rows and N keys at width C
    over ``num_heads`` heads: rows of at most 32 x 32 keys whose (M, N)
    plane fits in shared memory beside the k/v rows keep their row share in
    registers (the fewest J with N <= 32 J); the other rows at head_dim <=
    32 take the tiled backward, whose blocks hold a 32-key tile and row
    groups of at most 128 rows, whatever M and N; above head_dim 32 every
    row takes the wide backward, whose blocks tile M, N and head_dim
    themselves. Every plan fits, whatever the shapes. A head_dim between the
    instantiated ones plans as the next one up. A function of its arguments
    alone."""
    _check_head_dim(c, num_heads)
    hd = _padded_head_dim(c // num_heads)
    if hd > 32:
        return BwdPlan(0, attn_core_bwd_smem_bytes(m, n, hd, 0))
    for j in _BWD_ROW_SHARES:
        if n <= 32 * j:
            smem = attn_core_bwd_smem_bytes(m, n, hd, j)
            if smem <= _MAX_SMEM:
                return BwdPlan(j, smem)
            break
    key_tiles = attn_core_bwd_window_bytes(m, n, hd) > _MAX_SMEM
    return BwdPlan(0, attn_core_bwd_smem_bytes(m, n, hd, 0), key_tiles)


def bwd_window_groups(b_: int, heads: int, blocks_per_sm: int, sms: int) -> int:
    """Window groups of one backward launch. Block (group, head) takes
    windows ``[group * b_ // groups, (group + 1) * b_ // groups)``. All
    blocks fit in one wave of ``sms * blocks_per_sm`` resident slots, the
    fullest group holds as few windows as that allows, and the groups are
    the fewest that give it, which keeps the dbias partial buffer (groups,
    H, M, N) small. A function of its arguments alone, so two runs take the
    same groups and sum dbias in the same order."""
    most = max(1, min(b_, sms * blocks_per_sm // heads))
    per_group = -(-b_ // most)
    return -(-b_ // per_group)


@functools.lru_cache(maxsize=None)
def attn_core_backward_occupancy(m: int, n: int, c: int, num_heads: int, dtype,
                                 device_index: int) -> dict:
    """What the backward kernel's instantiation for these shapes gets on
    CUDA card ``device_index``: registers and spill bytes per thread
    (ptxas), dynamic shared memory per block, threads per block, resident
    blocks per SM, J (keys a lane keeps of a score row; 0 for the tiled and
    the wide backward), S (lanes per key in pass 2), the key tile (the tiled
    backward's keys kernel's, else 0) and the card's SMs, for the kernel
    :func:`attn_core_bwd_plan` picks. The tiled and the wide backward report
    the extremes of their kernels (the most registers, spill and shared
    memory, the fewest blocks per SM)."""
    plan = attn_core_bwd_plan(m, n, c, num_heads)
    info = (ctypes.c_longlong * 8)()
    with torch.cuda.device(device_index):
        rc = _lib("attn_core_bwd").attn_core_bwd_occupancy(
            int(dtype == torch.bfloat16), m, n, c, num_heads, plan.row_share, info)
    if rc != 0:
        raise RuntimeError(f"attn_core_bwd_occupancy failed: CUDA error {rc}")
    keys = ("registers", "spill_bytes", "smem_bytes", "threads", "blocks_per_sm", "row_share", "slices",
            "key_tile")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return {**dict(zip(keys, info)), "sms": sms}


def _key_stride(head_dim: int) -> int:
    """Row stride (floats) of a staged k or v row (``key_stride`` in
    csrc/device_common.cuh)."""
    if head_dim < 4:
        return head_dim + 1
    return head_dim if (head_dim // 4) % 2 else head_dim + 4


def attn_rows(head_dim: int, bf16: bool = False) -> int:
    """Query rows a warp of the untiled forward attention takes at once:
    one, or 16 (an mma tile) for bf16 at head_dim >= 16 (padded), which
    runs on the tensor cores (``attn_kernel_mma`` in
    csrc/window_common.cuh)."""
    return 16 if bf16 and _padded_head_dim(head_dim) >= 16 else 1


def attn_smem_bytes(n: int, head_dim: int, bf16: bool = False) -> int:
    """Shared memory of an untiled forward attention block, which stages
    one window's k and v rows at the padded head_dim (``attn_smem_bytes``
    and, for the tensor-core kernel, ``attn_mma_smem_bytes`` in
    csrc/window_common.cuh)."""
    hd = _padded_head_dim(head_dim)
    if bf16 and hd >= 16:
        keys = -(-n // 16) * 16
        return 2 * (keys * (hd + 8) + hd * (keys + 8))
    return 4 * 2 * n * _key_stride(hd)


def attn_wide(head_dim: int) -> bool:
    """True above head_dim 256, where the wide forward runs
    (``attn_wide_scores_kernel`` and ``attn_wide_out_kernel`` in
    csrc/window_common.cuh): its blocks tile the keys, the rows and
    64-column chunks of head_dim themselves, whatever the shapes."""
    return head_dim > WIDE_FORWARD_HEAD_DIM


def attn_forward_scratch_floats(b_: int, heads: int, m: int, n: int, head_dim: int) -> int:
    """Floats of f32 scratch a forward attention launch needs
    (``WideFwdPlanes::floats`` in csrc/window_common.cuh): above head_dim
    256 the wide forward's score plane (B_ H, M, np), rows padded to np =
    32-key tiles x 32, and each row's max and sum of exp a key tile, (B_ H,
    tiles, M) each; else 0."""
    if not attn_wide(head_dim):
        return 0
    tiles = -(-n // _WIDE_FWD_KEYS)
    return b_ * heads * m * (tiles * _WIDE_FWD_KEYS + 2 * tiles)


def attn_key_tiled(m: int, n: int, head_dim: int, bf16: bool = False) -> bool:
    """False where one block stages a window's k and v rows whole (the
    kernels of ``attn_smem_bytes``, instantiated up to head_dim 32) and
    above head_dim 256 (``attn_wide``), else True: the key-tiled forward
    (``attn_flash_kernel`` in csrc/window_common.cuh) runs every row whose
    k and v do not fit and every head_dim from 33 to 256. Its key tile and
    shared memory are constants of its instantiation, which
    ``attn_forward_occupancy`` reads back."""
    if attn_wide(head_dim):
        return False
    return not (_padded_head_dim(head_dim) <= 32 and attn_smem_bytes(n, head_dim, bf16) <= _MAX_SMEM)


class AttnPlan(NamedTuple):
    """How one forward attention launch splits its work: block (window,
    head, tile) has warp w take the window's row items (of ``attn_rows``
    query rows each) tile * warps + w + k * warps * tiles, k = 0, 1, ...;
    with ``key_tiled`` (``attn_key_tiled``), blocks of the key-tiled kernel
    take the window's 64-row groups (four warps of 16 rows) tile, tile +
    tiles, ...; with ``wide`` (``attn_wide``), the wide forward's blocks
    tile the rows, keys and head_dim themselves (``tiles`` 1)."""

    tiles: int
    threads: int  # threads per block
    key_tiled: bool = False
    wide: bool = False


def fwd_counter(name: str, plan: AttnPlan) -> str:
    """The launch counter of forward library ``name`` (``fused_swin_block``,
    ``fused_window_block`` or ``fused_window_attention``) at ``plan``:
    ``_wide`` for the wide forward, ``_key_tiles`` for the key-tiled one."""
    return name + ("_wide" if plan.wide else "_key_tiles" if plan.key_tiled else "")


def attn_forward_plan(b_: int, heads: int, m: int, n: int, head_dim: int, sms: int,
                      blocks_per_sm: int, bf16: bool = False) -> AttnPlan:
    """The launch plan of the forward attention core for B_ windows of M
    query rows and N keys, ``heads`` heads of ``head_dim`` (``bf16``: the
    operand type, which at head_dim >= 16 takes the tensor-core kernel), on
    a card with ``sms`` SMs of which each holds ``blocks_per_sm`` of its
    blocks: the fewest tiles a window for which the blocks fill two waves
    of the card, and no more than leave each warp an item. Rows whose k and
    v do not fit in one block, and head_dims from 33 to 256, take the
    key-tiled kernel (``attn_key_tiled``), whose tiles are the window's
    64-row groups; head_dims above 256 the wide forward (``attn_wide``). A
    function of its arguments alone."""
    if attn_wide(head_dim):
        return AttnPlan(1, WIDE_THREADS, False, True)
    key_tiled = attn_key_tiled(m, n, head_dim, bf16)
    if key_tiled:
        warps, rows = FLASH_THREADS // 32, 16
    else:
        warps, rows = ATTN_THREADS // 32, attn_rows(head_dim, bf16)
    most = max(1, -(-m // rows) // warps)
    want = -(-2 * sms * max(1, blocks_per_sm) // (b_ * heads))
    return AttnPlan(max(1, min(most, want)), warps * 32, key_tiled)


@functools.lru_cache(maxsize=None)
def attn_forward_occupancy(lib_name: str, m: int, n: int, c: int, num_heads: int, dtype,
                           device_index: int) -> dict:
    """What the forward attention's instantiation in library ``lib_name``
    (``window_attention``, or the attention stage of ``swin_block`` or
    ``window_block``) gets at these shapes on CUDA card ``device_index``:
    registers and spill bytes per thread (ptxas), dynamic shared memory per
    block, threads per block, resident blocks per SM, J (keys a lane keeps
    of a score row; 0 on the tensor cores), the key tile (0 but for the
    key-tiled kernel, which ``attn_key_tiled`` picks, and the wide forward,
    whose scores tile it names; the wide forward reports the extremes of
    its two kernels) and the card's SMs."""
    info = (ctypes.c_longlong * 7)()
    fn = {"window_attention": "window_attention_occupancy",
          "swin_block": "swin_block_attn_occupancy",
          "window_block": "window_block_attn_occupancy"}[lib_name]
    bf16 = dtype == torch.bfloat16
    key_tiled = attn_key_tiled(m, n, c // num_heads, bf16)
    with torch.cuda.device(device_index):
        rc = getattr(_lib(lib_name), fn)(int(bf16), m, n, c, num_heads, int(key_tiled), info)
    if rc != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {rc}")
    keys = ("registers", "spill_bytes", "smem_bytes", "threads", "blocks_per_sm", "row_share", "key_tile")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return {**dict(zip(keys, info)), "sms": sms}


@functools.lru_cache(maxsize=None)
def attn_plan_for(lib_name: str, b_: int, m: int, n: int, c: int, num_heads: int, dtype,
                  device_index: int) -> AttnPlan:
    """The plan a launch of library ``lib_name``'s forward attention takes on
    card ``device_index``: ``attn_forward_plan`` over the instantiation's
    resident blocks per SM."""
    occ = attn_forward_occupancy(lib_name, m, n, c, num_heads, dtype, device_index)
    return attn_forward_plan(b_, num_heads, m, n, c // num_heads, occ["sms"], occ["blocks_per_sm"],
                             dtype == torch.bfloat16)


def _launch_window_attention(q, k, v, bias, num_heads: int) -> torch.Tensor:
    _refuse_grad("fused_window_attention", (q, k, v, bias))
    if q.device.type != "cuda":
        raise ValueError(f"the window attention kernel runs on cuda tensors, got {q.device}")
    b_, m, c = q.shape
    n = k.shape[1]
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_window_attention takes float32 or bfloat16, got {dt}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b_, n, c) or t.dtype != dt or t.device != q.device:
            raise ValueError(f"{name} must be {(b_, n, c)} {dt} on {q.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if tuple(bias.shape) != (num_heads, m, n) or bias.device != q.device:
        raise ValueError(f"bias must be {(num_heads, m, n)} on {q.device}, got {tuple(bias.shape)}")
    _check_head_dim(c, num_heads)
    lib = _lib("window_attention")
    plan = attn_plan_for("window_attention", b_, m, n, c, num_heads, dt, q.device.index)
    smem = lib.window_attention_smem_bytes(int(dt == torch.bfloat16), m, n, c, num_heads, int(plan.key_tiled))
    if smem > _MAX_SMEM:
        raise ValueError(f"shapes need {smem} B of shared memory per block (limit {_MAX_SMEM})")
    q, k, v = (t.contiguous() for t in (q, k, v))
    bias32 = bias.float().contiguous()
    out = torch.empty_like(q)
    scratch = _attn_scratch(b_, num_heads, m, n, c, q.device)
    rc = lib.window_attention_forward(
        int(dt == torch.bfloat16), b_, m, n, c, num_heads, plan.tiles, int(plan.key_tiled),
        float((c // num_heads) ** -0.5),
        *[t.data_ptr() for t in (q, k, v, bias32, out)], _ptr(scratch), _stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"window_attention kernel launch failed: CUDA error {rc}")
    launch_counts[fwd_counter("fused_window_attention", plan)] += 1
    return out


def _launch_window_block(x, params: WindowBlockParams, num_heads: int, q_ind: int):
    """Launch the block kernel: returns (out, acc), each (B_, M, C)."""
    _refuse_grad("fused_window_block", (x, *params))
    if x.device.type != "cuda":
        raise ValueError(f"the window block kernel runs on cuda tensors, got {x.device}")
    d, b_, m, c = x.shape
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_window_block takes float32 or bfloat16, got {dt}")
    _check_head_dim(c, num_heads)
    if not 0 <= q_ind < d:
        raise ValueError(f"q_ind {q_ind} outside 0..{d - 1}")
    shapes = {
        "norm_q_w": (c,), "norm_q_b": (c,), "norm_kv_w": (c,), "norm_kv_b": (c,),
        "q_w": (c, c), "q_b": (c,), "kv_w": (2 * c, c), "kv_b": (2 * c,),
        "proj_w": (c, c), "proj_b": (c,), "bias": (num_heads, m, d * m),
    }
    p = _prepare_params(params, shapes, dt, x.device)
    lib = _lib("window_block")
    plan = attn_plan_for("window_block", b_, m, d * m, c, num_heads, dt, x.device.index)
    smem = (ctypes.c_longlong * 3)()
    lib.window_block_smem_bytes(int(dt == torch.bfloat16), d, m, c, num_heads, int(plan.key_tiled), smem)
    if max(smem) > _MAX_SMEM:
        raise ValueError(f"shapes need {max(smem)} B of shared memory per block (limit {_MAX_SMEM})")

    x = x.contiguous()
    kv = torch.empty((d, b_, m, 2 * c), dtype=dt, device=x.device)
    q = torch.empty((b_, m, c), dtype=dt, device=x.device)
    acc = torch.empty((b_, m, c), dtype=dt, device=x.device)
    out = torch.empty((b_, m, c), dtype=dt, device=x.device)
    attn_scratch = _attn_scratch(b_, num_heads, m, d * m, c, x.device)
    ptrs = [
        x, p["norm_q_w"], p["norm_q_b"], p["norm_kv_w"], p["norm_kv_b"], p["q_w"], p["q_b"],
        p["kv_w"], p["kv_b"], p["proj_w"], p["proj_b"], p["bias"], kv, q, acc, out,
    ]
    rc = lib.window_block_forward(
        int(dt == torch.bfloat16), d, b_, m, c, num_heads, q_ind, plan.tiles, int(plan.key_tiled),
        float((c // num_heads) ** -0.5), *[t.data_ptr() for t in ptrs], _ptr(attn_scratch), _stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"window_block kernel launch failed: CUDA error {rc}")
    launch_counts[fwd_counter("fused_window_block", plan)] += 1
    return out, acc


# ---------------------------------------------------------------------------
# the no-grad forwards of B1 and B3 as PyTorch operators: eager calls and
# programs of ``torch.export`` run the same code, and a trace sees one node
# per block (the fake implementations give the output shapes; nothing is
# launched or counted while tracing)
# ---------------------------------------------------------------------------

OP_NAMESPACE = "bde2vid_torch"


@torch.library.custom_op(f"{OP_NAMESPACE}::swin_block", mutates_args=())
def swin_block_op(x: torch.Tensor, ctr: torch.Tensor, params: List[torch.Tensor],
                  m1: Optional[torch.Tensor], m2: Optional[torch.Tensor], num_heads: int,
                  q_ind: int, activation: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, acc) of the Swin block kernel on CUDA tensors, of
    :func:`swin_block_reference` on CPU tensors; ``params`` in
    ``SwinBlockParams`` order."""
    p = SwinBlockParams(*params)
    masks = None if m1 is None else (m1, m2)
    if x.device.type == "cpu":
        return swin_block_reference(x, ctr, p, num_heads, q_ind, activation, masks, True)
    return _launch_swin_block(x, ctr, p, num_heads, q_ind, activation, masks)


@swin_block_op.register_fake
def _(x, ctr, params, m1, m2, num_heads, q_ind, activation):
    return torch.empty_like(ctr), torch.empty_like(ctr, dtype=x.dtype)


@torch.library.custom_op(f"{OP_NAMESPACE}::window_block", mutates_args=())
def window_block_op(x: torch.Tensor, params: List[torch.Tensor], num_heads: int,
                    q_ind: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, acc) of the WindowAttention3D body kernel on CUDA tensors, of
    :func:`window_block_reference` on CPU tensors; ``params`` in
    ``WindowBlockParams`` order."""
    p = WindowBlockParams(*params)
    if x.device.type == "cpu":
        return window_block_reference(x, p, num_heads, q_ind, with_acc=True)
    return _launch_window_block(x, p, num_heads, q_ind)


@window_block_op.register_fake
def _(x, params, num_heads, q_ind):
    return torch.empty_like(x[0]), torch.empty_like(x[0])


def _block_flops(d: int, b_: int, m: int, c: int, hidden: int) -> int:
    """Multiply-adds x 2 of the products of one block call over B_ windows of
    M query rows and D*M keys: q (M x C x C), k|v (D*M x C x 2C), scores and
    the value sum (2 x M x D*M x C), the out projection (M x C x C) and, with
    ``hidden``, the MLP (2 x M x C x hidden); what ``FlopCounterMode``
    counts for the same products in the unfused body."""
    n = d * m
    per_window = m * c * c + n * c * 2 * c + 2 * m * n * c + m * c * c + 2 * m * c * hidden
    return 2 * b_ * per_window


@register_flop_formula(torch.ops.bde2vid_torch.swin_block)
def _swin_block_flops(x_shape, ctr_shape, params_shapes, *args, **kwargs) -> int:
    d, b_, m, c = x_shape
    return _block_flops(d, b_, m, c, params_shapes[SwinBlockParams._fields.index("fc1_w")][0])


@register_flop_formula(torch.ops.bde2vid_torch.window_block)
def _window_block_flops(x_shape, *args, **kwargs) -> int:
    d, b_, m, c = x_shape
    return _block_flops(d, b_, m, c, 0)


# ---------------------------------------------------------------------------
# autograd Functions and public entry points
# ---------------------------------------------------------------------------


def _wants_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
            d, _, m, c = x.shape
            attn_core_bwd_plan(m, d * m, c, num_heads)  # refuse before the forward, not in the backward
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
    :func:`swin_block_reference`, both through :func:`swin_block_op`; when
    grad mode is on and an input requires grad, the call goes through
    :class:`SwinBlockFunction`."""
    _check_device(x, "fused_swin_block")
    if masks is not None and any(t.requires_grad for t in masks):
        raise ValueError("stochastic-depth masks are constants; they must not require grad")
    m1, m2 = (None, None) if masks is None else masks
    if _wants_grad((x, ctr, *params)):
        if with_acc:
            raise ValueError("with_acc is an output of no-grad calls; the Function keeps acc itself")
        return SwinBlockFunction.apply(num_heads, q_ind, activation, x, ctr, m1, m2, *params)
    out, acc = swin_block_op(x, ctr, list(params), m1, m2, num_heads, q_ind, activation)
    return (out, acc) if with_acc else out


class WindowAttentionFunction(torch.autograd.Function):
    """The attention core with a gradient: the forward runs the kernel (twin
    on the CPU) and keeps q, k, v and bias; the backward is
    :func:`attn_core_backward` (the backward kernel on CUDA)."""

    @staticmethod
    def forward(ctx, num_heads, q, k, v, bias):
        if q.device.type == "cpu":
            out = window_attention_reference(q, k, v, bias, num_heads)
        else:
            attn_core_bwd_plan(q.shape[1], k.shape[1], q.shape[2], num_heads)  # refuse before the forward
            out = _launch_window_attention(q, k, v, bias, num_heads)
        ctx.save_for_backward(q, k, v, bias)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = attn_core_backward(q, k, v, bias, g.contiguous(), ctx.num_heads)
        return None, dq, dk, dv, dbias


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """softmax(q k^T hd^-0.5 + bias) v with the heads split over channels,
    per window: q (B_, M, C), k, v (B_, N, C), bias (H, M, N) f32 ->
    (B_, M, C) in q.dtype. CUDA tensors launch the hand-written kernel, CPU
    tensors run :func:`window_attention_reference`; when grad mode is on and
    an input requires grad, the call goes through
    :class:`WindowAttentionFunction`."""
    _check_device(q, "fused_window_attention")
    if _wants_grad((q, k, v, bias)):
        return WindowAttentionFunction.apply(num_heads, q, k, v, bias)
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, bias, num_heads)
    return _launch_window_attention(q, k, v, bias, num_heads)


class WindowBlockFunction(torch.autograd.Function):
    """The WindowAttention3D body with a gradient: the forward runs the block
    (kernel on CUDA, twin on the CPU) and keeps ``acc``; the backward is the
    hybrid of ``_window_block_bwd``: autograd of the ``pre`` stage and of the
    out projection around :func:`attn_core_backward`. ``bias`` gets the
    summed dbias, so the gradient reaches the relative-position table
    through the caller's gather."""

    @staticmethod
    def forward(ctx, num_heads, q_ind, x, *params):
        p = WindowBlockParams(*params)
        if x.device.type == "cpu":
            out, acc = window_block_reference(x, p, num_heads, q_ind, with_acc=True)
        else:
            d, _, m, c = x.shape
            attn_core_bwd_plan(m, d * m, c, num_heads)  # refuse before the forward
            out, acc = _launch_window_block(x, p, num_heads, q_ind)
        ctx.save_for_backward(x, acc, *params)
        ctx.cfg = (num_heads, q_ind)
        return out

    @staticmethod
    def backward(ctx, g):
        num_heads, q_ind = ctx.cfg
        x, acc, *params = ctx.saved_tensors
        p = WindowBlockParams(*params)

        def leaf(t):
            return t.detach().requires_grad_()

        with torch.enable_grad():
            x_l = leaf(x)
            pre = {n: leaf(getattr(p, n)) for n in _PRE}
            q, k, v = _pre_stage(x_l, x_l[q_ind], p._replace(**pre), num_heads, q_ind)
            acc_l, pw, pb = leaf(acc), leaf(p.proj_w), leaf(p.proj_b)
            out = _post(acc_l, p._replace(proj_w=pw, proj_b=pb), x.dtype)
        dacc, dpw, dpb = torch.autograd.grad(out, [acc_l, pw, pb], g)
        dq, dk, dv, dbias = attn_core_backward(
            q.detach(), k.detach(), v.detach(), p.bias.detach(), dacc, num_heads)
        dx, *dpre = torch.autograd.grad((q, k, v), [x_l, *pre.values()], (dq, dk, dv))
        grads = {**dict(zip(_PRE, dpre)), "proj_w": dpw, "proj_b": dpb, "bias": dbias}
        return (None, None, dx, *[grads[n] for n in WindowBlockParams._fields])


def fused_window_block(x: torch.Tensor, params: WindowBlockParams, num_heads: int, q_ind: int,
                       with_acc: bool = False):
    """The WindowAttention3D body per window: x (D, B_, M, C) -> (B_, M, C)
    (LN_q on ``x[q_ind]``, LN_kv on all D frames, q and k|v projections,
    attention, out projection), and with ``with_acc`` also ``acc``. CUDA
    tensors launch the hand-written kernel, CPU tensors run
    :func:`window_block_reference`, both through :func:`window_block_op`;
    when grad mode is on and an input requires grad, the call goes through
    :class:`WindowBlockFunction`."""
    _check_device(x, "fused_window_block")
    if _wants_grad((x, *params)):
        if with_acc:
            raise ValueError("with_acc is an output of no-grad calls; the Function keeps acc itself")
        return WindowBlockFunction.apply(num_heads, q_ind, x, *params)
    out, acc = window_block_op(x, list(params), num_heads, q_ind)
    return (out, acc) if with_acc else out
