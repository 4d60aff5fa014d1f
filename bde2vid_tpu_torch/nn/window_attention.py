"""Temporal-window cross-frame attention (BDE2VID's DFrameAttention);
counterpart of ``bde2vid_tpu/nn/window_attention.py``.

Reference: model/BDE2VID/DTransformer.py — window partition/reverse
:40-86, WindowAttention3D :95-207, SwinTransformerBlock3D :210-306,
DFrameAttention :309-389.

Token tensors are channels-last, as in the JAX package: ``x: (D, B, H, W, C)``
and windows ``(D, B*nW, Wh, Ww, C)``. Module parameter names follow the
reference torch state dict (``attn.q.weight``, ``mlp.fc1.weight``, ...).

With ``use_kernel`` a block runs whole in one call of
``ops.window_attn_cuda.fused_swin_block`` (the CUDA kernels on CUDA tensors,
their plain twins on CPU tensors, differentiable either way). A dilated
block whose window has an even side cannot: its windows overlap, and the
fold sums their attention outputs before the residual. It runs the unfused
body around ``ops.window_attn_cuda.fused_window_block`` (the
WindowAttention3D body) instead. Without ``use_kernel``, or with the
``nwindow_size`` KV token reduction, the unfused PyTorch body runs.

The dilated partition and its reverse (the reference's F.unfold / F.fold)
are gathers over static index maps in both directions, forward and
backward: where even windows make taps collide, the sum runs over a fixed
list of at most four taps per pixel, so the result does not depend on the
order of atomic adds.

Stochastic depth (timm DropPath, JAX ``_drop_path``) acts per sample in
training mode: the attention branch's mask is drawn first, the MLP branch's
second, from a ``torch.Generator`` the caller passes in; both paths draw the
same two masks, so with one generator seed they give the same result.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils._python_dispatch import _disable_current_modes

from bde2vid_tpu_torch.nn.layers import Conv2d, LayerNorm, Linear, get_activation
from bde2vid_tpu_torch.ops.window_attn_cuda import (
    SwinBlockParams,
    WindowBlockParams,
    fused_swin_block,
    fused_window_block,
)

# ---------------------------------------------------------------------------
# window partition / reverse
# ---------------------------------------------------------------------------


def window_partition(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """(D, B, H, W, C) -> (D, B*nW, Wh, Ww, C), row-major window order."""
    d, b, h, w, c = x.shape
    wh, ww = window
    x = x.reshape(d, b, h // wh, wh, w // ww, ww, c)
    x = x.permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(d, -1, wh, ww, c)


def window_reverse(windows: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, Wh, Ww, C) -> (B, H, W, C)."""
    _, wh, ww, c = windows.shape
    x = windows.reshape(b, h // wh, w // ww, wh, ww, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@functools.lru_cache(maxsize=64)
def _dilated_indices(h: int, w: int, wh: int, ww: int):
    """Index maps replicating F.unfold(kernel=win, dilation=2, stride=win) on
    an input padded by (+ww right, +wh bottom) (DTransformer.py:55-60).
    Returns (row_idx, col_idx) of shape (nWh, Wh) / (nWw, Ww) into the padded
    grid, the padded dims and the window counts."""
    hp, wp = h + wh, w + ww
    n_wh = (hp - 2 * (wh - 1) - 1) // wh + 1
    n_ww = (wp - 2 * (ww - 1) - 1) // ww + 1
    rows = np.arange(n_wh)[:, None] * wh + 2 * np.arange(wh)[None, :]
    cols = np.arange(n_ww)[:, None] * ww + 2 * np.arange(ww)[None, :]
    return rows, cols, hp, wp, n_wh, n_ww


@functools.lru_cache(maxsize=64)
def _dilated_flat_index(h: int, w: int, wh: int, ww: int):
    """Flat gather map (nWh, nWw, Wh, Ww) -> padded position row*wp+col, in
    the partition's output order."""
    rows, cols, hp, wp, n_wh, n_ww = _dilated_indices(h, w, wh, ww)
    flat = rows[:, None, :, None] * wp + cols[None, :, None, :]
    return flat.reshape(-1), hp, wp, n_wh, n_ww


@functools.lru_cache(maxsize=64)
def _dilated_reverse_map(h: int, w: int, wh: int, ww: int):
    """(inv, n_el, has_collisions): ``inv`` (h, w) maps each position to the
    flat window-token index that writes it, or ``n_el`` where no dilated
    window samples it (torch F.fold leaves zeros there). Even windows
    collide (fold sums taps) and return ``inv=None``."""
    flat, hp, wp, n_wh, n_ww = _dilated_flat_index(h, w, wh, ww)
    n_el = flat.size
    if np.unique(flat).size != n_el:
        return None, n_el, True
    inv = np.full(hp * wp, n_el, np.int64)
    inv[flat] = np.arange(n_el, dtype=np.int64)
    return inv.reshape(hp, wp)[:h, :w], n_el, False


@functools.lru_cache(maxsize=64)
def _dilated_covered_mask(h: int, w: int, wh: int, ww: int) -> tuple:
    """(h, w) bool mask of positions sampled by any dilation-2 window, and
    whether that is all of them."""
    rows, cols, hp, wp, n_wh, n_ww = _dilated_indices(h, w, wh, ww)
    rr = np.unique(rows.reshape(-1))
    cc = np.unique(cols.reshape(-1))
    mask = np.zeros((h, w), bool)
    mask[np.ix_(rr[rr < h], cc[cc < w])] = True
    return mask, bool(mask.all())


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.long, device=device)


# The gathers below index with static maps. Each map is uploaded once per
# device and kept: a fresh host-to-device copy per call would stall the
# stream behind every kernel queued before it. The upload runs outside every
# dispatch mode, so the cache holds real tensors only: under torch.export's
# fake-tensor mode a tensor made in place would be a fake one, which the
# next eager call and the next export would read from the cache; a real one
# is a constant of the exported program, already on its device.
_UPLOADED: dict = {}


def _device_index(key: tuple, device, make) -> torch.Tensor:
    """``make()``, the NumPy map named by ``key``, as an int64 tensor on ``device``."""
    key = (*key, torch.device(device))
    t = _UPLOADED.get(key)
    if t is None:
        with _disable_current_modes():
            t = _UPLOADED[key] = _index(make(), device)
    return t


def _partition_index(h: int, w: int, wh: int, ww: int, device: torch.device) -> torch.Tensor:
    return _device_index(("partition", h, w, wh, ww), device,
                         lambda: _dilated_flat_index(h, w, wh, ww)[0])


@functools.lru_cache(maxsize=64)
def _dilated_taps(h: int, w: int, wh: int, ww: int) -> np.ndarray:
    """(hp*wp, K) window-token indices that sample each padded position, in
    ascending order, filled with n_el (a zero row): the fold's taps. K is 1
    for odd windows; even windows overlap, up to 2 x 2 of them per pixel."""
    flat, hp, wp, _, _ = _dilated_flat_index(h, w, wh, ww)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=hp * wp)
    taps = np.full((hp * wp, counts.max()), flat.size, np.int64)
    rank = np.arange(flat.size) - (np.cumsum(counts) - counts)[flat[order]]
    taps[flat[order], rank] = order
    return taps


def _taps_index(h: int, w: int, wh: int, ww: int, device: torch.device) -> torch.Tensor:
    return _device_index(("taps", h, w, wh, ww), device, lambda: _dilated_taps(h, w, wh, ww))


def _fold(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """(..., n_el, C) window tokens -> (..., P, C): each position sums its
    taps in the fixed order of ``taps`` (P, K)."""
    x = torch.cat([x, x.new_zeros(*x.shape[:-2], 1, x.shape[-1])], dim=-2)
    out = x.index_select(-2, taps[:, 0])
    for t in range(1, taps.shape[1]):
        out = out + x.index_select(-2, taps[:, t])
    return out


class _DilatedGather(torch.autograd.Function):
    """Partition: (..., P, C) padded map -> (..., n_el, C) window tokens by
    the flat map; the backward folds the cotangent over the taps."""

    @staticmethod
    def forward(ctx, xf, flat, taps):
        ctx.save_for_backward(taps)
        return xf.index_select(-2, flat)

    @staticmethod
    def backward(ctx, g):
        (taps,) = ctx.saved_tensors
        return _fold(g, taps), None, None


class _DilatedFold(torch.autograd.Function):
    """Reverse: (..., n_el, C) window tokens -> (..., P, C) summed over each
    position's taps; the backward gathers each token's position."""

    @staticmethod
    def forward(ctx, x, flat, taps):
        ctx.save_for_backward(flat)
        return _fold(x, taps)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        return g.index_select(-2, flat), None, None


def _bias_rows(wd: int, wh: int, ww: int, h: int, w: int, q_ind: int, n: int,
               device: torch.device) -> torch.Tensor:
    m = h * w
    return _device_index(
        ("bias_rows", wd, wh, ww, h, w, q_ind, n), device,
        lambda: relative_position_index(wd, wh, ww, h, w)[q_ind * m : (q_ind + 1) * m, :n].reshape(-1))


@functools.lru_cache(maxsize=64)
def _blend_maps(hp: int, wp: int, wh: int, ww: int, crop: Tuple[int, int, int, int]):
    """(uncovered positions or None, gather map) for the fused dilated block:
    covered pixels read their window token, uncovered pixels read rows
    appended after the n_el window tokens; the map is cropped by ``crop``."""
    inv, n_el, _ = _dilated_reverse_map(hp, wp, wh, ww)
    mask, full = _dilated_covered_mask(hp, wp, wh, ww)
    idx = inv.reshape(-1).copy()
    unc = None
    if not full:
        unc = np.flatnonzero(~mask.reshape(-1))
        idx[unc] = n_el + np.arange(unc.size)
    pt, pb, pl, pr = crop
    return unc, idx.reshape(hp, wp)[pt : hp - pb, pl : wp - pr].reshape(-1)


def _blend_index(hp: int, wp: int, wh: int, ww: int, crop: Tuple[int, int, int, int],
                 device: torch.device):
    """``_blend_maps`` on ``device``."""
    args = (hp, wp, wh, ww, crop)
    unc, idx = _blend_maps(*args)
    if unc is not None:
        unc = _device_index(("blend_unc", *args), device, lambda: unc)
    return unc, _device_index(("blend_idx", *args), device, lambda: idx)


def window_partition_dilated(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """(D, B, H, W, C) -> (D, B*nW, Wh, Ww, C) with dilation-2 sampling, as
    one gather into window-token order."""
    d, b, h, w, c = x.shape
    wh, ww = window
    hp, wp = h + wh, w + ww
    xf = F.pad(x, (0, 0, 0, ww, 0, wh)).reshape(d, b, hp * wp, c)
    flat = _partition_index(h, w, wh, ww, x.device)
    taps = _taps_index(h, w, wh, ww, x.device)
    return _DilatedGather.apply(xf, flat, taps).reshape(d, -1, wh, ww, c)


def window_reverse_dilated(windows: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """Inverse of window_partition_dilated (torch F.fold then crop :80-85):
    each pixel sums the window tokens that sampled it (one for odd windows,
    up to four for even ones), zero where none did."""
    _, wh, ww, c = windows.shape
    hp, wp = h + wh, w + ww
    flat = _partition_index(h, w, wh, ww, windows.device)
    taps = _taps_index(h, w, wh, ww, windows.device)
    out = _DilatedFold.apply(windows.reshape(b, -1, c), flat, taps)
    return out.reshape(b, hp, wp, c)[:, :h, :w]


def get_window_size(x_size, window_size):
    """Shrink the window to the feature size where needed (reference :89-95)."""
    return tuple(min(a, b) for a, b in zip(x_size, window_size))


@functools.lru_cache(maxsize=64)
def relative_position_index(
    wd: int, wh: int, ww: int, h: Optional[int] = None, w: Optional[int] = None
) -> np.ndarray:
    """(Wd*h*w, Wd*h*w) index into the (2Wd-1)(2Wh-1)(2Ww-1) bias table
    (reference :137-155). ``(h, w)`` is the actual window when
    get_window_size shrank it below the configured ``(wh, ww)``: offsets
    come from the actual token grid, table strides from the configured
    dims."""
    h = wh if h is None else h
    w = ww if w is None else w
    coords = np.stack(
        np.meshgrid(np.arange(wd), np.arange(h), np.arange(w), indexing="ij")
    ).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class WindowAttention3D(nn.Module):
    """Cross-frame window attention: q from the centre frame's window
    tokens, k/v from all D frames', or with ``nwin_size`` from the
    ``reduction_conv`` KV tokens of each frame's window (reference
    :129,172-176)."""

    def __init__(self, dim: int, window_size: Tuple[int, int, int], num_heads: int,
                 q_ind: Optional[int] = None, qkv_bias: bool = True,
                 nwin_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.dim = dim
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        wd, wh, ww = self.window_size
        self.q_ind = wd // 2 if q_ind is None else q_ind
        self.nwin_size = None if nwin_size is None else tuple(nwin_size)
        self.norm_q = LayerNorm(dim)
        self.norm_kv = LayerNorm(dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads)
        )
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        # kept for the reference state-dict layout; the bias rows below are
        # indexed for the actual (possibly shrunk) window instead
        self.register_buffer(
            "relative_position_index", torch.as_tensor(relative_position_index(wd, wh, ww))
        )
        if self.nwin_size is not None:
            # one grouped conv over the whole window gives ntok tokens per channel
            ntok = self.nwin_size[0] * self.nwin_size[1]
            self.reduction_conv = Conv2d(dim, ntok * dim, (wh, ww), groups=dim)
        self.q = Linear(dim, dim, bias=qkv_bias)
        self.kv = Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def bias(self, h: int, w: int, n: int) -> torch.Tensor:
        """(H, M, N) f32 relative-position bias for an (h, w) window and N kv
        tokens: index rows of the query frame, the first N columns
        (reference :195-199)."""
        table = self.relative_position_bias_table.float()
        rows = _bias_rows(*self.window_size, h, w, self.q_ind, n, table.device)
        return table[rows].reshape(h * w, n, self.num_heads).permute(2, 0, 1)

    def kernel_params(self, h: int, w: int, d: int) -> WindowBlockParams:
        """The kernels' weights for an (h, w) window over d frames; without
        qkv biases the q and k|v biases are zeros, which the kernels add as
        no bias."""
        c = self.dim
        zeros = functools.partial(torch.zeros, device=self.q.weight.device, dtype=self.q.weight.dtype)
        q_b = zeros(c) if self.q.bias is None else self.q.bias
        kv_b = zeros(2 * c) if self.kv.bias is None else self.kv.bias
        return WindowBlockParams(
            self.norm_q.weight, self.norm_q.bias, self.norm_kv.weight, self.norm_kv.bias,
            self.q.weight, q_b, self.kv.weight, kv_b, self.proj.weight, self.proj.bias,
            self.bias(h, w, d * h * w),
        )

    def forward(self, x: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
        """(D, B_, Wh, Ww, C) window stacks -> (B_, Wh, Ww, C). ``use_kernel``
        runs the body in one ``fused_window_block`` call (not with the KV
        token reduction, as in the JAX package)."""
        d, b_, h, w, c = x.shape
        if use_kernel and self.nwin_size is None:
            out = fused_window_block(x.reshape(d, b_, h * w, c), self.kernel_params(h, w, d),
                                     self.num_heads, self.q_ind)
            return out.reshape(b_, h, w, c)
        hd = c // self.num_heads
        if self.nwin_size is not None:
            if (h, w) != self.window_size[1:]:
                raise ValueError(f"the KV token reduction needs the full {self.window_size[1:]} "
                                 f"window (its conv kernel), got {(h, w)}")
            # the reference reshapes the group-major conv output (C groups of
            # ntok) as (ntok, C), mixing channel and token axes; kept for parity
            red = self.reduction_conv(x.reshape(-1, h, w, c).permute(0, 3, 1, 2))
            kv_tok = red.reshape(d, b_, -1, c)
        else:
            kv_tok = x.reshape(d, b_, h * w, c)
        q_tok = self.norm_q(x[self.q_ind].reshape(b_, h * w, c))
        kv_tok = self.norm_kv(kv_tok.permute(1, 0, 2, 3).reshape(b_, -1, c))
        m, n = q_tok.shape[1], kv_tok.shape[1]
        k, v = self.kv(kv_tok).chunk(2, dim=-1)

        def heads(t):
            return t.reshape(b_, -1, self.num_heads, hd).transpose(1, 2)

        attn = (heads(self.q(q_tok)) * hd**-0.5) @ heads(k).transpose(-2, -1)
        attn = torch.softmax(attn + self.bias(h, w, n)[None].to(attn.dtype), dim=-1)
        out = (attn @ heads(v)).transpose(1, 2).reshape(b_, m, c)
        return self.proj(out).reshape(b_, h, w, c)


class Mlp(nn.Module):
    """fc1 -> act -> fc2 (reference DTransformer.py:19-37)."""

    def __init__(self, in_features: int, hidden: int, activation: str = "gelu"):
        super().__init__()
        self.fc1 = Linear(in_features, hidden)
        self.fc2 = Linear(hidden, in_features)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class SwinTransformerBlock3D(nn.Module):
    """Windowed attention with a centre-frame residual, then an MLP residual
    (reference :210-306; norm1 is commented out in the reference too)."""

    def __init__(self, dim: int, num_heads: int, window_size=(3, 8, 8), dilate_win: bool = False,
                 q_ind: Optional[int] = None, activation: str = "gelu", use_kernel: bool = False,
                 drop_path: float = 0.0, nwindow_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.dilate_win = dilate_win
        self.q_ind = self.window_size[0] // 2 if q_ind is None else q_ind
        self.activation = activation
        self.use_kernel = use_kernel
        self.drop_path = float(drop_path)
        self.attn = WindowAttention3D(dim, self.window_size, num_heads, q_ind=self.q_ind,
                                      nwin_size=nwindow_size)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim, activation)  # mlp_ratio 4 (reference default)

    def keep_masks(self, b: int, device, generator: Optional[torch.Generator]):
        """The two per-sample stochastic-depth multipliers (attention branch,
        then MLP branch), each (b,) f32 in {0, 1/keep}; None in eval mode or
        at drop_path 0."""
        if not self.training or self.drop_path == 0.0:
            return None
        if generator is None:
            raise ValueError("a training block with drop_path > 0 needs a torch.Generator")
        keep = 1.0 - self.drop_path
        probs = torch.full((b,), keep, device=device)
        return tuple(torch.bernoulli(probs, generator=generator) / keep for _ in range(2))

    def forward(self, x: torch.Tensor, center: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (D, B, H, W, C). With ``center`` (B, H, W, C) the buffer's q_ind
        row is stale and ``center`` is the live centre frame. Returns the new
        centre (B, H, W, C). ``generator`` draws the DropPath masks in
        training mode."""
        d, b, h, w, c = x.shape
        win = get_window_size((h, w), self.window_size[-2:])
        masks = self.keep_masks(b, x.device, generator)
        kernel = self.use_kernel and self.attn.nwin_size is None
        # even dilated windows overlap: the fold sums their attention outputs
        # before the residual, so the whole block cannot run per window
        even_dilated = self.dilate_win and (win[0] % 2 == 0 or win[1] % 2 == 0)
        if kernel and not even_dilated:
            return self._fused_full(x, x[self.q_ind] if center is None else center, win, masks)
        if center is not None:
            x = torch.cat([x[: self.q_ind], center[None], x[self.q_ind + 1 :]])
        shortcut = x[self.q_ind]
        pt, pb, pl, pr = _window_pads(h, w, win)
        xp = F.pad(x, (0, 0, pl, pr, pt, pb))
        hp, wp = h + pt + pb, w + pl + pr
        part = window_partition_dilated if self.dilate_win else window_partition
        attn = self.attn(part(xp, win), use_kernel=kernel)
        if self.dilate_win:
            y = window_reverse_dilated(attn, b, hp, wp)
        else:
            y = window_reverse(attn, b, hp, wp)
        y = y[:, pt : hp - pb, pl : wp - pr]
        if masks is None:
            y = shortcut + y
            return y + self.mlp(self.norm2(y))
        m1, m2 = (mk.to(y.dtype).view(b, 1, 1, 1) for mk in masks)
        y = shortcut + m1 * y
        return y + m2 * self.mlp(self.norm2(y))

    def kernel_params(self, h: int, w: int, d: int) -> SwinBlockParams:
        p = self.attn.kernel_params(h, w, d)
        return SwinBlockParams(
            *p[:10], self.norm2.weight, self.norm2.bias,
            self.mlp.fc1.weight, self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias, p.bias,
        )

    def _fused_full(self, x: torch.Tensor, center: torch.Tensor, win, masks=None) -> torch.Tensor:
        """The whole block in one fused_swin_block call. Per-token ops commute
        with the window permutation, so the block's output tokens reverse
        straight to the new centre frame. ``masks``: the per-sample DropPath
        multipliers, repeated per window for the kernel (windows are
        sample-major in partition order)."""
        d, b, h, w, c = x.shape
        pt, pb, pl, pr = _window_pads(h, w, win)
        pads = (0, 0, pl, pr, pt, pb)
        xp = F.pad(x, pads)
        cp = F.pad(center[None], pads)
        hp, wp = h + pt + pb, w + pl + pr
        part = window_partition_dilated if self.dilate_win else window_partition
        xwin = part(xp, win)
        ctr_tok = part(cp, win)[0].reshape(-1, win[0] * win[1], c)
        x_tok = xwin.reshape(d, -1, win[0] * win[1], c)
        n_w = x_tok.shape[1] // b
        win_masks = None if masks is None else tuple(mk.repeat_interleave(n_w) for mk in masks)
        out = fused_swin_block(
            x_tok, ctr_tok, self.kernel_params(win[0], win[1], d),
            self.attn.num_heads, self.q_ind, self.activation, masks=win_masks,
        )
        if not self.dilate_win:
            y = window_reverse(out.reshape(-1, win[0], win[1], c), b, hp, wp)
            return y[:, pt : hp - pb, pl : wp - pr]
        # fold + uncovered-pixel blend + crop as one gather: covered pixels
        # read their window token; pixels no dilated window samples (the
        # reference's fold writes zeros there, DTransformer.py:80-85) pass
        # the block as center + MLP(LN2(center)), computed on those pixels only
        unc, idx = _blend_index(hp, wp, win[0], win[1], (pt, pb, pl, pr), x.device)
        src = out.reshape(b, -1, c)
        if unc is not None:
            cf = cp[0].reshape(b, hp * wp, c)[:, unc].float()
            z = F.layer_norm(cf, (c,), self.norm2.weight.float(), self.norm2.bias.float(), 1e-5)
            dt = x.dtype
            fc1, fc2 = self.mlp.fc1, self.mlp.fc2
            hid = get_activation(self.activation)(
                F.linear(z.to(dt), fc1.weight.to(dt)).float() + fc1.bias.float()
            )
            mlp_out = F.linear(hid.to(dt), fc2.weight.to(dt)).float() + fc2.bias.float()
            if masks is not None:
                # no attention reaches these pixels (the fold writes zeros),
                # but their MLP branch still carries the DropPath mask
                mlp_out = masks[1][:, None, None] * mlp_out
            src = torch.cat([src, (cf + mlp_out).to(src.dtype)], dim=1)
        return src[:, idx].reshape(b, h, w, c)


def _window_pads(h: int, w: int, win) -> Tuple[int, int, int, int]:
    """Centred (top, bottom, left, right) pads to window multiples (reference :260-265)."""
    pad_h = (win[0] - h % win[0]) % win[0]
    pad_w = (win[1] - w % win[1]) % win[1]
    return pad_h // 2, pad_h - pad_h // 2, pad_w // 2, pad_w - pad_w // 2


class DFrameAttention(nn.Module):
    """Stack of Swin blocks over a temporal buffer of D frames; each block's
    output becomes the new centre frame (reference :309-389). Odd blocks use
    dilation-2 windows. Input (D, B, H, W, C) -> output (B, H, W, C)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size=(1, 7, 7),
                 q_ind: Optional[int] = None, activation: str = "gelu", use_kernel: bool = False,
                 drop_path: Sequence[float] = (), nwindow_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.q_ind = window_size[0] // 2 if q_ind is None else q_ind
        self.blocks = nn.ModuleList(
            SwinTransformerBlock3D(dim, num_heads, window_size, dilate_win=(i % 2 == 1),
                                   q_ind=self.q_ind, activation=activation, use_kernel=use_kernel,
                                   drop_path=drop_path[i] if i < len(drop_path) else 0.0,
                                   nwindow_size=nwindow_size)
            for i in range(depth)
        )

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        center = x[self.q_ind]
        for blk in self.blocks:
            center = blk(x, center=center, generator=generator)
        return center


def set_attention_kernel(module: nn.Module, enabled: bool) -> None:
    """Switch every Swin block under ``module`` between the kernel path
    (``fused_swin_block``, or ``fused_window_block`` for even dilated
    windows) and the unfused PyTorch body. Parameters are untouched."""
    for m in module.modules():
        if isinstance(m, SwinTransformerBlock3D):
            m.use_kernel = bool(enabled)
