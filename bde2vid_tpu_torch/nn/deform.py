"""Deformable convolution and the alignment blocks built on it (counterpart
of ``bde2vid_tpu/nn/deform.py``; reference mmcv ``deform_conv2d`` and the
blocks AlignAdd / AlignAdd2 / SepDconv / GatedAdd of
model/submodules.py:267-300, 491-650).

NCHW with mmcv's layout: offsets are (N, dg*2*K, Ho, Wo), ordered ``[y0,
x0, y1, x1, ...]`` per deform group, and the weight is (O, C, kh, kw). The
convolution is a bilinear gather with zero padding into an im2col tensor
(N, C*K, Ho*Wo), then one ``torch.matmul`` with the (O, C*K) weight;
sampling only reads, so autograd's backward of the gather is the scatter.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from bde2vid_tpu_torch.nn.layers import Conv2d, ConvLayer


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 0,
                  dilation: int = 1, deform_groups: int = 1) -> torch.Tensor:
    """(N, C, H, W) sampled at the kernel taps moved by ``offsets`` ->
    (N, O, Ho, Wo); samples outside the image read zero."""
    n, c, h, w = x.shape
    out_ch, _, kh, kw = weight.shape
    k = kh * kw
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    dev = x.device

    # the taps' base positions (K, Ho, Wo), tap index ki * kw + kj
    oy = torch.arange(ho, dtype=torch.float32, device=dev) * stride - padding
    ox = torch.arange(wo, dtype=torch.float32, device=dev) * stride - padding
    ky = torch.arange(kh, dtype=torch.float32, device=dev) * dilation
    kx = torch.arange(kw, dtype=torch.float32, device=dev) * dilation
    base_y = (ky[:, None, None, None] + oy[None, None, :, None]).expand(kh, kw, ho, wo)
    base_x = (kx[None, :, None, None] + ox[None, None, None, :]).expand(kh, kw, ho, wo)

    off = offsets.reshape(n, deform_groups, k, 2, ho, wo)
    py = base_y.reshape(k, ho, wo) + off[:, :, :, 0]  # (N, dg, K, Ho, Wo)
    px = base_x.reshape(k, ho, wo) + off[:, :, :, 1]
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    dy = (py - y0).reshape(n, deform_groups, 1, -1)
    dx = (px - x0).reshape(n, deform_groups, 1, -1)

    cg = c // deform_groups
    xg = x.reshape(n, deform_groups, cg, h * w)

    def fetch(yi, xi):
        """(N, dg, cg, K*Ho*Wo) values at integer corners, zero outside."""
        inb = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).reshape(n, deform_groups, 1, -1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().reshape(n, deform_groups, 1, -1)
        vals = torch.gather(xg, 3, idx.expand(n, deform_groups, cg, idx.shape[-1]))
        return vals * inb.to(x.dtype)

    patches = (fetch(y0, x0) * (1 - dy) * (1 - dx) + fetch(y0, x0 + 1) * (1 - dy) * dx
               + fetch(y0 + 1, x0) * dy * (1 - dx) + fetch(y0 + 1, x0 + 1) * dy * dx)
    # (N, dg, cg, K * Ho*Wo) -> (N, C*K, Ho*Wo), channel-major as the weight's (O, C, kh, kw)
    patches = patches.reshape(n, c * k, ho * wo)
    out = torch.matmul(weight.reshape(out_ch, c * k).to(patches.dtype), patches)
    out = out.reshape(n, out_ch, ho, wo)
    if bias is not None:
        out = out + bias.to(out.dtype)[:, None, None]
    return out


def _lecun_normal_(t: torch.Tensor) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated normal of variance 1 / fan_in."""
    std = math.sqrt(1.0 / (t[0].numel())) / 0.87962566103423978
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std)


def _offset_conv(in_channels: int, deform_groups: int, k: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1) -> Conv2d:
    """The zero-initialised offset predictor, so a block starts as a plain conv."""
    conv = Conv2d(in_channels, deform_groups * 2 * k * k, k, stride, padding, dilation)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class DeformConv2dPack(nn.Module):
    """mmcv DeformConv2dPack: ``conv_offset`` predicts the offsets from the
    input, or from ``offset_input`` (of ``offset_channels``) when given; no
    bias by default."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 0, dilation: int = 1, deform_groups: int = 1,
                 use_bias: bool = False, offset_channels: Optional[int] = None):
        super().__init__()
        k = kernel_size
        self.geometry = (stride, padding, dilation, deform_groups)
        self.conv_offset = _offset_conv(offset_channels or in_channels, deform_groups, k, stride,
                                        padding, dilation)
        self.weight = nn.Parameter(_lecun_normal_(torch.empty(features, in_channels, k, k)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor, offset_input: Optional[torch.Tensor] = None) -> torch.Tensor:
        stride, padding, dilation, dg = self.geometry
        offsets = self.conv_offset(x if offset_input is None else offset_input)
        return deform_conv2d(x, offsets, self.weight, self.bias, stride=stride, padding=padding,
                             dilation=dilation, deform_groups=dg)


class AlignAdd(nn.Module):
    """Channels halved: the first half deform-aligned (offsets from it),
    plus the second (model/submodules.py:267-283)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3):
        super().__init__()
        self.dconv = DeformConv2dPack(in_channels // 2, features, kernel_size,
                                      padding=kernel_size // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = x.chunk(2, dim=1)
        return self.dconv(x1) + x2


class AlignAdd2(nn.Module):
    """Offsets from the whole input, the deform conv on its first half, plus
    the second half (model/submodules.py:491-545)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 deform_groups: int = 1):
        super().__init__()
        self.pack = DeformConv2dPack(in_channels // 2, features, kernel_size,
                                     padding=kernel_size // 2, deform_groups=deform_groups,
                                     offset_channels=in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ifeat, efeat = x.chunk(2, dim=1)
        return self.pack(ifeat, offset_input=x) + efeat


class SepDconv(nn.Module):
    """A deform conv whose offsets come from a separate tensor, plus
    ``init_offset`` when given; returns the offsets too, for cascades
    (model/submodules.py:573-650)."""

    def __init__(self, offset_channels: int, in_channels: int, features: int,
                 kernel_size: int = 3, deform_groups: int = 1):
        super().__init__()
        k = kernel_size
        self.deform_groups = deform_groups
        self.conv_offset = _offset_conv(offset_channels, deform_groups, k, padding=k // 2)
        self.weight = nn.Parameter(_lecun_normal_(torch.empty(features, in_channels, k, k)))

    def forward(self, offset_x: torch.Tensor, x: torch.Tensor,
                init_offset: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        offsets = self.conv_offset(offset_x)
        if init_offset is not None:
            offsets = offsets + init_offset
        k = self.weight.shape[-1]
        out = deform_conv2d(x, offsets, self.weight, None, padding=k // 2,
                            deform_groups=self.deform_groups)
        return out, offsets


class GatedAdd(nn.Module):
    """A sigmoid gate (``gate0``), the halves added, then ``conv``, a
    ConvLayer (model/submodules.py:552-570)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3):
        super().__init__()
        k = kernel_size
        self.gate0 = Conv2d(in_channels, in_channels, k, padding=k // 2)
        self.conv = ConvLayer(in_channels // 2, features, k, padding=k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * torch.sigmoid(self.gate0(x))
        x1, x2 = x.chunk(2, dim=1)
        return self.conv(x1 + x2)
