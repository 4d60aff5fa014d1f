"""Convolutional building blocks (counterpart of ``bde2vid_tpu/nn/layers.py``).

NCHW tensors and torch padding (``padding=k//2``), so the reference
checkpoint layout (``conv2d.weight`` in OIHW, ``norm_layer.running_mean``)
loads as is.

The layers take their weights to the input's type at use, as flax's
``dtype`` does: a bf16 input computes in bf16 while f32 master weights get
their gradients in f32 (bf16 training). With weights already in the input's
type (f32, or a model cast to bf16 for eval) the cast is a no-op. Norms take
their statistics and affine in f32 and return the input's type, as flax's
do.

Under ``parallel.spatial.row_sharded`` (the spatially sharded forward) the
input holds this rank's band of rows: convs, transposed convs and resizes
first fetch the rows their kernel reaches past the band, and the norms sum
their statistics over the "spatial" group, so each band gets what the
whole map gives it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from bde2vid_tpu_torch.nn.remat import recomputing
from bde2vid_tpu_torch.parallel import spatial

_ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": F.relu6,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "lrelu": lambda x: F.leaky_relu(x, 0.01),
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="none"),  # exact erf, nn.GELU's default
    "softplus": F.softplus,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Name -> function; 'default' is relu and None is the identity."""
    if name is None:
        return _ACTIVATIONS["identity"]
    if name == "default":
        return _ACTIVATIONS["relu"]
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with its weight and bias cast to the input's type at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), _cast(self.bias, x.dtype)
        (kh, _), (sh, _), (ph, pw) = self.kernel_size, self.stride, self.padding
        if spatial.current() is None or (kh, sh, ph) == (1, 1, 0):
            return self._conv_forward(x, w, b)
        x = spatial.conv_input(x, kh, sh, ph, self.dilation[0])
        return F.conv2d(x, w, b, self.stride, (0, pw), self.dilation, self.groups)


class Linear(nn.Linear):
    """nn.Linear with its weight and bias cast to the input's type at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm taken in f32 and returned in the input's type (flax
    LayerNorm at ``dtype``: f32 statistics and affine, one cast at the end)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, _cast(self.weight, torch.float32),
                            _cast(self.bias, torch.float32), self.eps).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm as flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``
    (JAX ``nn/layers.py::_make_norm``): in training mode it normalises with
    the batch's mean and biased variance over (N, H, W) and moves the
    running statistics 0.1 of the way to them, the variance biased too (torch's
    own update takes the unbiased one); in eval mode it normalises with the
    running statistics. Statistics and affine in f32; the result in the
    input's type. A recompute for the backward (``nn.remat``) leaves the
    running statistics alone. ``affine=False`` keeps no weight and bias
    (SPADE's ``param_free_norm``)."""

    def __init__(self, features: int, affine: bool = True):
        super().__init__(features, eps=1e-5, momentum=0.1, affine=affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            if spatial.current() is None:
                mean = x32.mean((0, 2, 3))
                var = x32.var((0, 2, 3), unbiased=False)
            else:  # the whole map's statistics
                mean, var, _ = spatial.moments(x32, (0, 2, 3))
            if not recomputing():
                with torch.no_grad():
                    self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
                    self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
                    self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.eps)
        if self.affine:
            mul = mul * self.weight.float()
        y = (x32 - mean[:, None, None]) * mul[:, None, None]
        if self.affine:
            y = y + self.bias.float()[:, None, None]
        return y.to(x.dtype)


class InstanceNorm2d(nn.InstanceNorm2d):
    """InstanceNorm without affine (JAX ``nn/layers.py::InstanceNorm``), in
    two flavours. ``track_stats=True`` is torch's
    ``InstanceNorm2d(track_running_stats=True)`` of the reference ConvLayer:
    training normalises each instance with its own mean and biased variance
    over (H, W) and moves the running statistics 0.1 of the way to the
    batch mean of those means and of the unbiased variances; eval
    normalises with the running statistics. ``track_stats=False`` (the
    reference ResidualBlock's) normalises per instance always and keeps no
    statistics. f32 inside, the input's type out; a recompute for the
    backward leaves the running statistics alone."""

    def __init__(self, features: int, track_stats: bool = True):
        super().__init__(features, eps=1e-5, momentum=0.1, affine=False,
                         track_running_stats=track_stats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.track_running_stats and not self.training:
            mean = self.running_mean.float()[:, None, None]
            var = self.running_var.float()[:, None, None]
        else:
            if spatial.current() is None:
                mean = x32.mean((2, 3), keepdim=True)
                var = x32.var((2, 3), unbiased=False, keepdim=True)
                n = x.shape[2] * x.shape[3]
            else:  # the whole map's statistics
                mean, var, n = spatial.moments(x32, (2, 3), keepdim=True)
            if self.track_running_stats and not recomputing():
                with torch.no_grad():
                    self.running_mean.lerp_(mean.mean((0, 2, 3)).to(self.running_mean.dtype),
                                            self.momentum)
                    unbiased = var.mean((0, 2, 3)) * (n / max(n - 1, 1))
                    self.running_var.lerp_(unbiased.to(self.running_var.dtype), self.momentum)
                    self.num_batches_tracked += 1
        return ((x32 - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def make_norm(norm: Optional[str], features: int, in_track_stats: bool = True) -> Optional[nn.Module]:
    """"BN", "IN" or None (JAX ``_make_norm``); ``in_track_stats=False``
    selects the reference ResidualBlock's stat-less InstanceNorm."""
    if norm is None:
        return None
    if norm == "BN":
        return BatchNorm2d(features)
    if norm == "IN":
        return InstanceNorm2d(features, track_stats=in_track_stats)
    raise ValueError(f"unknown norm {norm!r} (BN, IN or None)")


class ConvLayer(nn.Module):
    """conv -> optional BN/IN -> activation (reference ConvLayer); the conv
    has no bias under BN."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        self.conv2d = Conv2d(in_channels, out_channels, kernel_size, stride, padding,
                             bias=norm != "BN")
        self.norm_layer = make_norm(norm, out_channels)
        self.activation = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2d(x)
        if self.norm_layer is not None:
            y = self.norm_layer(y)
        return self.activation(y)


class UpsampleConvLayer(nn.Module):
    """Bilinear x2 -> conv -> optional BN/IN -> activation (reference
    UpsampleConvLayer); the conv has no bias under BN."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, activation: Optional[str] = "relu", norm: Optional[str] = None):
        super().__init__()
        self.conv2d = Conv2d(in_channels, out_channels, kernel_size, 1, padding, bias=norm != "BN")
        self.norm_layer = make_norm(norm, out_channels)
        self.activation = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2d(resize_bilinear_2x(x))
        if self.norm_layer is not None:
            y = self.norm_layer(y)
        return self.activation(y)


def resize_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample of (N, C, H, W), align_corners=False. Row-sharded,
    the band is resized with a row beyond each edge and cropped: output row
    2i + j reads rows i and i -+ 1, clamped only at the map's borders."""
    if spatial.current() is None:
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    y = F.interpolate(spatial.upsample_input(x), scale_factor=2, mode="bilinear",
                      align_corners=False)
    return y[..., 2:y.shape[-2] - 2, :]


def resize_bilinear_half(x: torch.Tensor) -> torch.Tensor:
    """0.5x bilinear downsample of (N, C, H, W), align_corners=False, no
    antialias, to (H // 2, W // 2) given as the size: at odd sizes
    ``scale_factor=0.5`` would map with the ratio 2 where the JAX package's
    ``jax.image.resize`` maps with in / out. Row-sharded, a band of even
    rows from an even row resizes alone."""
    if spatial.current() is not None:
        spatial.check_halving(x)
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(h // 2, w // 2), mode="bilinear", align_corners=False,
                         antialias=False)


def resize_nearest_torch(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resize of (N, C, H, W) with torch's floor rule, source index
    ``floor(dst * (in / out))``, the ratio and the product in f32 as the
    JAX package computes them (JAX ``nn/layers.py::resize_nearest_torch``),
    and the index clamped into range as JAX's gather clamps it."""
    h, w = x.shape[-2:]

    def index(n_out: int, n_in: int) -> torch.Tensor:
        ratio = torch.tensor(n_in / n_out, dtype=torch.float32)
        src = torch.floor(torch.arange(n_out, dtype=torch.float32) * ratio).long()
        return src.clamp_(max=n_in - 1).to(x.device)

    return x[:, :, index(out_h, h)[:, None], index(out_w, w)[None, :]]


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, C r^2, H, W) -> (N, C, H r, W r), which JAX's NHWC
    ``pixel_shuffle`` was built to match."""
    return F.pixel_shuffle(x, r)


class PixelShufflePack(nn.Module):
    """``upsample_conv`` (kaiming-normal weights) to ``out_channels * r^2``
    channels, then ``pixel_shuffle`` by r (reference
    model/submodules.py:39-81; no model uses it)."""

    def __init__(self, in_channels: int, out_channels: int, scale_factor: int = 2,
                 upsample_kernel: int = 3):
        super().__init__()
        self.scale_factor = scale_factor
        self.upsample_conv = Conv2d(in_channels, out_channels * scale_factor**2, upsample_kernel,
                                    padding=(upsample_kernel - 1) // 2)
        nn.init.kaiming_normal_(self.upsample_conv.weight)
        nn.init.zeros_(self.upsample_conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(self.upsample_conv(x), self.scale_factor)


class ResidualBlockNoBN(nn.Module):
    """conv-relu-conv + x, no norm and no final activation (reference
    bde2vid_cross_scale_propogation_V5.py:262-274)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, 1, 1)
        self.conv2 = Conv2d(features, features, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(torch.relu(self.conv1(x)))


def skip_sum(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return x1 + x2


def skip_concat(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return torch.cat([x1, x2], dim=1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d with its weight and bias cast to the input's type at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), _cast(self.bias, x.dtype)
        if spatial.current() is None:
            return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding,
                                      self.groups, self.dilation)
        x, first, rows = spatial.transposed_conv_input(
            x, self.kernel_size[0], self.stride[0], self.padding[0], self.output_padding[0],
            self.dilation[0])
        y = F.conv_transpose2d(x, w, b, self.stride, (0, self.padding[1]),
                               (0, self.output_padding[1]), self.groups, self.dilation)
        return y[..., first:first + rows, :]


class TransposedConvLayer(nn.Module):
    """Stride-2 transposed conv -> optional BN/IN -> activation (reference
    TransposedConvLayer): ``transposed_conv2d`` is
    ``ConvTranspose2d(k, stride=2, padding=p, output_padding=1)``, exactly
    twice the input size for p = k // 2, with no bias under BN. Its weight is
    torch's (in, out, kh, kw); the JAX package keeps the same kernel flipped
    in correlation form (kh, kw, in, out)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, activation: Optional[str] = "relu", norm: Optional[str] = None):
        super().__init__()
        self.transposed_conv2d = ConvTranspose2d(in_channels, out_channels, kernel_size, stride=2,
                                                 padding=padding, output_padding=1,
                                                 bias=norm != "BN")
        self.norm_layer = make_norm(norm, out_channels)
        self.activation = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.transposed_conv2d(x)
        if self.norm_layer is not None:
            y = self.norm_layer(y)
        return self.activation(y)


class ResidualBlock(nn.Module):
    """conv1 -> bn1 -> relu -> conv2 -> bn2, plus the input (or its 1x1
    ``downsample`` conv), then relu (reference ResidualBlock). The 3x3
    convs have no bias under BN; its IN is the stat-less one."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 norm: Optional[str] = None, downsample: bool = False):
        super().__init__()
        bias = norm != "BN"
        self.conv1 = Conv2d(in_channels, out_channels, 3, stride, 1, bias=bias)
        self.bn1 = make_norm(norm, out_channels, in_track_stats=False)
        self.conv2 = Conv2d(out_channels, out_channels, 3, 1, 1, bias=bias)
        self.bn2 = make_norm(norm, out_channels, in_track_stats=False)
        self.downsample = Conv2d(in_channels, out_channels, 1, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x)
        if self.bn1 is not None:
            y = self.bn1(y)
        y = self.conv2(torch.relu(y))
        if self.bn2 is not None:
            y = self.bn2(y)
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)
