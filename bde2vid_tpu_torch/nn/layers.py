"""Convolutional building blocks (counterpart of ``bde2vid_tpu/nn/layers.py``).

NCHW tensors and torch padding (``padding=k//2``), so the reference
checkpoint layout (``conv2d.weight`` in OIHW) loads as is.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

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


class ConvLayer(nn.Module):
    """conv -> activation (reference ConvLayer without a norm; the port
    supports ``norm=None`` only)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, activation: Optional[str] = "relu"):
        super().__init__()
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding)
        self.activation = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.activation(self.conv2d(x))


class UpsampleConvLayer(nn.Module):
    """Bilinear x2 -> conv -> activation (reference UpsampleConvLayer)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, activation: Optional[str] = "relu"):
        super().__init__()
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size, 1, padding)
        self.activation = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.activation(self.conv2d(resize_bilinear_2x(x)))


def resize_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample of (N, C, H, W), align_corners=False."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class ResidualBlockNoBN(nn.Module):
    """conv-relu-conv + x, no norm and no final activation (reference
    bde2vid_cross_scale_propogation_V5.py:262-274)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(torch.relu(self.conv1(x)))
