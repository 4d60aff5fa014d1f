"""Spatial pad to network-friendly sizes and the inverse crop
(counterpart of ``bde2vid_tpu/utils/padding.py``; reference
utils_func/inference_utils.py:26-69 and model/eitr/model_util.py:20-58).
Operates on the trailing (H, W), or (T, H, W), dims of NCHW-style tensors."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def optimal_crop_size(max_size: int, max_subsample_factor: int) -> int:
    """Smallest multiple of 2^max_subsample_factor >= max_size."""
    f = 2**max_subsample_factor
    return int(f * math.ceil(max_size / f))


class CropParameters:
    """Centred zero-padding to /2^num_encoders and the inverse crop."""

    def __init__(self, width: int, height: int, num_encoders: int):
        self.width = width
        self.height = height
        self.num_encoders = num_encoders
        self.width_crop_size = optimal_crop_size(width, num_encoders)
        self.height_crop_size = optimal_crop_size(height, num_encoders)

        self.padding_top = math.ceil(0.5 * (self.height_crop_size - height))
        self.padding_bottom = math.floor(0.5 * (self.height_crop_size - height))
        self.padding_left = math.ceil(0.5 * (self.width_crop_size - width))
        self.padding_right = math.floor(0.5 * (self.width_crop_size - width))

        cx = math.floor(self.width_crop_size / 2)
        cy = math.floor(self.height_crop_size / 2)
        self.ix0 = cx - math.floor(width / 2)
        self.ix1 = cx + math.ceil(width / 2)
        self.iy0 = cy - math.floor(height / 2)
        self.iy1 = cy + math.ceil(height / 2)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """Zero-pad (..., H, W) to the crop size."""
        return F.pad(x, (self.padding_left, self.padding_right, self.padding_top, self.padding_bottom))

    def crop(self, x: torch.Tensor) -> torch.Tensor:
        """Centre-crop (..., H', W') back to the original size."""
        if self.num_encoders == -1:
            return x
        return x[..., self.iy0 : self.iy1, self.ix0 : self.ix1]


def optimal_crop_size_multiple(max_size: int, factor: int, safety_margin: int = 0) -> int:
    """Smallest multiple of ``factor`` >= max_size (+margin): the EITR variant,
    which takes a divisor instead of an exponent (OptimalCropSize)."""
    return int(factor * math.ceil((max_size + safety_margin) / factor))


class CropSize3D:
    """Centred zero-padding of (..., T, H, W) to patch-size multiples and the
    inverse crop (the reference pads NCTHW)."""

    def __init__(self, width: int, height: int, time: int, patch_size: dict,
                 safety_margin: int = 0):
        self.width, self.height, self.time = width, height, time
        self.width_crop_size = optimal_crop_size_multiple(width, patch_size["w"], safety_margin)
        self.height_crop_size = optimal_crop_size_multiple(height, patch_size["h"], safety_margin)
        self.time_crop_size = optimal_crop_size_multiple(time, patch_size["t"], safety_margin)

        self.padding_top = math.ceil(0.5 * (self.height_crop_size - height))
        self.padding_bottom = math.floor(0.5 * (self.height_crop_size - height))
        self.padding_left = math.ceil(0.5 * (self.width_crop_size - width))
        self.padding_right = math.floor(0.5 * (self.width_crop_size - width))
        self.padding_front = math.ceil(0.5 * (self.time_crop_size - time))
        self.padding_back = math.floor(0.5 * (self.time_crop_size - time))

        ct = math.floor(self.time_crop_size / 2)
        cy = math.floor(self.height_crop_size / 2)
        cx = math.floor(self.width_crop_size / 2)
        self.it0 = ct - math.floor(time / 2)
        self.it1 = ct + math.ceil(time / 2)
        self.iy0 = cy - math.floor(height / 2)
        self.iy1 = cy + math.ceil(height / 2)
        self.ix0 = cx - math.floor(width / 2)
        self.ix1 = cx + math.ceil(width / 2)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        return F.pad(x, (self.padding_left, self.padding_right, self.padding_top,
                         self.padding_bottom, self.padding_front, self.padding_back))

    def crop(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., self.it0 : self.it1, self.iy0 : self.iy1, self.ix0 : self.ix1]
