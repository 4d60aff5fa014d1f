"""Voxel normalisation (counterpart of ``bde2vid_tpu/utils/norm.py``
``legacy_norm``; reference utils_func/data_augmentation.py LegacyNorm
:313-330)."""

from __future__ import annotations

import torch


def legacy_norm(x: torch.Tensor, unbiased: bool = False, batched: bool = False) -> torch.Tensor:
    """Mean/std-normalise the nonzero entries of ``x``; zeros stay zero.

    ``unbiased=False`` is the dataset's LegacyNorm (the population std,
    over n nonzero entries); ``unbiased=True`` divides by n - 1, as the SNN
    runner's ``tensor.std()`` does. An all-zero input, or one whose std is
    0, comes back unchanged. ``batched``: each entry of the first dimension
    is normalised on its own."""
    flat = x.reshape(x.shape[0] if batched else 1, -1)
    nonzero = (flat != 0).to(flat.dtype)
    num = nonzero.sum(1, keepdim=True)
    safe_num = num.clamp(min=1.0)
    mean = flat.sum(1, keepdim=True) / safe_num
    sq = (flat * flat).sum(1, keepdim=True) - safe_num * mean * mean
    denom = (num - 1.0).clamp(min=1.0) if unbiased else safe_num
    std = (sq / denom).clamp(min=0.0).sqrt()
    normed = nonzero * (flat - mean) / torch.where(std == 0, torch.ones_like(std), std)
    return torch.where((num > 0) & (std != 0), normed, flat).reshape(x.shape)
