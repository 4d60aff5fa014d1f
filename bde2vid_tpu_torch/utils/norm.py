"""Voxel and image normalisation (counterpart of ``bde2vid_tpu/utils/norm.py``;
reference utils_func/data_augmentation.py LegacyNorm :313-330, RobustNorm
:30-68, and inference_utils.py torch2cv2 / cv2torch :12-23)."""

from __future__ import annotations

import numpy as np
import torch

from bde2vid_tpu_torch.parallel import spatial


def legacy_norm(x: torch.Tensor, unbiased: bool = False, batched: bool = False) -> torch.Tensor:
    """Mean/std-normalise the nonzero entries of ``x``; zeros stay zero.

    ``unbiased=False`` is the dataset's LegacyNorm (the population std,
    over n nonzero entries); ``unbiased=True`` divides by n - 1, as the SNN
    runner's ``tensor.std()`` does. An all-zero input, or one whose std is
    0, comes back unchanged. ``batched``: each entry of the first dimension
    is normalised on its own. Under ``parallel.spatial.row_sharded`` ``x``
    is a band of the map's rows, and the count, sum and sum of squares are
    the whole map's (summed over the group; the same one-pass formula)."""
    flat = x.reshape(x.shape[0] if batched else 1, -1)
    nonzero = (flat != 0).to(flat.dtype)
    sums = torch.cat([nonzero.sum(1, keepdim=True), flat.sum(1, keepdim=True),
                      (flat * flat).sum(1, keepdim=True)], 1)
    if spatial.current() is not None:
        sums = spatial.group_sum(sums)
    num, total, squares = sums.split(1, 1)
    safe_num = num.clamp(min=1.0)
    mean = total / safe_num
    sq = squares - safe_num * mean * mean
    denom = (num - 1.0).clamp(min=1.0) if unbiased else safe_num
    std = (sq / denom).clamp(min=0.0).sqrt()
    normed = nonzero * (flat - mean) / torch.where(std == 0, torch.ones_like(std), std)
    return torch.where((num > 0) & (std != 0), normed, flat).reshape(x.shape)


def _nearest_rank_percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The sorted value of ``x`` at 0-based rank ``round(q / 100 (n - 1))``
    (Python's ``round`` on the host), as ``torch.kthvalue`` with
    k = 1 + that rank picks it."""
    flat = x.reshape(-1)
    k = int(round(0.01 * float(q) * (flat.numel() - 1)))
    return torch.sort(flat).values[k]


def robust_norm(x: torch.Tensor, low_perc: float = 0.0, top_perc: float = 95.0) -> torch.Tensor:
    """Clamp ``x`` to its ``low_perc`` and ``top_perc`` nearest-rank
    percentiles, then take ``(c - min c) / (max c + 1e-6)``: the reference
    divides by the maximum, not by the range. When both percentiles are 0
    (a mostly-zero image) ``x`` comes back unchanged."""
    t_max = _nearest_rank_percentile(x, top_perc)
    t_min = _nearest_rank_percentile(x, low_perc)
    clamped = torch.clamp(x, t_min, t_max)
    normed = (clamped - clamped.min()) / (clamped.max() + 1e-6)
    return torch.where((t_max == 0) & (t_min == 0), x, normed)


def robust_1_99(x: torch.Tensor) -> torch.Tensor:
    return robust_norm(x, 1.0, 99.0)


def to_uint8_image(img) -> np.ndarray:
    """A [0, 1] image (tensor or array) -> uint8: squeezed, clipped, times
    255, truncated (the reference's torch2cv2)."""
    if isinstance(img, torch.Tensor):
        img = img.detach().float().cpu().numpy()
    arr = np.asarray(img).squeeze()
    return (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)


def quick_norm(x: torch.Tensor) -> torch.Tensor:
    """(x - min) / (max - min + 1e-6)."""
    return (x - x.min()) / (x.max() - x.min() + 1e-6)


def abs_norm(x: torch.Tensor) -> torch.Tensor:
    """x - min, divided by its maximum where that is not 0."""
    y = x - x.min()
    m = y.max()
    return torch.where(m != 0, y / torch.where(m == 0, torch.ones_like(m), m), y)


def from_uint8_image(img, device=None) -> torch.Tensor:
    """A uint8 (H, W) image -> [0, 1] f32 (1, 1, H, W) on ``device`` (CUDA
    unless the CPU is asked for; the reference's cv2torch)."""
    from bde2vid_tpu_torch.utils.device import resolve_device

    arr = np.asarray(img).astype(np.float32) / 255.0
    return torch.from_numpy(arr)[None, None].to(resolve_device(device))
