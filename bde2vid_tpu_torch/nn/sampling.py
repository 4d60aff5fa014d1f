"""Bilinear grid sampling and flow warping (counterpart of
``bde2vid_tpu/nn/sampling.py``).

torch's ``F.grid_sample`` defaults are the reference semantics the JAX
package reimplements: ``align_corners=False`` and zero padding. The port
keeps the JAX package's channels-last layout at these functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor,
                         align_corners: bool = False) -> torch.Tensor:
    """Sample ``img`` (N, H, W, C) at ``grid`` (N, Ho, Wo, 2) of normalized
    (x, y) coords in [-1, 1]; out-of-range samples read zeros."""
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid.to(img.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def warp_by_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp (N, H, W, C) by a (N, H, W, 2) displacement field in pixels,
    normalizing the grid the way the reference TC loss does
    (align_corners=True-style, model/losses/losses.py:199-211)."""
    _, h, w, _ = img.shape
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, None, :]
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[None, :, None]
    gx = 2.0 * (xx + flow[..., 0]) / (w - 1) - 1.0
    gy = 2.0 * (yy + flow[..., 1]) / (h - 1) - 1.0
    return grid_sample_bilinear(img, torch.stack([gx, gy], dim=-1))
