"""Plain reference of the between-frames voxel grids of a recording.

Item i of a recording with frame timestamps ``ft`` takes the events with
``ft[i-1] <= t < ft[i]`` (from the first event for i = 0). Its timestamps
are rebased to the window's first event, t_norm = (t - t0) / (t_last - t0)
(bins - 1), and each event adds its polarity (+1 / -1) times
max(0, 1 - |t_norm - b|) to bin b at its pixel: one scatter, accumulated in
float64. A window of fewer than 3 events gives zeros. Reads the raw arrays
of the recording's files; imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def item_bounds(t: np.ndarray, frame_ts: np.ndarray, i: int) -> Tuple[int, int]:
    """[i0, i1) event indices of item i."""
    i0 = 0 if i == 0 else int(np.searchsorted(t, frame_ts[i - 1], "left"))
    return i0, int(np.searchsorted(t, frame_ts[i], "left"))


def voxel_grid(xy: np.ndarray, t: np.ndarray, p: np.ndarray, bins: int, hw: Tuple[int, int],
               device) -> torch.Tensor:
    """One window's (bins, H, W) f32 grid from its raw events: xy (n, 2)
    int16 [x, y], t (n,) float64 seconds, p (n,) 0/1."""
    h, w = hw
    grid = torch.zeros(bins * h * w, dtype=torch.float64, device=device)
    n = len(t)
    if n < 3:
        return grid.view(bins, h, w).float()
    ts = torch.as_tensor(t - t[0], device=device)
    dt = float(ts[-1])
    tn = ts / dt * (bins - 1) if dt > 0 else torch.zeros_like(ts)
    pol = torch.as_tensor(p.astype(np.float64) * 2.0 - 1.0, device=device)
    pix = torch.as_tensor(xy[:, 1].astype(np.int64) * w + xy[:, 0].astype(np.int64), device=device)
    for b in range(bins):
        grid.index_add_(0, b * h * w + pix, pol * torch.clamp(1.0 - (tn - b).abs(), min=0.0))
    return grid.view(bins, h, w).float()
