"""NumPy oracle of the rasterizers (counterpart of
``bde2vid_tpu/events/voxel_np.py``).

Written from the behavioural spec and following the reference's loop
structure (one pass per bin), as an implementation independent of the
device voxelizer in ``events/voxel.py``: the tests hold one against the
other, and the event tools (``events/tools.py``) write the pre-voxelized
layouts with it on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def events_to_image_np(
    xs, ys, ps, sensor_size: Tuple[int, int] = (180, 240)
) -> np.ndarray:
    h, w = sensor_size
    img = np.zeros((h, w), np.float64)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    np.add.at(img, (ys[keep].astype(np.int64), xs[keep].astype(np.int64)), ps[keep])
    return img.astype(np.float32)


def events_to_image_bilinear_np(
    xs, ys, ps, sensor_size: Tuple[int, int] = (180, 240), padding: bool = True
) -> np.ndarray:
    h, w = sensor_size
    if padding:
        h, w = h + 1, w + 1
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    ps = np.asarray(ps, np.float64)
    mask = ((xs < w - 1) & (ys < h - 1) & (xs >= 0) & (ys >= 0)).astype(np.float64)
    px = np.floor(xs)
    py = np.floor(ys)
    dx = xs - px
    dy = ys - py
    pxi = (px * mask).astype(np.int64)
    pyi = (py * mask).astype(np.int64)
    wgt = ps * mask
    img = np.zeros((h, w), np.float64)
    np.add.at(img, (pyi, pxi), wgt * (1 - dx) * (1 - dy))
    np.add.at(img, (pyi, pxi + 1), wgt * dx * (1 - dy))
    np.add.at(img, (pyi + 1, pxi), wgt * (1 - dx) * dy)
    np.add.at(img, (pyi + 1, pxi + 1), wgt * dx * dy)
    return img.astype(np.float32)


def events_to_voxel_np(
    xs, ys, ts, ps, num_bins: int = 5, sensor_size: Tuple[int, int] = (180, 240)
) -> np.ndarray:
    """Per-bin loop, matching the reference algorithm shape exactly."""
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    ts = np.asarray(ts, np.float64)
    ps = np.asarray(ps, np.float64)
    if len(ts) == 0:
        return np.zeros((num_bins, *sensor_size), np.float32)
    dt = ts[-1] - ts[0]
    t_norm = (ts - ts[0]) / dt * (num_bins - 1) if dt > 0 else np.zeros_like(ts)
    out = []
    for bi in range(num_bins):
        bw = np.maximum(0.0, 1.0 - np.abs(t_norm - bi))
        out.append(events_to_image_np(xs, ys, ps * bw, sensor_size))
    return np.stack(out).astype(np.float32)


def events_to_neg_pos_voxel_np(
    xs, ys, ts, ps, num_bins: int = 5, sensor_size: Tuple[int, int] = (180, 240)
):
    pos = np.where(np.asarray(ps) > 0, 1.0, 0.0)
    neg = np.where(np.asarray(ps) <= 0, 1.0, 0.0)
    return (
        events_to_voxel_np(xs, ys, ts, pos, num_bins, sensor_size),
        events_to_voxel_np(xs, ys, ts, neg, num_bins, sensor_size),
    )


def events_bounds_mask(xs, ys, x_min, x_max, y_min, y_max) -> np.ndarray:
    """1.0 where (x_min < x <= x_max) and (y_min < y <= y_max), else 0
    (reference event_utils.py:140-146, including its strict/inclusive
    boundary asymmetry)."""
    mask = np.where(np.logical_or(xs <= x_min, xs > x_max), 0.0, 1.0)
    mask *= np.where(np.logical_or(ys <= y_min, ys > y_max), 0.0, 1.0)
    return mask


def clip_events_to_bounds(xs, ys, ps, bounds):
    """Zero out-of-bounds events (reference :148-153: multiplies coordinates
    and polarities by the mask rather than filtering)."""
    mask = events_bounds_mask(xs, ys, 0, bounds[1], 0, bounds[0])
    return xs * mask, ys * mask, ps * mask


def voxel_grid_as_image(voxelgrid: np.ndarray) -> np.ndarray:
    """Side-by-side bin visualization, min-max normalized to [0, 255]
    (reference get_voxel_grid_as_image :118-131; cv2.normalize MINMAX
    replicated in NumPy so the helper works without OpenCV)."""
    images = []
    splitter = np.ones((voxelgrid.shape[1], 2)) * np.max(voxelgrid)
    for image in voxelgrid:
        images.append(image)
        images.append(splitter)
    images.pop()
    side = np.hstack(images).astype(np.float64)
    lo, hi = side.min(), side.max()
    if hi > lo:
        side = (side - lo) / (hi - lo) * 255.0
    else:
        side = np.zeros_like(side)
    return side
