"""Temporal-bilinear voxel grids (counterpart of ``bde2vid_tpu/events/voxel.py``
:276-417; reference events_to_voxel_torch and events_to_neg_pos_voxel_torch,
event_utils.py:466-543) and the hot-pixel mask (:473-513; reference
get_hot_event_mask, event_utils.py:100-116).

Events arrive in fixed-capacity buffers with a count of valid events. The B
per-event bin weights form one (N, B) matrix, accumulated with ``index_add_``
into an (H*W, B) grid; out-of-range coordinates and padding get weight 0.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _temporal_bilinear_weights(ts: torch.Tensor, ps: torch.Tensor, valid: torch.Tensor,
                               num_bins: int) -> torch.Tensor:
    """(..., N, B) weights ps * max(0, 1 - |t_norm - b|), t_norm spanning the
    valid events of each row; dt == 0 puts everything in bin 0."""
    n = valid.sum(-1, keepdim=True).long().clamp(min=1)
    t0 = ts[..., :1]
    t_last = ts.gather(-1, n - 1)
    dt = t_last - t0
    safe_dt = torch.where(dt == 0, torch.ones_like(dt), dt)
    t_norm = (ts - t0) / safe_dt * (num_bins - 1)
    t_norm = torch.where(dt == 0, torch.zeros_like(t_norm), t_norm)
    bins = torch.arange(num_bins, dtype=torch.float32, device=ts.device)
    bw = torch.clamp(1.0 - (t_norm[..., None] - bins).abs(), min=0.0)
    return bw * (ps * valid)[..., None]


def events_to_voxel_batch(xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor, ps: torch.Tensor,
                          n_events: torch.Tensor, num_bins: int = 5,
                          sensor_size: Tuple[int, int] = (180, 240)) -> torch.Tensor:
    """(C, cap) event buffers with (C,) valid counts -> (C, B, H, W) voxels,
    one ``index_add_`` for the whole batch."""
    h, w = sensor_size
    c, cap = xs.shape
    dev = xs.device
    valid = (torch.arange(cap, device=dev)[None, :] < n_events.to(dev)[:, None]).float()
    weights = _temporal_bilinear_weights(ts.float(), ps.float(), valid, num_bins)
    xs = xs.long()
    ys = ys.long()
    inb = ((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)).float()
    weights = weights * inb[..., None]
    flat = ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)
    flat = flat + torch.arange(c, device=dev)[:, None] * (h * w)
    acc = torch.zeros((c * h * w, num_bins), dtype=torch.float32, device=dev)
    acc.index_add_(0, flat.reshape(-1), weights.reshape(-1, num_bins))
    return acc.reshape(c, h * w, num_bins).transpose(1, 2).reshape(c, num_bins, h, w)


def events_to_voxel(xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor, ps: torch.Tensor,
                    n_events: int, num_bins: int = 5,
                    sensor_size: Tuple[int, int] = (180, 240)) -> torch.Tensor:
    """One window: (cap,) buffers -> (B, H, W) voxel grid."""
    n = torch.as_tensor([int(n_events)], device=xs.device)
    return events_to_voxel_batch(xs[None], ys[None], ts[None], ps[None], n,
                                 num_bins=num_bins, sensor_size=sensor_size)[0]


def events_to_neg_pos_voxel_batch(xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor,
                                  ps: torch.Tensor, n_events: torch.Tensor, num_bins: int = 5,
                                  sensor_size: Tuple[int, int] = (180, 240)
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, cap) event buffers -> the positive and the non-positive events'
    (C, B, H, W) voxel grids, each event weighing 1 in its polarity's grid
    under the window's shared temporal normalisation, both grids in one
    ``index_add_`` of 2B columns."""
    h, w = sensor_size
    c, cap = xs.shape
    dev = xs.device
    valid = (torch.arange(cap, device=dev)[None, :] < n_events.to(dev)[:, None]).float()
    ps = ps.float()
    bw = _temporal_bilinear_weights(ts.float(), torch.ones_like(ps), valid, num_bins)
    xs = xs.long()
    ys = ys.long()
    inb = ((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)).float()
    pos = (ps > 0).float()
    weights = torch.cat([bw * pos[..., None], bw * (1.0 - pos)[..., None]], -1) * inb[..., None]
    flat = ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)
    flat = flat + torch.arange(c, device=dev)[:, None] * (h * w)
    acc = torch.zeros((c * h * w, 2 * num_bins), dtype=torch.float32, device=dev)
    acc.index_add_(0, flat.reshape(-1), weights.reshape(-1, 2 * num_bins))
    grids = acc.reshape(c, h * w, 2 * num_bins).transpose(1, 2).reshape(c, 2 * num_bins, h, w)
    return grids[:, :num_bins], grids[:, num_bins:]


def events_to_neg_pos_voxel(xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor, ps: torch.Tensor,
                            n_events: int, num_bins: int = 5,
                            sensor_size: Tuple[int, int] = (180, 240)
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One window: (cap,) buffers -> its positive and non-positive (B, H, W)
    voxel grids."""
    n = torch.as_tensor([int(n_events)], device=xs.device)
    vp, vn = events_to_neg_pos_voxel_batch(xs[None], ys[None], ts[None], ps[None], n,
                                           num_bins=num_bins, sensor_size=sensor_size)
    return vp[0], vn[0]


def hot_event_mask(xs: np.ndarray, ys: np.ndarray, ps: np.ndarray,
                   sensor_size: Tuple[int, int] = (180, 240), num_hot: int = 100) -> np.ndarray:
    """(H, W) f32 mask, 1 to keep, 0 at the ``num_hot`` pixels of the
    largest summed ``ps``, on the host. The reference's loop exactly: an
    argmax over the flat count image (row-major ties), zeroed, ``num_hot``
    times; where fewer than ``num_hot`` pixels have a positive sum the
    argmax picks an already zeroed pixel again, so fewer pixels end up
    masked. Events outside the sensor raise, as the reference does."""
    h, w = sensor_size
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    if len(xs) and (xs.min() < 0 or ys.min() < 0 or xs.max() >= w or ys.max() >= h):
        raise ValueError(f"events outside the {h}x{w} sensor: x in [{xs.min()}, {xs.max()}], "
                         f"y in [{ys.min()}, {ys.max()}]")
    img = np.zeros((h * w,), np.float64)
    np.add.at(img, ys.astype(np.int64) * w + xs.astype(np.int64), np.asarray(ps).astype(np.float64))
    mask = np.ones((h * w,), np.float32)
    for _ in range(num_hot):
        idx = int(np.argmax(img))
        mask[idx] = 0.0
        img[idx] = 0.0
    return mask.reshape(h, w)
