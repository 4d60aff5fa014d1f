"""Event rasterization (counterpart of ``bde2vid_tpu/events/voxel.py``;
reference events_contrast_maximization/utils/event_utils.py): the host-side
padding helpers, the integer and bilinear event images with their analytic
derivative planes, the timestamp images, flow warps, the temporal-bilinear
voxel grids (events_to_voxel_torch and events_to_neg_pos_voxel_torch,
:466-543) and their windowed and hard-binned variants, and the hot-pixel
mask (get_hot_event_mask, :100-116).

Events arrive in fixed-capacity buffers with a count of valid events.
Images are (H, W) and run on their inputs' device. Per-event weights form
one (N, K) matrix accumulated with one ``index_add`` into an (H*W, K) grid;
out-of-range coordinates and padding get weight 0 and index 0, so no flat
index is ever negative (torch would wrap it).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from bde2vid_tpu_torch.utils.device import resolve_device

Count = Union[int, torch.Tensor]


# ---------------------------------------------------------------- host buffers


def _bucket_capacity(n: int, min_capacity: int = 1024) -> int:
    """Next power of two >= n (and >= min_capacity)."""
    cap = max(int(min_capacity), 1)
    while cap < n:
        cap *= 2
    return cap


def pad_events(xs: np.ndarray, ys: np.ndarray, ts: np.ndarray, ps: np.ndarray,
               capacity: Optional[int] = None, min_capacity: int = 1024
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Pad a window to ``capacity`` (power-of-two bucketed if not given) on
    the host: ``(xs, ys, ts, ps, n_events)``. Padding sits at (0, 0) with
    polarity 0 and timestamp ``ts[-1]``; float coordinates stay f32, integer
    ones become i32."""
    n = len(xs)
    cap = capacity if capacity is not None else _bucket_capacity(n, min_capacity)
    if n > cap:
        raise ValueError(f"{n} events exceed capacity {cap}")
    t_fill = float(ts[-1]) if n > 0 else 0.0

    def pad(a, fill, dtype):
        out = np.full((cap,), fill, dtype=dtype)
        out[:n] = a
        return out

    coord = np.float32 if np.issubdtype(np.asarray(xs).dtype, np.floating) else np.int32
    return pad(xs, 0, coord), pad(ys, 0, coord), pad(ts, t_fill, np.float32), pad(ps, 0.0, np.float32), n


def unpack_batched_events(events: np.ndarray, batch_indices) -> np.ndarray:
    """(N, 4) events laid end to end with each item's end index -> (B, 1, M,
    4) zero-padded items, M the longest (the documented intent of the
    reference's unpack_batched_events, event_utils.py:545-574)."""
    events = np.asarray(events).reshape(-1, events.shape[-1])
    ends = list(batch_indices)
    starts = [0] + ends[:-1]
    maxlen = max(e - s for s, e in zip(starts, ends)) if ends else 0
    out = np.zeros((len(ends), 1, maxlen, events.shape[-1]), events.dtype)
    for b, (s, e) in enumerate(zip(starts, ends)):
        out[b, 0, : e - s] = events[s:e]
    return out


def _valid_mask(capacity: int, n_events: Count, device) -> torch.Tensor:
    n = n_events.to(device) if isinstance(n_events, torch.Tensor) else n_events
    return (torch.arange(capacity, device=device) < n).float()


def _last_valid(ts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """ts at the last valid event (the first when none is valid)."""
    n = valid.sum().long().clamp(min=1)
    return ts[n - 1]


# ---------------------------------------------------------------------- images


def events_to_image(xs: torch.Tensor, ys: torch.Tensor, ps: torch.Tensor, n_events: Count, *,
                    sensor_size: Tuple[int, int] = (180, 240)) -> torch.Tensor:
    """Scatter-add of polarities at integer coordinates into an (H, W) image
    (reference event_utils.py:371-375), duplicates accumulated; float
    coordinates truncate toward zero, out-of-range events drop."""
    h, w = sensor_size
    dev = xs.device
    valid = _valid_mask(xs.shape[0], n_events, dev)
    xs = xs.long()
    ys = ys.long()
    inb = ((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)).float()
    flat = ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)
    img = torch.zeros(h * w, dtype=torch.float32, device=dev)
    return img.index_add(0, flat, ps.float() * valid * inb).reshape(h, w)


def _bilinear_coords(xs: torch.Tensor, ys: torch.Tensor, n_events: Count, h: int, w: int):
    """Floor and fractional coordinates with the two masks apart: ``valid``
    (inside the buffer's count) and ``inb`` (the reference clip at
    size - 1, event_utils.py:223-237). Out-of-range events get their
    floor coordinates zeroed and keep their fractions; whether their weight
    is zeroed too is the caller's choice."""
    xs = xs.float()
    ys = ys.float()
    valid = _valid_mask(xs.shape[0], n_events, xs.device)
    inb = ((xs < w - 1) & (ys < h - 1) & (xs >= 0) & (ys >= 0)).float()
    px = torch.floor(xs)
    py = torch.floor(ys)
    pxi = (px * inb).long()
    pyi = (py * inb).long()
    return pxi, pyi, xs - px, ys - py, valid, inb


def _bilinear_corners(wgt: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """(N, 4) weights of the corners (x, y), (x+1, y), (x, y+1), (x+1, y+1)."""
    return torch.stack([wgt * (1.0 - dx) * (1.0 - dy), wgt * dx * (1.0 - dy),
                        wgt * (1.0 - dx) * dy, wgt * dx * dy], dim=1)


def _corner_scatter(pxi: torch.Tensor, pyi: torch.Tensor, corners: torch.Tensor,
                    h: int, w: int) -> torch.Tensor:
    """(N, K, 4) per-corner columns -> (h, w, K) planes: one out-of-place
    ``index_add`` of 4K-wide rows at each event's base corner (so autograd
    reaches the weights), then the four corner planes shifted into place
    and summed. The base clip of ``_bilinear_coords`` keeps base+1 and
    base+w inside the image."""
    n, k, _ = corners.shape
    base = pyi * w + pxi
    acc = torch.zeros((h * w, 4 * k), dtype=torch.float32, device=corners.device)
    p = acc.index_add(0, base, corners.reshape(n, 4 * k)).reshape(h, w, k, 4)
    return (p[..., 0]
            + F.pad(p[..., 1], (0, 0, 1, 0))[:, :w]  # (x+1, y)
            + F.pad(p[..., 2], (0, 0, 0, 0, 1, 0))[:h]  # (x, y+1)
            + F.pad(p[..., 3], (0, 0, 1, 0, 1, 0))[:h, :w])  # (x+1, y+1)


def events_to_image_bilinear(xs: torch.Tensor, ys: torch.Tensor, ps: torch.Tensor,
                             n_events: Count, *, sensor_size: Tuple[int, int] = (180, 240),
                             padding: bool = True, clip_weights: bool = True) -> torch.Tensor:
    """Each float-coordinate event splits its weight over its 4 surrounding
    pixels (interpolate_to_image, event_utils.py:176-184). ``padding`` adds
    the reference's +1 guard row and column, kept in the output;
    ``clip_weights=False`` keeps the weight of out-of-range events, which
    then lands at the origin corner (the timestamp image's quirk)."""
    h, w = sensor_size
    if padding:
        h, w = h + 1, w + 1
    pxi, pyi, dx, dy, valid, inb = _bilinear_coords(xs, ys, n_events, h, w)
    wgt = ps.float() * (valid * inb if clip_weights else valid)
    return _corner_scatter(pxi, pyi, _bilinear_corners(wgt, dx, dy)[:, None], h, w)[..., 0]


def events_to_image_drv(xs: torch.Tensor, ys: torch.Tensor, ps: torch.Tensor, jx: torch.Tensor,
                        jy: torch.Tensor, n_events: Count, *,
                        sensor_size: Tuple[int, int] = (180, 240), padding: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bilinear image and its analytic derivative planes (P, H, W) with
    respect to warp parameters whose (P, N) jacobians of the warped
    coordinates are ``jx`` and ``jy`` (interpolate_to_derivative_img,
    event_utils.py:186-249): per corner, ``jx ps d(corner)/dx + jy ps
    d(corner)/dy``. Out-of-range events are masked to coordinate 0."""
    h, w = sensor_size
    if padding:
        h, w = h + 1, w + 1
    pxi, pyi, dx, dy, valid, inb = _bilinear_coords(xs, ys, n_events, h, w)
    wgt = ps.float() * (valid * inb)
    w1 = jx.float() * wgt  # (P, N)
    w2 = jy.float() * wgt
    d_corners = torch.stack([w1 * -(1.0 - dy) + w2 * -(1.0 - dx), w1 * (1.0 - dy) + w2 * -dx,
                             w1 * -dy + w2 * (1.0 - dx), w1 * dy + w2 * dx], dim=-1)  # (P, N, 4)
    cols = torch.cat([_bilinear_corners(wgt, dx, dy)[:, None], d_corners.transpose(0, 1)], dim=1)
    out = _corner_scatter(pxi, pyi, cols, h, w)  # (h, w, P + 1)
    return out[..., 0], out[..., 1:].permute(2, 0, 1)


def events_to_timestamp_image(xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor,
                              ps: torch.Tensor, n_events: Count, *,
                              sensor_size: Tuple[int, int] = (180, 240), padding: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum images of normalized timestamps, positive and non-positive events
    apart (reference event_utils.py:251-320): ts shifted to start at 0 and
    divided by the last valid ts + 1e-6, scattered bilinearly; out-of-range
    events keep their weight at the origin corner, as the reference's
    un-masked scatter puts it."""
    ts = ts.float()
    valid = _valid_mask(xs.shape[0], n_events, xs.device)
    t_norm = (ts - ts[0]) / (_last_valid(ts, valid) + 1e-6)
    pos = (ps > 0).float()
    kw = dict(sensor_size=sensor_size, padding=padding, clip_weights=False)
    return (events_to_image_bilinear(xs, ys, t_norm * pos, n_events, **kw),
            events_to_image_bilinear(xs, ys, t_norm * (1.0 - pos), n_events, **kw))


# the reference keeps the Zhu'19 name as an alias (event_utils.py:321-328)
events_to_zhu_timestamp_image = events_to_timestamp_image


def warp_events_by_flow(xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor, flow: torch.Tensor,
                        t0=None, n_events: Optional[Count] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance each event by the (H, W, 2) [fx, fy] flow sampled bilinearly
    at its position (align_corners grid) times ``t - t0`` (reference
    warp_events_flow_torch, event_utils.py:576-618); ``t0`` defaults to the
    last valid timestamp."""
    from bde2vid_tpu_torch.nn.sampling import grid_sample_bilinear

    h, w = flow.shape[0], flow.shape[1]
    xs = xs.float()
    ys = ys.float()
    if t0 is None:
        if n_events is None:
            t0 = ts[-1]
        else:
            t0 = _last_valid(ts, _valid_mask(ts.shape[0], n_events, ts.device))
    grid = torch.stack([xs / (w - 1) * 2.0 - 1.0, ys / (h - 1) * 2.0 - 1.0], dim=-1)[None, None]
    flow_at = grid_sample_bilinear(flow[None].float(), grid, align_corners=True)[0, 0]  # (N, 2)
    dt = ts.float() - t0
    return xs + flow_at[:, 0] * dt, ys + flow_at[:, 1] * dt


# ----------------------------------------------------------------- voxel grids


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


def events_to_voxel_accumulate(xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor,
                               ps: torch.Tensor, n_events: Count, *, num_bins: int = 5,
                               sensor_size: Tuple[int, int] = (180, 240)) -> torch.Tensor:
    """Hard binning (``temporal_bilinear=False``): bin i takes the events in
    [t0 + i dt / B, t0 + (i + 1) dt / B), the last bin its end too; the
    documented intent of the reference's bitrotted branch
    (event_utils.py:499-505)."""
    h, w = sensor_size
    dev = xs.device
    valid = _valid_mask(xs.shape[0], n_events, dev)
    ts = ts.float()
    t0 = ts[0]
    dt = _last_valid(ts, valid) - t0
    safe_dt = torch.where(dt == 0, torch.ones_like(dt), dt)
    binf = torch.floor((ts - t0) / safe_dt * num_bins).clamp(0, num_bins - 1).long()
    bins = torch.arange(num_bins, device=dev)
    weights = (binf[:, None] == bins).float() * (ps.float() * valid)[:, None]
    xs = xs.long()
    ys = ys.long()
    inb = ((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)).float()
    flat = ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)
    acc = torch.zeros((h * w, num_bins), dtype=torch.float32, device=dev)
    acc.index_add_(0, flat, weights * inb[:, None])
    return acc.t().reshape(num_bins, h, w)


def _window_voxel(xs, ys, ts, ps, i0: int, i1: int, num_bins: int, sensor_size, device,
                  capacity: Optional[int] = None) -> torch.Tensor:
    """Events [i0, i1) of host arrays, ts from the window's first, padded
    and voxelized on ``device``."""
    ts_w = np.asarray(ts[i0:i1]) - np.asarray(ts[i0])
    px, py, pt, pp, nv = pad_events(np.asarray(xs[i0:i1]), np.asarray(ys[i0:i1]), ts_w,
                                    np.asarray(ps[i0:i1]), capacity=capacity)
    bufs = [torch.from_numpy(a).to(device) for a in (px, py, pt, pp)]
    return events_to_voxel(*bufs, nv, num_bins=num_bins, sensor_size=sensor_size)


def voxel_grids_fixed_n(xs, ys, ts, ps, num_bins: int, n: int,
                        sensor_size: Tuple[int, int] = (180, 240), device=None
                        ) -> List[torch.Tensor]:
    """Voxel grids of consecutive windows of ``n`` events on ``device``
    (reference voxel_grids_fixed_n_torch, event_utils.py:377-410). Windows
    start at ``range(0, len(xs) - n, n)``, as the reference's: the trailing
    partial window drops, and so does a last full one starting at len - n."""
    dev = resolve_device(device)
    return [_window_voxel(xs, ys, ts, ps, i0, i0 + n, num_bins, sensor_size, dev,
                          capacity=_bucket_capacity(n))
            for i0 in range(0, len(xs) - n, n)]


def voxel_grids_fixed_t(xs, ys, ts, ps, num_bins: int, t: float,
                        sensor_size: Tuple[int, int] = (180, 240), device=None
                        ) -> List[torch.Tensor]:
    """Voxel grids of consecutive windows of duration ``t`` on ``device``
    (reference voxel_grids_fixed_t_torch, event_utils.py:412-460). Windows
    start at ``np.arange(ts[0], ts[-1] - t, t)``, as the reference's; an
    empty window is skipped where the reference's assert would abort."""
    dev = resolve_device(device)
    ts_np = np.asarray(ts)
    out = []
    for t_start in np.arange(float(ts_np[0]), float(ts_np[-1]) - t, t):
        i0 = int(np.searchsorted(ts_np, t_start))
        i1 = int(np.searchsorted(ts_np, t_start + t))
        if i1 > i0:
            out.append(_window_voxel(xs, ys, ts_np, ps, i0, i1, num_bins, sensor_size, dev))
    return out


def events_to_voxel_timesync(xs, ys, ts, ps, num_bins: int, t0: float, t1: float,
                             sensor_size: Tuple[int, int] = (180, 240), device=None
                             ) -> torch.Tensor:
    """The voxel grid of the events in [t0, t1) on ``device`` (reference
    events_to_voxel_timesync_torch, event_utils.py:431-464); ``t1 > t0``
    and at least one event in range are required."""
    dev = resolve_device(device)
    ts_np = np.asarray(ts)
    if not t1 > t0:
        raise ValueError("t1 must be > t0")
    i0 = int(np.searchsorted(ts_np, t0))
    i1 = int(np.searchsorted(ts_np, t1))
    if not i0 < i1:
        raise ValueError("no events in [t0, t1)")
    return _window_voxel(xs, ys, ts_np, ps, i0, i1, num_bins, sensor_size, dev)


# ---------------------------------------------------------------------- hot pixels


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
