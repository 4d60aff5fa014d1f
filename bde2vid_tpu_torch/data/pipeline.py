"""Sequence assembly: event file -> between-frames windows -> voxel grids on
the device (counterpart of ``bde2vid_tpu/data/pipeline.py`` ``EventSequence``
and ``load_sequence``, H5, SpadeH5 and MMP backends).

Reference item semantics (h5_dataset.py:204-259) kept: window timestamps are
shifted to the window's first event (f64 difference, then f32), windows with
fewer than 3 events give a zero voxel, and a between-frames sequence has
num_frames - 1 items. ``combined_voxel_channels=False`` gives each window the
positive and the non-positive events' grids, (2B, H, W), positive bins
first. With ``hot_filter`` a mask of the 100 hottest pixels
(``events/voxel.py::hot_event_mask`` over the first 2 000 000 events'
|polarity|, once per sequence; reference h5_dataset.py:364) multiplies every
voxel grid after the zeroing. With ``normalize`` each window's voxel grid is
then LegacyNorm'd on its own (``utils/norm.py::legacy_norm``).

``voxels()`` takes its windows a batch at a time: one reader read of the
batch's span of events, one ``native.pack_windows`` call into padded buffers
(int16 coordinates, int8 polarity, f32 timestamps; the batch's largest window
sets their width), which lie in pinned memory when the voxels go to the card
and are copied there asynchronously.

With ``ev_rate`` (SPADE's event-rate splitting, reference SpadeE2VDataset,
h5_dataset.py:486-565) each item's window splits into
``n // (H W ev_rate)`` sub-windows (float floor division over the sensor's
pixels, at least one) of ``np.array_split`` sizes: the first ``n % k`` get
one event more. ``windows`` then holds the flat sub-windows, which
``voxels()`` indexes, and ``item_last[i]`` the last sub-window of item i;
``len()`` and ``frames()`` stay per item.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bde2vid_tpu_torch.data.windowing import between_frames_windows
from bde2vid_tpu_torch.events.voxel import (
    events_to_neg_pos_voxel_batch,
    events_to_voxel_batch,
    hot_event_mask,
)
from bde2vid_tpu_torch.native import pack_windows
from bde2vid_tpu_torch.utils.device import resolve_device
from bde2vid_tpu_torch.utils.norm import legacy_norm


# events the hot-pixel mask counts, from the start of the sequence
HOT_MASK_EVENTS = 2_000_000


class EventSequence:
    """An indexed event sequence whose windows voxelize on ``device``."""

    def __init__(self, reader, windows: np.ndarray, num_bins: int = 5, normalize: bool = False,
                 ev_rate: Optional[float] = None, combined_voxel_channels: bool = True,
                 hot_filter: bool = False):
        self.reader = reader
        self.num_bins = num_bins
        self.normalize = normalize
        self.combined = combined_voxel_channels
        self.sensor_size = tuple(reader.sensor_size)
        windows = np.asarray(windows, np.int64)
        length = min(len(windows), reader.num_frames - 1) if reader.num_frames else 0
        if length <= 0:
            raise ValueError("sequence has zero usable steps")
        self.length = length
        self.windows = windows[:length]
        self.item_last: Optional[np.ndarray] = None
        if ev_rate is not None:
            self.windows, self.item_last = split_by_event_rate(
                self.windows, self.sensor_size[0] * self.sensor_size[1], ev_rate)
        self.hot_mask: Optional[np.ndarray] = None
        if hot_filter:
            sl = reader.events(0, min(reader.num_events, HOT_MASK_EVENTS))
            self.hot_mask = hot_event_mask(sl.xs, sl.ys, np.abs(sl.ps), self.sensor_size, num_hot=100)

    def __len__(self) -> int:
        return self.length

    def _pack(self, start: int, stop: int, pin: bool = False):
        """Padded (stop-start, cap) tensors (xs, ys, ts, ps) and the (stop-start,)
        counts of windows [start, stop), ``cap`` their largest count: padding
        repeats the last timestamp and carries polarity 0. ``pin`` puts them
        in page-locked memory, for an asynchronous copy to the card."""
        wins = self.windows[start:stop]
        span0, span1 = int(wins[:, 0].min()), int(wins[:, 1].max())
        c, cap = len(wins), max(1, int((wins[:, 1] - wins[:, 0]).max()))
        bufs = [torch.empty(shape, dtype=dt, pin_memory=pin)
                for dt, shape in ((torch.int16, (c, cap)), (torch.int16, (c, cap)),
                                  (torch.float32, (c, cap)), (torch.int8, (c, cap)),
                                  (torch.int32, (c,)))]
        pack_windows(*self.reader.raw_events(span0, span1), wins - span0, cap,
                     out=[b.numpy() for b in bufs])
        return bufs

    def voxels(self, start: int = 0, stop: Optional[int] = None, device=None,
               batch: int = 64) -> torch.Tensor:
        """(stop-start, B, H, W) f32 voxel grids of (flat) windows [start,
        stop) on ``device`` (CUDA unless the CPU is asked for); (stop-start,
        2B, H, W) with separate polarities."""
        device = resolve_device(device)
        n_windows = len(self.windows)
        stop = n_windows if stop is None else min(stop, n_windows)
        mask = None if self.hot_mask is None else torch.from_numpy(self.hot_mask).to(device)
        out = []
        for s in range(start, stop, batch):
            # a pinned buffer is freed at the end of this iteration while its
            # copy may still run: torch's pinned-memory cache holds it until
            # the copy's stream has passed it, so no later batch reuses it early
            packed = self._pack(s, min(s + batch, stop), pin=device.type == "cuda")
            xs, ys, ts, ps, ns = (t.to(device, non_blocking=True) for t in packed)
            if self.combined:
                v = events_to_voxel_batch(xs, ys, ts, ps, ns, num_bins=self.num_bins,
                                          sensor_size=self.sensor_size)
            else:
                v = torch.cat(events_to_neg_pos_voxel_batch(xs, ys, ts, ps, ns, num_bins=self.num_bins,
                                                            sensor_size=self.sensor_size), 1)
            v = torch.where((ns < 3)[:, None, None, None], torch.zeros_like(v), v)
            if mask is not None:
                v = v * mask
            out.append(legacy_norm(v, batched=True) if self.normalize else v)
        return torch.cat(out)

    def frames(self, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        """(T, H, W) float32 frames in [0, 1]."""
        stop = self.length if stop is None else min(stop, self.length)
        return np.stack([self.reader.frame(i) for i in range(start, stop)])

    def flows(self, start: int = 0, stop: Optional[int] = None) -> Optional[np.ndarray]:
        """(T, 2, H, W) f32 displacement flows of windows [start, stop): the
        stored flow times the window's duration (reference
        h5_dataset.py:239-241), or None when the file holds no flow for the
        range (the MMP backend holds none) or the windows are event-rate
        sub-windows, which pair with no flow."""
        stop = self.length if stop is None else min(stop, self.length)
        if self.item_last is not None or getattr(self.reader, "num_flow", 0) < stop:
            return None
        out = []
        for i in range(start, stop):
            tf, tl = self.reader.ts_bounds(*(int(v) for v in self.windows[i]))
            out.append(self.reader.flow(i) * (tl - tf))
        return np.stack(out).astype(np.float32)

    def frames_u8(self, start: int = 0, stop: Optional[int] = None) -> Optional[np.ndarray]:
        """(T, H, W) uint8 frames as stored, or None where the backend stores
        anything else; then ``frames() == frames_u8() / 255``."""
        raw = getattr(self.reader, "frame_raw", None)
        if raw is None:
            return None
        stop = self.length if stop is None else min(stop, self.length)
        out = [raw(i) for i in range(start, stop)]
        if any(f is None for f in out) or not out:
            return None
        return np.stack(out)


def split_by_event_rate(windows: np.ndarray, num_pixels: int, ev_rate: float):
    """(flat sub-windows (K, 2), item_last (items,)) of item ``windows``
    split at ``ev_rate`` events per pixel (module docstring)."""
    flat, last = [], []
    for i0, i1 in windows:
        n = int(i1 - i0)
        num_vox = max(int(n // (num_pixels * ev_rate)), 1)
        base, extra = divmod(n, num_vox)
        start = int(i0)
        for j in range(num_vox):
            size = base + (1 if j < extra else 0)
            flat.append([start, start + size])
            start += size
        last.append(len(flat) - 1)
    return np.asarray(flat, np.int64).reshape(-1, 2), np.asarray(last, np.int64)


def load_sequence(path: str, num_bins: int = 5, ltype: str = "H5",
                  normalize: bool = False, ev_rate: Optional[float] = None,
                  combined_voxel_channels: bool = True, hot_filter: bool = False) -> EventSequence:
    """Open a sequence with between-frames windows: ``ltype`` "H5" (an event
    h5 file), "SpadeH5" (the same, split at ``ev_rate`` 0.35 unless given)
    or "MMP" (a memmap directory); ``normalize`` LegacyNorms each window's
    voxels; ``ev_rate`` splits each item's window by event rate (any
    backend); ``combined_voxel_channels=False`` separates the polarities;
    ``hot_filter`` masks the sequence's 100 hottest pixels."""
    if ltype in ("H5", "SpadeH5"):
        from bde2vid_tpu_torch.events.h5_io import H5EventReader

        reader = H5EventReader(path)
        if ltype == "SpadeH5" and ev_rate is None:
            ev_rate = 0.35
    elif ltype == "MMP":
        from bde2vid_tpu_torch.events.tools import MemMapEventReader

        reader = MemMapEventReader(path)
    else:
        raise NotImplementedError(f"loader type {ltype!r} is not ported yet (H5, SpadeH5, MMP)")
    windows = between_frames_windows(reader.frame_event_indices)
    return EventSequence(reader, windows, num_bins=num_bins, normalize=normalize, ev_rate=ev_rate,
                         combined_voxel_channels=combined_voxel_channels, hot_filter=hot_filter)
