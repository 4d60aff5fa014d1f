"""Sequence assembly: event file -> windows -> voxel grids on the device
(counterpart of ``bde2vid_tpu/data/pipeline.py``: ``EventSequence``,
``load_sequence``, ``PrevoxelizedSequence`` and ``H5VoxelCacheSequence``).

Backends (``load_sequence``'s ``ltype``, the reference InferenceDataLoader
dispatch, h5_dataset.py:19-42): "H5" (an event h5 file), "SpadeH5" (the
same, split at ``ev_rate`` 0.35 unless given), "MMP" (a memmap directory),
"ENPY" (the raw-NPY layout, explicit per-frame windows), "NPY" (the
pre-voxelized NPY tree) and "H5VOX" (the voxel cache inside an h5 file).
The last two hold voxels already and only copy them to the device.

Windowing (``voxel_method``, reference h5_dataset.py:303-366):
``between_frames`` (``k_framerate`` > 1 gives the HFR windows of
``hfr_windows``), ``k_events`` (``k``, ``sliding_window_w``) and
``t_seconds`` (``t``, ``sliding_window_t``; the duration is the h5
``duration`` attribute, else the last event's t0-relative timestamp). A
between-frames sequence has num_frames - 1 items, one with explicit ENPY
windows has one a frame, the other policies one a window; ``max_length``
caps them at ``max_length + 1``.

Reference item semantics (h5_dataset.py:204-259) kept: window timestamps are
shifted to the window's first event (f64 difference, then f32), windows with
fewer than 3 events give a zero voxel. ``combined_voxel_channels=False``
gives each window the positive and the non-positive events' grids, (2B, H,
W), positive bins first. With ``hot_filter`` a mask of the 100 hottest
pixels (``events/voxel.py::hot_event_mask`` over the first 2 000 000
events' |polarity|, once per sequence; reference h5_dataset.py:364)
multiplies every voxel grid after the zeroing. With ``normalize`` each
window's voxel grid is then LegacyNorm'd on its own
(``utils/norm.py::legacy_norm``).

``voxels()`` takes its windows a batch at a time: one reader read of the
batch's span of events, one ``native.pack_windows`` call into padded buffers
(int16 coordinates, int8 polarity, f32 timestamps; the batch's largest window
sets their width), which lie in pinned memory when the voxels go to the card
and are copied there asynchronously. The packer takes each window's offsets
into the span, so windows may overlap (sliding ``k_events``, HFR) or leave
gaps (ENPY).

With ``ev_rate`` (SPADE's event-rate splitting, reference SpadeE2VDataset,
h5_dataset.py:486-565) each item's window splits into
``n // (H W ev_rate)`` sub-windows (float floor division over the sensor's
pixels, at least one) of ``np.array_split`` sizes: the first ``n % k`` get
one event more. ``windows`` then holds the flat sub-windows, which
``voxels()`` indexes, and ``item_last[i]`` the last sub-window of item i;
``len()`` and ``frames()`` stay per item.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bde2vid_tpu_torch.data.windowing import (
    between_frames_windows,
    k_events_windows,
    t_seconds_windows,
)
from bde2vid_tpu_torch.events.voxel import (
    events_to_neg_pos_voxel_batch,
    events_to_voxel_batch,
    hot_event_mask,
)
from bde2vid_tpu_torch.native import pack_windows
from bde2vid_tpu_torch.utils.device import resolve_device
from bde2vid_tpu_torch.utils.norm import legacy_norm

DATA_SOURCES = ("esim", "ijrr", "mvsec", "eccd", "hqfd", "unknown")
# events the hot-pixel mask counts, from the start of the sequence
HOT_MASK_EVENTS = 2_000_000


def _bucket_capacity(n: int, min_capacity: int = 1024) -> int:
    """The next power of two >= n, at least ``min_capacity``."""
    cap = min_capacity
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass
class SequenceItem:
    """One step of a sequence on the host (reference item, h5_dataset.py:204-259)."""

    frame: Optional[np.ndarray]  # (H, W) f32 in [0, 1], or None without frames
    flow: Optional[np.ndarray]  # (2, H, W) displacement, or None
    events: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]  # padded to the capacity
    n_events: int
    timestamp: float
    dt: float
    data_source_idx: int


def _frames_u8(reader, start: int, stop: int) -> Optional[np.ndarray]:
    """(T, H, W) uint8 frames [start, stop) as stored, or None where the
    reader stores anything else."""
    raw = getattr(reader, "frame_raw", None)
    if raw is None:
        return None
    out = [raw(i) for i in range(start, stop)]
    if any(f is None for f in out) or not out:
        return None
    return np.stack(out)


class EventSequence:
    """An indexed event sequence whose windows voxelize on ``device``."""

    def __init__(self, reader, windows: np.ndarray, num_bins: int = 5, normalize: bool = False,
                 ev_rate: Optional[float] = None, combined_voxel_channels: bool = True,
                 hot_filter: bool = False, sensor_resolution: Optional[Tuple[int, int]] = None,
                 has_frames: bool = True, max_length: Optional[int] = None,
                 trim_last_frame: bool = True):
        self.reader = reader
        self.num_bins = num_bins
        self.normalize = normalize
        self.combined = combined_voxel_channels
        self.has_frames = has_frames
        self.sensor_size = tuple(sensor_resolution or reader.sensor_size)
        self.item_windows = np.asarray(windows, np.int64).reshape(-1, 2)
        length = len(self.item_windows)
        if has_frames:
            # num_frames - 1 items between frames (reference __len__,
            # h5_dataset.py:306-307); explicit windows keep one a frame
            n_items = reader.num_frames - (1 if trim_last_frame else 0)
            length = min(length, n_items) if reader.num_frames else 0
        if max_length is not None:
            length = min(length, max_length + 1)
        if length <= 0:
            raise ValueError("sequence has zero usable steps")
        self.length = length
        self.windows = self.item_windows[:length]
        self.item_last: Optional[np.ndarray] = None
        if ev_rate is not None:
            self.windows, self.item_last = split_by_event_rate(
                self.windows, self.sensor_size[0] * self.sensor_size[1], ev_rate)
        sizes = self.windows[:, 1] - self.windows[:, 0]
        self.capacity = _bucket_capacity(int(sizes.max()) if len(sizes) else 1)
        src = "unknown"
        try:
            src = reader.f.attrs.get("source", "unknown")
            src = src.decode() if isinstance(src, bytes) else str(src)
        except AttributeError:  # backends without an h5 file
            pass
        self.data_source_idx = DATA_SOURCES.index(src) if src in DATA_SOURCES else -1
        self.hot_mask: Optional[np.ndarray] = None
        if hot_filter:
            sl = reader.events(0, min(reader.num_events, HOT_MASK_EVENTS))
            self.hot_mask = hot_event_mask(sl.xs, sl.ys, np.abs(sl.ps), self.sensor_size, num_hot=100)

    def __len__(self) -> int:
        return self.length

    # -- the host item surface -------------------------------------------------

    def raw_window(self, i: int):
        """Window i's (xs int32, ys int32, ts f32, ps f32 -1/+1) padded to
        ``capacity``, and its event count: timestamps shifted to the window's
        first event, the padding repeating the last."""
        idx0, idx1 = self.windows[i]
        sl = self.reader.events(int(idx0), int(idx1))
        n, cap = len(sl.xs), self.capacity
        xs, ys = np.zeros(cap, np.int32), np.zeros(cap, np.int32)
        ts, ps = np.zeros(cap, np.float32), np.zeros(cap, np.float32)
        xs[:n], ys[:n], ps[:n] = sl.xs, sl.ys, sl.ps
        if n:
            ts[:n] = sl.ts - sl.ts[0]
            ts[n:] = ts[n - 1]
        return xs, ys, ts, ps, n

    def item(self, i: int) -> SequenceItem:
        """Step i on the host. Its ``dt`` is the f64 difference of the
        window's raw first and last timestamps (the reference takes them
        before its f32 cast, h5_dataset.py:215-217,229)."""
        if self.item_last is not None:
            # the flat sub-windows do not pair with frames one to one
            raise ValueError("item() is undefined for ev_rate-split (SpadeH5) sequences "
                             "— iterate voxels() and map items via item_last")
        xs, ys, ts, ps, n = self.raw_window(i)
        tf, tl = self.reader.ts_bounds(*(int(v) for v in self.windows[i]))
        dt = tl - tf if n > 0 else 0.0
        frame = self.reader.frame(i) if self.has_frames else None
        flow = None
        if self.has_frames and getattr(self.reader, "num_flow", 0) > i:
            flow = self.reader.flow(i) * dt
        if self.has_frames:
            timestamp = float(self.reader.frame_timestamps[i])
        else:
            timestamp = float(ts[n - 1]) if n else 0.0
        return SequenceItem(frame=frame, flow=flow, events=(xs, ys, ts, ps), n_events=n,
                            timestamp=timestamp, dt=dt, data_source_idx=self.data_source_idx)

    # -- the device path -------------------------------------------------------

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
        range (the MMP backend holds none), the sequence has no frames, or
        the windows are event-rate sub-windows, which pair with no flow."""
        stop = self.length if stop is None else min(stop, self.length)
        if (not self.has_frames or self.item_last is not None
                or getattr(self.reader, "num_flow", 0) < stop):
            return None
        out = []
        for i in range(start, stop):
            tf, tl = self.reader.ts_bounds(*(int(v) for v in self.windows[i]))
            out.append(self.reader.flow(i) * (tl - tf))
        return np.stack(out).astype(np.float32)

    def frames_u8(self, start: int = 0, stop: Optional[int] = None) -> Optional[np.ndarray]:
        """(T, H, W) uint8 frames as stored, or None where the backend stores
        anything else; then ``frames() == frames_u8() / 255``."""
        stop = self.length if stop is None else min(stop, self.length)
        return _frames_u8(self.reader, start, stop)


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


def hfr_windows(reader, k_framerate: int) -> np.ndarray:
    """High-framerate windows (reference DynamicH5DatasetHFR,
    h5_dataset.py:458-483): window i ends at frame i's event index and
    starts at the first event after ``ts_i - (ts_i - ts_{i-1}) / k`` (ts_{-1}
    = 0), so consecutive windows overlap."""
    ends = np.asarray(reader.frame_event_indices, np.int64)
    starts = np.zeros_like(ends)
    start_ts = 0.0
    for i, t in enumerate(np.asarray(reader.frame_timestamps, np.float64)):
        starts[i] = reader.search_time(float(t - (t - start_ts) / k_framerate))
        start_ts = t
    return np.stack([starts, ends], axis=1)


def load_sequence(path: str, num_bins: int = 5, voxel_method: Optional[Dict] = None,
                  combined_voxel_channels: bool = True, hot_filter: bool = False,
                  normalize: bool = False, sensor_resolution: Optional[Tuple[int, int]] = None,
                  max_length: Optional[int] = None, ltype: str = "H5",
                  ev_rate: Optional[float] = None, k_framerate: int = 1):
    """Open a sequence of backend ``ltype`` with the windowing policy
    ``voxel_method`` (``{"method": "between_frames"}`` by default; module
    docstring). ``normalize`` LegacyNorms each window's voxels; ``ev_rate``
    splits each item's window by event rate (any event backend);
    ``combined_voxel_channels=False`` separates the polarities;
    ``hot_filter`` masks the sequence's 100 hottest pixels;
    ``sensor_resolution`` overrides the reader's size. An unknown ``ltype``
    or method raises ``ValueError``."""
    voxel_method = voxel_method or {"method": "between_frames"}
    if ltype in ("H5", "SpadeH5"):
        from bde2vid_tpu_torch.events.h5_io import H5EventReader

        reader = H5EventReader(path)
        if ltype == "SpadeH5" and ev_rate is None:
            ev_rate = 0.35
    elif ltype == "MMP":
        from bde2vid_tpu_torch.events.tools import MemMapEventReader

        reader = MemMapEventReader(path)
    elif ltype == "ENPY":
        from bde2vid_tpu_torch.events.tools import NPYEventReader

        reader = NPYEventReader(path)
    elif ltype == "NPY":
        return PrevoxelizedSequence(path, normalize=normalize, max_length=max_length)
    elif ltype == "H5VOX":
        return H5VoxelCacheSequence(path, num_bins=num_bins, normalize=normalize,
                                    max_length=max_length,
                                    combined_voxel_channels=combined_voxel_channels)
    else:
        raise ValueError(f"unknown loader type {ltype!r}")
    method = voxel_method["method"]
    has_frames, trim_last_frame = True, True
    if method == "between_frames":
        if k_framerate > 1:
            windows = hfr_windows(reader, k_framerate)
        elif hasattr(reader, "frame_windows"):
            windows, trim_last_frame = reader.frame_windows, False
        else:
            windows = between_frames_windows(reader.frame_event_indices)
    elif method == "k_events":
        windows = k_events_windows(reader.num_events, voxel_method["k"],
                                   voxel_method.get("sliding_window_w", 0))
        has_frames = False
    elif method == "t_seconds":
        h5file = getattr(reader, "f", None)  # the event backends without one have no attribute
        duration = float(h5file.attrs.get("duration", 0.0)) if h5file is not None else 0.0
        if duration <= 0.0 and reader.num_events:
            duration = float(reader.events(reader.num_events - 1, reader.num_events).ts[-1])
        windows = t_seconds_windows(reader.search_time, 0.0, duration, voxel_method["t"],
                                    voxel_method.get("sliding_window_t", 0.0))
        has_frames = False
    else:
        raise ValueError(f"unknown voxel method {method!r}")
    return EventSequence(reader, windows, num_bins=num_bins, normalize=normalize, ev_rate=ev_rate,
                         combined_voxel_channels=combined_voxel_channels, hot_filter=hot_filter,
                         sensor_resolution=sensor_resolution, has_frames=has_frames,
                         max_length=max_length, trim_last_frame=trim_last_frame)


def _stored_voxels(v: np.ndarray, device, normalize: bool) -> torch.Tensor:
    v = torch.from_numpy(np.array(v, np.float32)).to(resolve_device(device))
    return legacy_norm(v, batched=True) if normalize else v


class PrevoxelizedSequence:
    """The pre-voxelized NPY tree (reference VoxelGridDataset +
    SynchronizedFramesEventsDataset, event_dataset.py:111-158,
    dataset.py:379-514): base/{event_folder}/voxels.npy (+ timestamps.txt),
    base/{frame_folder}/frames.npy (+ timestamps.txt). Voxel i pairs with
    the first frame whose timestamp is at or after its own, clipped to the
    last frame. The eval driver's EventSequence surface."""

    item_last = None

    def __init__(self, base_folder: str, event_folder: str = "VoxelGrid-betweenframes-5",
                 frame_folder: str = "frames", normalize: bool = False,
                 max_length: Optional[int] = None):
        ef, ff = os.path.join(base_folder, event_folder), os.path.join(base_folder, frame_folder)
        self._voxels = np.load(os.path.join(ef, "voxels.npy"), mmap_mode="r")
        ev_ts = np.loadtxt(os.path.join(ef, "timestamps.txt"))
        self.event_ts = ev_ts[:, 1] if ev_ts.ndim == 2 else ev_ts
        self._frames = np.load(os.path.join(ff, "frames.npy"), mmap_mode="r")
        fr_ts = np.loadtxt(os.path.join(ff, "timestamps.txt"))
        self.frame_stamps = fr_ts[:, 1] if fr_ts.ndim == 2 else fr_ts
        self.normalize = normalize
        self.sensor_size = tuple(self._voxels.shape[-2:])
        self.length = len(self._voxels)
        if max_length is not None:
            self.length = min(self.length, max_length + 1)
        self.frame_idx = np.clip(np.searchsorted(self.frame_stamps, self.event_ts[:self.length]),
                                 0, len(self.frame_stamps) - 1)
        self.reader = self  # the driver closes seq.reader

    def __len__(self) -> int:
        return self.length

    def voxels(self, start: int = 0, stop: Optional[int] = None, device=None,
               batch: int = 64) -> torch.Tensor:
        """(stop-start, C, H, W) f32 stored voxels on ``device`` (CUDA unless
        the CPU is asked for), LegacyNorm'd a window at a time with
        ``normalize``."""
        stop = self.length if stop is None else min(stop, self.length)
        return _stored_voxels(self._voxels[start:stop], device, self.normalize)

    def frames(self, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        """(T, H, W) f32 frames in [0, 1]: uint8 frames, or float frames
        above 1.5, are scaled by 1/255."""
        stop = self.length if stop is None else min(stop, self.length)
        out = np.asarray(self._frames[self.frame_idx[start:stop]], np.float32)
        if self._frames.dtype == np.uint8 or out.max() > 1.5:
            out = out / 255.0
        return out.astype(np.float32)

    def frames_u8(self, start: int = 0, stop: Optional[int] = None) -> Optional[np.ndarray]:
        """The paired frames as stored when they are uint8, else None."""
        if self._frames.dtype != np.uint8:
            return None
        stop = self.length if stop is None else min(stop, self.length)
        return np.asarray(self._frames[self.frame_idx[start:stop]])

    def close(self):
        pass


class H5VoxelCacheSequence:
    """A sequence read from the voxel cache inside an h5 file (the layout
    ``events/tools.py::h5_precompute_voxels`` writes, group
    ``voxel_cache_group``; reference DynamicH5Dataset.get_event_voxel,
    h5_to_between_frames.py:407-409). The eval driver's EventSequence
    surface."""

    item_last = None

    def __init__(self, path: str, num_bins: int = 5, normalize: bool = False,
                 max_length: Optional[int] = None, combined_voxel_channels: bool = True):
        from bde2vid_tpu_torch.events.h5_io import H5EventReader
        from bde2vid_tpu_torch.events.tools import voxel_cache_group

        self.reader = H5EventReader(path)
        self.group = voxel_cache_group(num_bins, combined_voxel_channels)
        if self.group not in self.reader.f:
            self.reader.close()
            raise ValueError(f"{path} has no '{self.group}' cache; run "
                             "events.tools.h5_precompute_voxels first")
        self._grp = self.reader.f[self.group]
        self.normalize = normalize
        self.sensor_size = self.reader.sensor_size
        self.length = min(len(self._grp), max(self.reader.num_frames - 1, 0))
        if max_length is not None:
            self.length = min(self.length, max_length + 1)

    def __len__(self) -> int:
        return self.length

    def voxels(self, start: int = 0, stop: Optional[int] = None, device=None,
               batch: int = 64) -> torch.Tensor:
        """(stop-start, C, H, W) f32 cached voxels on ``device`` (CUDA unless
        the CPU is asked for), LegacyNorm'd a window at a time with
        ``normalize``."""
        stop = self.length if stop is None else min(stop, self.length)
        v = np.stack([np.asarray(self._grp[f"event{i:09d}"]) for i in range(start, stop)])
        return _stored_voxels(v, device, self.normalize)

    def frames(self, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        stop = self.length if stop is None else min(stop, self.length)
        return np.stack([self.reader.frame(i) for i in range(start, stop)])

    def frames_u8(self, start: int = 0, stop: Optional[int] = None) -> Optional[np.ndarray]:
        stop = self.length if stop is None else min(stop, self.length)
        return _frames_u8(self.reader, start, stop)

    def close(self):
        self.reader.close()
