"""HDF5 event-file IO in the canonical event schema (counterpart of
``bde2vid_tpu/events/h5_io.py``; reference event_packagers.py:36-111).

    events/xs int16[N]  events/ys int16[N]  events/ts float64[N]  events/ps bool[N]
    images/image{:09d}  uint8[H,W(,C)], attrs: size, timestamp, type, event_idx
    flow/flow{:09d}     float32[2,H,W], attrs: size, timestamp, event_idx
    file attrs: num_events num_pos num_neg duration t0 tk num_imgs num_flow sensor_resolution

``h5py`` is imported when a reader or writer is made, so the rest of the
package works without it (the MMP backend needs only numpy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def _h5py():
    import h5py

    return h5py


@dataclasses.dataclass
class EventSlice:
    xs: np.ndarray  # int32
    ys: np.ndarray  # int32
    ts: np.ndarray  # float32, shifted so the file's t0 == 0
    ps: np.ndarray  # float32 in {-1, +1}

    def __len__(self) -> int:
        return len(self.xs)

    @classmethod
    def from_raw(cls, xs, ys, ts, ps, t0: float = 0.0) -> "EventSlice":
        """On-disk dtypes (int16 coords, float64 absolute ts, bool/0-1
        polarity) -> int32 coords, float32 ``ts - t0``, polarity ``ps*2-1``."""
        return cls(
            np.asarray(xs).astype(np.int32),
            np.asarray(ys).astype(np.int32),
            (np.asarray(ts) - t0).astype(np.float32),
            np.asarray(ps).astype(np.float32) * 2.0 - 1.0,
        )


def search_time_shifted(ts, t0: float, t: float, side: str = "left") -> int:
    """Binary search over absolute timestamps for a t0-relative query,
    comparing ``ts[mid] - t0`` per element (reference binary_search_h5_dset,
    event_utils.py:10-28)."""
    lo, hi = 0, len(ts)
    while lo < hi:
        mid = (lo + hi) // 2
        v = ts[mid] - t0
        if (v < t) if side == "left" else (v <= t):
            lo = mid + 1
        else:
            hi = mid
    return lo


class H5EventReader:
    """Random-access reader: polarity remapped to {-1,+1}, timestamps shifted
    by t0, per-frame event windows from each image's ``event_idx``."""

    def __init__(self, path: str):
        self.path = path
        self.f = _h5py().File(path, "r")
        if "events/ts" not in self.f:
            self.f.close()
            raise ValueError(f"{path} is not a canonical event h5 file")
        self.t0 = float(self.f.attrs.get("t0", self.f["events/ts"][0] if self.num_events else 0.0))
        h, w = self.f.attrs.get("sensor_resolution", (180, 240))[:2]
        self.sensor_size = (int(h), int(w))
        self._frame_keys: Optional[list] = None
        self._frame_ts: Optional[np.ndarray] = None
        self._frame_event_idx: Optional[np.ndarray] = None

    @property
    def num_events(self) -> int:
        return int(self.f["events/ts"].shape[0])

    def raw_events(self, idx0: int, idx1: int):
        """(int16 xs, int16 ys, float64 absolute ts, uint8 0/1 ps)."""
        return (
            self.f["events/xs"][idx0:idx1],
            self.f["events/ys"][idx0:idx1],
            self.f["events/ts"][idx0:idx1],
            self.f["events/ps"][idx0:idx1].astype(np.uint8),
        )

    def events(self, idx0: int, idx1: int) -> EventSlice:
        return EventSlice.from_raw(*self.raw_events(idx0, idx1), self.t0)

    def search_time(self, t: float, side: str = "left") -> int:
        return search_time_shifted(self.f["events/ts"], self.t0, t, side)

    def _scan_frames(self):
        if self._frame_keys is not None:
            return
        keys, tss, eidx = [], [], []
        if "images" in self.f:
            for k in sorted(self.f["images"].keys()):
                d = self.f["images"][k]
                keys.append(k)
                tss.append(float(d.attrs["timestamp"]) - self.t0)
                eidx.append(int(d.attrs.get("event_idx", -1)))
        self._frame_keys = keys
        self._frame_ts = np.asarray(tss, np.float64)
        self._frame_event_idx = np.asarray(eidx, np.int64)
        # missing event_idx attrs: the packager convention max(0, searchsorted_left - 1)
        for i in np.nonzero(self._frame_event_idx < 0)[0]:
            idx = self.search_time(float(self._frame_ts[i]), side="left")
            self._frame_event_idx[i] = max(0, idx - 1)

    @property
    def num_frames(self) -> int:
        self._scan_frames()
        return len(self._frame_keys)

    @property
    def frame_timestamps(self) -> np.ndarray:
        self._scan_frames()
        return self._frame_ts

    @property
    def frame_event_indices(self) -> np.ndarray:
        self._scan_frames()
        return self._frame_event_idx

    def frame(self, i: int) -> np.ndarray:
        """Frame i as float32 grayscale in [0,1], shape (H, W)."""
        self._scan_frames()
        img = np.asarray(self.f["images"][self._frame_keys[i]])
        if img.ndim == 3:
            if img.shape[-1] == 3:  # stored BGR
                img = 0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
            else:
                img = img[..., 0]
        return (img / 255.0).astype(np.float32)

    def frame_raw(self, i: int) -> Optional[np.ndarray]:
        """Frame i as stored when it is single-channel uint8, else None."""
        self._scan_frames()
        img = self.f["images"][self._frame_keys[i]]
        if img.ndim == 2 and img.dtype == np.uint8:
            return np.asarray(img)
        return None

    def ts_bounds(self, idx0: int, idx1: int):
        """Raw f64 (first, last) absolute timestamps of events [idx0, idx1):
        the reference's window dt is their f64 difference
        (h5_dataset.py:215-217,229)."""
        if idx1 <= idx0:
            return 0.0, 0.0
        ts = self.f["events/ts"]
        return float(ts[idx0]), float(ts[idx1 - 1])

    @property
    def num_flow(self) -> int:
        return len(self.f["flow"]) if "flow" in self.f else 0

    def flow(self, i: int) -> np.ndarray:
        """Stored flow i, (2, H, W) f32 (per-second rates)."""
        keys = sorted(self.f["flow"].keys())
        return np.asarray(self.f["flow"][keys[i]], np.float32)

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class H5EventWriter:
    """Write the canonical schema. ``finalize`` writes the file attrs and,
    on every image and flow dataset, ``event_idx`` = max(0, searchsorted_left
    - 1) (reference packager convention, :75-89)."""

    def __init__(self, path: str, sensor_size: Tuple[int, int] = (180, 240)):
        self.f = _h5py().File(path, "w")
        self.sensor_size = sensor_size
        kw = dict(maxshape=(None,), chunks=True)
        self.dx = self.f.create_dataset("events/xs", (0,), dtype=np.int16, **kw)
        self.dy = self.f.create_dataset("events/ys", (0,), dtype=np.int16, **kw)
        self.dt = self.f.create_dataset("events/ts", (0,), dtype=np.float64, **kw)
        self.dp = self.f.create_dataset("events/ps", (0,), dtype=np.bool_, **kw)
        self.num_pos = 0
        self.num_neg = 0
        self.num_imgs = 0
        self.num_flow = 0

    def append_events(self, xs, ys, ts, ps):
        """ps may be bool (True = positive) or +-1; stored as bool."""
        ps = np.asarray(ps)
        ps_bool = ps > 0 if ps.dtype != np.bool_ else ps
        for dset, data in ((self.dx, xs), (self.dy, ys), (self.dt, ts), (self.dp, ps_bool)):
            data = np.asarray(data)
            dset.resize(dset.shape[0] + len(data), axis=0)
            if len(data):
                dset[-len(data):] = data
        self.num_pos += int(np.count_nonzero(ps_bool))
        self.num_neg += int(len(ps_bool) - np.count_nonzero(ps_bool))

    def add_image(self, image: np.ndarray, timestamp: float):
        d = self.f.create_dataset(f"images/image{self.num_imgs:09d}", data=image.astype(np.uint8))
        d.attrs["size"] = image.shape
        d.attrs["timestamp"] = timestamp
        d.attrs["type"] = "greyscale" if image.ndim == 2 or image.shape[-1] == 1 else "color_bgr"
        self.num_imgs += 1

    def add_flow(self, flow: np.ndarray, timestamp: float):
        d = self.f.create_dataset(f"flow/flow{self.num_flow:09d}", data=flow.astype(np.float32))
        d.attrs["size"] = flow.shape
        d.attrs["timestamp"] = timestamp
        self.num_flow += 1

    def finalize(self):
        ts = self.dt[:]
        t0 = float(ts[0]) if len(ts) else 0.0
        tk = float(ts[-1]) if len(ts) else 0.0
        a = self.f.attrs
        a["num_events"] = self.num_pos + self.num_neg
        a["num_pos"] = self.num_pos
        a["num_neg"] = self.num_neg
        a["duration"] = tk - t0
        a["t0"] = t0
        a["tk"] = tk
        a["num_imgs"] = self.num_imgs
        a["num_flow"] = self.num_flow
        a["sensor_resolution"] = self.sensor_size
        for group in ("images", "flow"):
            if group in self.f:
                for key in self.f[group]:
                    idx = int(np.searchsorted(ts, self.f[group][key].attrs["timestamp"]))
                    self.f[group][key].attrs["event_idx"] = max(0, idx - 1)
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            # close without finalize: a partial file must not look complete
            self.f.close()
            return
        self.finalize()
