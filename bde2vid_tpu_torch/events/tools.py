"""Event-file readers, converters and voxel writers (counterpart of
``bde2vid_tpu/events/tools.py``; reference events_contrast_maximization/tools/
and data_loader/{h5_dataset,dataset}.py).

Readers, numpy only:

- ``MemMapEventReader``, the RPG memmap layout (reference MemMapDataset,
  h5_dataset.py:568-665): t.npy (N,) float64 absolute timestamps, xy.npy
  (N, 2) int16, p.npy (N,) uint8 0/1, images.npy (F, H, W[, 1]) uint8,
  timestamps.npy (F,) float64, optional dataset_config.json with
  ``sensor_resolution``;
- ``NPYEventReader``, the raw-NPY layout (reference SynchronizedNPYDataset,
  dataset.py:207-376): events/{xs,ys,ts,ps}.npy, frames/frames.npy with
  frame_ts.txt and frame_event_idxes.txt (explicit [idx0, idx1) pairs).

Converters, over ``events/h5_io.py``'s canonical schema: ``txt_to_h5``,
``zip_to_h5``, ``h5_cut``, ``add_hdf5_attribute`` and ``h5_to_memmap``
(float64 timestamps kept lossless). Voxel writers, through the NumPy oracle
``events/voxel_np.py`` under the reference item rules (fewer than 3 events
give zeros, timestamps shifted to the window's first event in f64 as the
event pipeline shifts them; the JAX package's writers shift f32 timestamps
relative to the recording's start, whose rounding grows with the time into
the recording):
``h5_precompute_voxels`` (the in-h5 cache the ``H5VOX`` loader reads) and
``h5_to_prevoxelized_npy`` (the tree the ``NPY`` loader reads;
``write_prevoxelized_npy`` writes it from any reader, a memmap one
included). Everything touching an h5 file needs ``h5py``, imported when
called.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from bde2vid_tpu_torch.events.h5_io import (
    EventSlice,
    H5EventReader,
    H5EventWriter,
    search_time_shifted,
)
from bde2vid_tpu_torch.events.voxel_np import events_to_neg_pos_voxel_np, events_to_voxel_np


def _ts_bounds(t, i0: int, i1: int):
    """Raw f64 (first, last) absolute timestamps of events [i0, i1): the
    reference's window dt is their f64 difference (h5_dataset.py:215-217,
    229)."""
    if i1 <= i0:
        return 0.0, 0.0
    return float(t[i0]), float(t[i1 - 1])


class MemMapEventReader:
    """Random-access reader over the RPG memmap layout, with the
    H5EventReader surface."""

    num_flow = 0

    def __init__(self, path: str):
        if not os.path.isdir(path):
            raise ValueError(f"{path} is not a memmap directory")
        self.path = path
        self.t = np.load(os.path.join(path, "t.npy"), mmap_mode="r").reshape(-1)
        self.xy = np.load(os.path.join(path, "xy.npy"), mmap_mode="r").reshape(-1, 2)
        self.p = np.load(os.path.join(path, "p.npy"), mmap_mode="r").reshape(-1)
        img_path = os.path.join(path, "images.npy")
        self.images = np.load(img_path, mmap_mode="r") if os.path.exists(img_path) else None
        ts_path = os.path.join(path, "timestamps.npy")
        self.frame_ts = np.load(ts_path) if os.path.exists(ts_path) else np.zeros(0)
        cfg_path = os.path.join(path, "dataset_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as fp:
                self.sensor_size = tuple(json.load(fp)["sensor_resolution"])[:2]
        elif self.images is not None and len(self.images):
            self.sensor_size = tuple(self.images[0].shape[:2])
        else:
            self.sensor_size = (int(self.xy[:, 1].max()) + 1, int(self.xy[:, 0].max()) + 1)
        self.t0 = float(self.t[0]) if len(self.t) else 0.0

    @property
    def num_events(self) -> int:
        return len(self.t)

    @property
    def num_frames(self) -> int:
        return len(self.frame_ts)

    @property
    def frame_timestamps(self) -> np.ndarray:
        return np.asarray(self.frame_ts, np.float64) - self.t0

    @property
    def frame_event_indices(self) -> np.ndarray:
        # window ends come from searchsorting the frame timestamps
        # (reference compute_frame_indices, h5_dataset.py:645-647)
        return np.searchsorted(np.asarray(self.t), np.asarray(self.frame_ts))

    def raw_events(self, i0: int, i1: int):
        xy = np.asarray(self.xy[i0:i1])
        return (
            xy[:, 0].astype(np.int16),
            xy[:, 1].astype(np.int16),
            np.asarray(self.t[i0:i1], np.float64),
            np.asarray(self.p[i0:i1], np.uint8),
        )

    def events(self, i0: int, i1: int) -> EventSlice:
        xy = np.asarray(self.xy[i0:i1])
        return EventSlice.from_raw(xy[:, 0], xy[:, 1], self.t[i0:i1], self.p[i0:i1], self.t0)

    def search_time(self, t: float, side: str = "left") -> int:
        """Index of the first event at (``side="left"``) or after (``"right"``)
        the t0-relative time ``t``, compared as the H5 reader compares."""
        return search_time_shifted(self.t, self.t0, t, side)

    def ts_bounds(self, i0: int, i1: int):
        return _ts_bounds(self.t, i0, i1)

    def frame(self, i: int) -> np.ndarray:
        img = np.asarray(self.images[i])
        if img.ndim == 3:
            img = img[..., 0]
        return (img / 255.0).astype(np.float32)

    def flow(self, i: int):
        raise IndexError("memmap dataset has no flow")

    def close(self):
        pass


class NPYEventReader:
    """Raw-NPY layout reader: ``frame_windows`` are the stored per-frame
    [idx0, idx1) pairs (they need not be contiguous), the sensor size is
    ``frames.shape[1:3]``, and uint8 frames are scaled by 1/255."""

    num_flow = 0

    def __init__(self, path: str, event_folder: str = "events", frame_folder: str = "frames"):
        self.path = path
        ef, ff = os.path.join(path, event_folder), os.path.join(path, frame_folder)
        self.xs = np.load(os.path.join(ef, "xs.npy"), mmap_mode="r")
        self.ys = np.load(os.path.join(ef, "ys.npy"), mmap_mode="r")
        self.t = np.load(os.path.join(ef, "ts.npy"), mmap_mode="r")
        self.p = np.load(os.path.join(ef, "ps.npy"), mmap_mode="r")
        self.images = np.load(os.path.join(ff, "frames.npy"), mmap_mode="r")
        self.frame_ts = np.loadtxt(os.path.join(ff, "frame_ts.txt")).reshape(-1)
        self.frame_windows = np.loadtxt(os.path.join(ff, "frame_event_idxes.txt"),
                                        dtype=np.int64).reshape(-1, 2)
        # (F, H, W) or (F, H, W, C)
        self.sensor_size = tuple(self.images.shape[1:3])
        self.t0 = float(self.t[0]) if len(self.t) else 0.0

    @property
    def num_events(self) -> int:
        return len(self.t)

    @property
    def num_frames(self) -> int:
        return len(self.frame_ts)

    @property
    def frame_timestamps(self) -> np.ndarray:
        return np.asarray(self.frame_ts, np.float64) - self.t0

    @property
    def frame_event_indices(self) -> np.ndarray:
        return self.frame_windows[:, 1]

    def raw_events(self, i0: int, i1: int):
        # 0/1 polarity for the packer, which reads any nonzero byte as +1:
        # a -1/+1 array cast to uint8 would turn -1 into 255
        return (
            np.asarray(self.xs[i0:i1], np.int16),
            np.asarray(self.ys[i0:i1], np.int16),
            np.asarray(self.t[i0:i1], np.float64),
            (np.asarray(self.p[i0:i1]) > 0).astype(np.uint8),
        )

    def events(self, i0: int, i1: int) -> EventSlice:
        return EventSlice.from_raw(self.xs[i0:i1], self.ys[i0:i1], self.t[i0:i1],
                                   self.p[i0:i1], self.t0)

    def search_time(self, t: float, side: str = "left") -> int:
        return search_time_shifted(self.t, self.t0, t, side)

    def ts_bounds(self, i0: int, i1: int):
        return _ts_bounds(self.t, i0, i1)

    def frame(self, i: int) -> np.ndarray:
        img = np.asarray(self.images[i])
        if img.ndim == 3:
            img = img[..., 0]
        if img.dtype == np.uint8:
            img = img / 255.0
        return img.astype(np.float32)

    def flow(self, i: int):
        raise IndexError("raw-NPY dataset has no flow")

    def close(self):
        pass


# ------------------------------- converters ----------------------------------


def txt_to_h5(txt_path: str, output_path: str, zero_timestamps: bool = False,
              sensor_size: Optional[Tuple[int, int]] = None, chunksize: int = 100_000) -> None:
    """A whitespace text event stream ``t x y pol`` after one header line
    (``W H`` in the DVS convention, which then gives the sensor size) -> the
    canonical h5 file, ``chunksize`` lines at a time; without a size the
    events' extent gives it."""
    if sensor_size is None:
        with open(txt_path) as fp:
            header = fp.readline().split()
        if len(header) == 2:
            sensor_size = (int(header[1]), int(header[0]))
    first_ts = None
    with H5EventWriter(output_path, sensor_size=sensor_size or (180, 240)) as w:
        max_x = max_y = 0
        with open(txt_path) as fp:
            fp.readline()
            done = False
            while not done:
                ts, xs, ys, ps = [], [], [], []
                for _ in range(chunksize):
                    line = fp.readline()
                    if not line:
                        done = True
                        break
                    t, x, y, p = line.split()
                    ts.append(float(t))
                    xs.append(int(x))
                    ys.append(int(y))
                    ps.append(int(p) > 0)
                if not ts:
                    break
                ts = np.asarray(ts, np.float64)
                if first_ts is None:
                    first_ts = ts[0]
                if zero_timestamps:
                    ts = ts - first_ts
                xs, ys = np.asarray(xs, np.int16), np.asarray(ys, np.int16)
                max_x, max_y = max(max_x, int(xs.max())), max(max_y, int(ys.max()))
                w.append_events(xs, ys, ts, np.asarray(ps))
        if sensor_size is None:
            w.sensor_size = (max_y + 1, max_x + 1)


def zip_to_h5(zip_path: str, output_path: str, zero_timestamps: bool = False,
              sensor_size: Optional[Tuple[int, int]] = None) -> None:
    """A zip of 'frame*' images, an 'images.txt' (t, file name) listing and
    an 'events*' text stream of ``t x y pol`` lines -> the canonical h5 file
    (reference zip_to_h5.py:26+). Images and events are zeroed each by their
    own first timestamp; without a size and without frames the events'
    extent gives it."""
    import zipfile

    zf = zipfile.ZipFile(zip_path, "r")
    names = zf.namelist()
    imgfiles = sorted(n for n in names if "frame" in n)
    evtfile = next((n for n in names if "events" in n), None)
    imgtsfile = next((n for n in names if "images.txt" in n), None)
    if evtfile is None:
        raise ValueError("zip contains no events file")

    first_ts = None
    sensor_known = sensor_size is not None
    with H5EventWriter(output_path, sensor_size=sensor_size or (180, 240)) as w:
        if imgtsfile is not None:
            lines = zf.read(imgtsfile).decode().strip().splitlines()
            for i, line in enumerate(lines[:len(imgfiles)]):
                ts = float(line.split()[0])
                if first_ts is None:
                    first_ts = ts
                if zero_timestamps:
                    ts -= first_ts
                img = _decode_gray_image(zf.read(imgfiles[i]))
                w.add_image(img, ts)
                if sensor_size is None:
                    w.sensor_size = img.shape[:2]
                    sensor_known = True
        # the reference resets first_ts before the event loop (zip_to_h5.py:70-71)
        ev_first_ts = None
        max_x = max_y = 0
        ts_l, xs_l, ys_l, ps_l = [], [], [], []
        for raw in zf.read(evtfile).decode().strip().splitlines():
            t, x, y, pol = raw.split()
            if ev_first_ts is None:
                ev_first_ts = float(t)
            ts_l.append(float(t))
            xs_l.append(int(x))
            ys_l.append(int(y))
            ps_l.append(int(pol) > 0)
            if len(ts_l) >= 100_000:
                max_x, max_y = max(max_x, max(xs_l)), max(max_y, max(ys_l))
                _flush_events(w, ts_l, xs_l, ys_l, ps_l, ev_first_ts, zero_timestamps)
                ts_l, xs_l, ys_l, ps_l = [], [], [], []
        if ts_l:
            max_x, max_y = max(max_x, max(xs_l)), max(max_y, max(ys_l))
            _flush_events(w, ts_l, xs_l, ys_l, ps_l, ev_first_ts, zero_timestamps)
        if not sensor_known:
            # an events-only zip: the placeholder size would mask events beyond it
            w.sensor_size = (max_y + 1, max_x + 1)


def _flush_events(w, ts_l, xs_l, ys_l, ps_l, first_ts, zero_timestamps):
    ts = np.asarray(ts_l, np.float64)
    if zero_timestamps and first_ts is not None:
        ts = ts - first_ts
    w.append_events(np.asarray(xs_l, np.int16), np.asarray(ys_l, np.int16), ts, np.asarray(ps_l))


def _decode_gray_image(data: bytes) -> np.ndarray:
    """An encoded image -> grayscale uint8, through OpenCV where it is
    installed and decodes it, else PIL."""
    try:
        import cv2

        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
        if img is not None:  # cv2 signals failure by returning None
            return img
    except ImportError:
        pass
    try:
        import io

        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    except ImportError as err:
        raise ImportError("no image decoder available (cv2/PIL)") from err


def h5_cut(input_path: str, output_path: str, t_start: float, t_end: float) -> None:
    """Slice an h5 sequence to [t_start, t_end) seconds after its t0, with
    the frames in that range; flow is not copied (the reference h5_cut.py
    writes the cut file with num_flow 0). Timestamps stay float64."""
    with H5EventReader(input_path) as r:
        i0, i1 = r.search_time(t_start), r.search_time(t_end)
        rxs, rys, rts, rps = r.raw_events(i0, i1)
        with H5EventWriter(output_path, sensor_size=r.sensor_size) as w:
            w.append_events(rxs, rys, rts, rps > 0)
            if r.num_frames:
                fts = r.frame_timestamps
                for i in np.nonzero((fts >= t_start) & (fts < t_end))[0]:
                    img = np.asarray(r.f["images"][r._frame_keys[int(i)]])
                    w.add_image(img, float(fts[int(i)]) + r.t0)


def add_hdf5_attribute(path: str, attr: str, value, dataset: Optional[str] = None):
    """Set an attribute of the file (or of ``dataset`` in it) in place
    (reference add_hdf5_attribute.py:28+)."""
    import h5py

    with h5py.File(path, "a") as f:
        (f[dataset] if dataset else f).attrs[attr] = value


def h5_to_memmap(h5_path: str, out_dir: str) -> None:
    """The canonical h5 file -> the RPG memmap layout: t.npy (N,) f64,
    xy.npy (N, 2) int16, p.npy (N,) uint8, images.npy (F, H, W, 1),
    timestamps.npy (F,) absolute, index.npy (F,), dataset_config.json. The
    events are copied in chunks into preallocated memmaps."""
    os.makedirs(out_dir, exist_ok=True)
    with H5EventReader(h5_path) as r:
        n = r.num_events

        def memmap(name, dtype, shape):
            return np.lib.format.open_memmap(os.path.join(out_dir, name), mode="w+",
                                             dtype=dtype, shape=shape)

        t_out, xy_out = memmap("t.npy", np.float64, (n,)), memmap("xy.npy", np.int16, (n, 2))
        p_out = memmap("p.npy", np.uint8, (n,))
        chunk = 1 << 22
        for i0 in range(0, n, chunk):
            i1 = min(i0 + chunk, n)
            rxs, rys, rts, rps = r.raw_events(i0, i1)
            t_out[i0:i1] = rts
            xy_out[i0:i1, 0] = rxs
            xy_out[i0:i1, 1] = rys
            p_out[i0:i1] = rps > 0
        del t_out, xy_out, p_out  # flushes the memmaps
        if r.num_frames:
            imgs = np.stack([np.asarray(r.f["images"][k]) for k in r._frame_keys])
            if imgs.ndim == 3:
                imgs = imgs[..., None]
            np.save(os.path.join(out_dir, "images.npy"), imgs)
            np.save(os.path.join(out_dir, "timestamps.npy"), r.frame_timestamps + r.t0)
            np.save(os.path.join(out_dir, "index.npy"), r.frame_event_indices)
        with open(os.path.join(out_dir, "dataset_config.json"), "w") as fp:
            json.dump({"data_source": "unknown", "sensor_resolution": list(r.sensor_size),
                       "num_events": int(r.num_events)}, fp)


# --------------------------- pre-voxelized writers ---------------------------


def _between_frames_voxel(xs, ys, ts, ps, num_bins: int, sensor_size, combined: bool):
    """One window's raw events (f64 absolute timestamps, 0/1 polarity) ->
    ((C, H, W) f32 voxel, dt) under the reference item rules
    (h5_to_between_frames.py:110-130): fewer than 3 events give zeros and
    dt 0, and separate polarities stack the positive bins first. The
    timestamps are shifted to the window's first event in f64 and then cast
    to f32, as the event pipeline shifts them (h5_dataset.py:215-226), and
    dt is their f64 span."""
    channels = num_bins if combined else 2 * num_bins
    if len(xs) < 3:
        return np.zeros((channels, *sensor_size), np.float32), 0.0
    ts = np.asarray(ts, np.float64)
    dt = float(ts[-1] - ts[0])
    ts = (ts - ts[0]).astype(np.float32)
    ps = np.where(np.asarray(ps) > 0, 1.0, -1.0).astype(np.float32)
    if combined:
        vox = events_to_voxel_np(xs, ys, ts, ps, num_bins, sensor_size)
    else:
        vox = np.concatenate(events_to_neg_pos_voxel_np(xs, ys, ts, ps, num_bins, sensor_size),
                             axis=0)
    return vox.astype(np.float32), dt


def voxel_cache_group(num_bins: int, combined_voxel_channels: bool = True) -> str:
    """The h5 group of the in-h5 voxel cache: the reference's
    ``events_voxels_{B}``, or ``events_voxels_{B}_negpos`` for separate
    polarities."""
    return f"events_voxels_{num_bins}" + ("" if combined_voxel_channels else "_negpos")


def h5_precompute_voxels(path: str, num_bins: int = 5, combined_voxel_channels: bool = True,
                         overwrite: bool = False) -> int:
    """Cache the between-frames voxel grids inside the h5 file, as
    ``<group>/event{:09d}`` datasets with a ``dt`` attribute (the layout the
    reference's DynamicH5Dataset.get_event_voxel reads,
    h5_to_between_frames.py:407-409; ``voxel_cache_group`` names the
    group). Datasets already there are kept unless ``overwrite``. Returns
    the number written."""
    import h5py

    from bde2vid_tpu_torch.data.windowing import between_frames_windows

    with H5EventReader(path) as r:
        windows = between_frames_windows(r.frame_event_indices)
        length = max(r.num_frames - 1, 0)
        sensor = r.sensor_size
    if length == 0:
        return 0
    written = 0
    with h5py.File(path, "r+") as f:
        grp = f.require_group(voxel_cache_group(num_bins, combined_voxel_channels))
        existing = set(grp)
        xs_d, ys_d, ts_d, ps_d = (f[f"events/{k}"] for k in ("xs", "ys", "ts", "ps"))
        for i in range(length):
            name = f"event{i:09d}"
            if name in existing and not overwrite:
                continue
            i0, i1 = int(windows[i][0]), int(windows[i][1])
            vox, dt = _between_frames_voxel(xs_d[i0:i1], ys_d[i0:i1], ts_d[i0:i1], ps_d[i0:i1],
                                            num_bins, sensor, combined_voxel_channels)
            if name in grp:
                del grp[name]
            grp.create_dataset(name, data=vox).attrs["dt"] = dt
            written += 1
    return written


def h5_to_prevoxelized_npy(h5_path: str, out_dir: str, num_bins: int = 5,
                           combined_voxel_channels: bool = True,
                           event_folder: Optional[str] = None,
                           frame_folder: str = "frames") -> None:
    """An h5 sequence -> the pre-voxelized NPY tree (``write_prevoxelized_npy``)."""
    with H5EventReader(h5_path) as r:
        write_prevoxelized_npy(r, out_dir, num_bins, combined_voxel_channels, event_folder,
                               frame_folder)


def write_prevoxelized_npy(reader, out_dir: str, num_bins: int = 5,
                           combined_voxel_channels: bool = True,
                           event_folder: Optional[str] = None,
                           frame_folder: str = "frames") -> None:
    """The between-frames windows of a reader's sequence (any reader with
    the H5EventReader surface) -> the pre-voxelized NPY tree (reference
    VoxelGridDataset layout, event_dataset.py:111-158):

        out/{VoxelGrid-betweenframes-B}/voxels.npy   (L, C, H, W) float32
        out/{...}/timestamps.txt                     "idx ts" a voxel
        out/frames/frames.npy                        (F, H, W) uint8
        out/frames/timestamps.txt                    "idx ts" a frame

    Voxel i holds the events before frame i and carries frame i's
    timestamp, so pairing each voxel with the first frame at or after it
    gives the event sequence's item pairing."""
    from bde2vid_tpu_torch.data.windowing import between_frames_windows

    event_folder = event_folder or f"VoxelGrid-betweenframes-{num_bins}"
    ef, ff = os.path.join(out_dir, event_folder), os.path.join(out_dir, frame_folder)
    os.makedirs(ef, exist_ok=True)
    os.makedirs(ff, exist_ok=True)
    windows = between_frames_windows(reader.frame_event_indices)
    length = max(reader.num_frames - 1, 0)
    voxels = [_between_frames_voxel(*reader.raw_events(int(windows[i][0]), int(windows[i][1])),
                                    num_bins, reader.sensor_size, combined_voxel_channels)[0]
              for i in range(length)]
    if reader.num_frames == 0:
        raise ValueError(f"{reader.path} has no frames — the pre-voxelized NPY layout "
                         "pairs every voxel with a frame")
    fts = reader.frame_timestamps + reader.t0
    # grayscale through the reader (BGR frames too); rint keeps u8 -> /255 -> *255 exact
    frames = np.stack([np.rint(reader.frame(i) * 255.0).astype(np.uint8)
                       for i in range(reader.num_frames)])
    channels = num_bins if combined_voxel_channels else 2 * num_bins
    np.save(os.path.join(ef, "voxels.npy"), np.stack(voxels) if voxels else
            np.zeros((0, channels, *frames.shape[-2:]), np.float32))
    with open(os.path.join(ef, "timestamps.txt"), "w") as fp:
        for i in range(length):
            fp.write(f"{i} {fts[i]:.9f}\n")
    np.save(os.path.join(ff, "frames.npy"), frames)
    with open(os.path.join(ff, "timestamps.txt"), "w") as fp:
        for i, t in enumerate(fts):
            fp.write(f"{i} {t:.9f}\n")
