"""Build, load and call the host-side event packer ``evpack.cc`` (counterpart
of ``bde2vid_tpu/native/loader.py``).

The library is compiled with ``g++`` at first use into ``<repo>/build/native/``,
named by a hash of its source, the way ``ops/build.py`` builds the CUDA
kernels, and loaded with ``ctypes``; nothing happens at import time. A failed
build raises with the compiler's output. ``pack_windows(packer="numpy")``
runs the plain NumPy twin of the packer instead, only when asked for: the
twin is the reference the native packer is held to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "evpack.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
PACKERS = ("native", "numpy")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
pack_counts = {packer: 0 for packer in PACKERS}  # pack_windows calls by packer

Packed = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def library_path() -> Path:
    """Where the library is built, named by a hash of its source."""
    return BUILD_DIR / f"evpack-{hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built already; raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError("g++ not found: the event packer is built with g++") from None
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            arr = np.ctypeslib.ndpointer
            i64 = ctypes.c_int64
            lib.pack_windows.restype = ctypes.c_int
            lib.pack_windows.argtypes = [
                arr(np.int16, flags="C"), arr(np.int16, flags="C"), arr(np.float64, flags="C"),
                arr(np.uint8, flags="C"), arr(np.int64, flags="C"), i64, i64,
                arr(np.int16, flags="C"), arr(np.int16, flags="C"), arr(np.float32, flags="C"),
                arr(np.int8, flags="C"), arr(np.int32, flags="C")]
            lib.voxelize_batch.restype = None
            lib.voxelize_batch.argtypes = [
                arr(np.int16, flags="C"), arr(np.int16, flags="C"), arr(np.float32, flags="C"),
                arr(np.int8, flags="C"), arr(np.int32, flags="C"), i64, i64, i64, i64, i64,
                arr(np.float32, flags="C")]
            _lib = lib
        return _lib


def _pack_numpy(xs, ys, ts, ps, windows, out: Packed) -> None:
    """The plain twin: one window at a time, the same arithmetic."""
    oxs, oys, ots, ops, ons = out
    for w, (i0, i1) in enumerate(windows):
        n = int(i1 - i0)
        oxs[w, :n] = xs[i0:i1]
        oys[w, :n] = ys[i0:i1]
        tw = np.asarray(ts[i0:i1], np.float64)
        ots[w, :n] = (tw - (tw[0] if n else 0.0)).astype(np.float32)
        ops[w, :n] = np.where(np.asarray(ps[i0:i1]) > 0, 1, -1)
        oxs[w, n:] = 0
        oys[w, n:] = 0
        ots[w, n:] = ots[w, n - 1] if n else 0.0
        ops[w, n:] = 0
        ons[w] = n


def pack_windows(xs: np.ndarray, ys: np.ndarray, ts: np.ndarray, ps: np.ndarray,
                 windows: np.ndarray, capacity: int, packer: str = "native",
                 out: Optional[Sequence[np.ndarray]] = None) -> Packed:
    """Pack windows ``[start, end)`` (int64 (n, 2), indices into the event
    arrays: int16 xs, ys, f64 absolute ts, 0/1 ps) into padded (n,
    ``capacity``) buffers: int16 xs, ys, f32 ts rebased to each window's
    first event in f64, int8 polarity -1/+1 (0 in the padding, whose
    timestamp repeats the window's last), and int32 counts. ``out`` gives
    the five C-contiguous buffers to fill (pinned ones, say); they are
    allocated otherwise. ``packer`` is "native" (the g++ library) or
    "numpy" (the plain twin)."""
    if packer not in PACKERS:
        raise ValueError(f"packer must be one of {PACKERS}, not {packer!r}")
    windows = np.ascontiguousarray(windows, np.int64).reshape(-1, 2)
    n_windows = len(windows)
    # checked here: the library indexes the event arrays with these values
    if not len(xs) == len(ys) == len(ts) == len(ps):
        raise ValueError("event component arrays differ in length")
    if n_windows:
        if windows.min() < 0 or windows.max() > len(xs):
            raise ValueError(f"window indices out of range [0, {len(xs)}]: "
                             f"[{windows.min()}, {windows.max()}]")
        sizes = windows[:, 1] - windows[:, 0]
        if (sizes < 0).any():
            raise ValueError("window end precedes start")
        if sizes.max() > capacity:
            raise ValueError(f"a window of {sizes.max()} events exceeds capacity {capacity}")
    shapes = ((np.int16, (n_windows, capacity)), (np.int16, (n_windows, capacity)),
              (np.float32, (n_windows, capacity)), (np.int8, (n_windows, capacity)),
              (np.int32, (n_windows,)))
    if out is None:
        out = tuple(np.empty(shape, dt) for dt, shape in shapes)
    elif len(out) != 5 or any(a.dtype != dt or a.shape != shape or not a.flags.c_contiguous
                              for a, (dt, shape) in zip(out, shapes)):
        raise ValueError(f"out must be five C-contiguous buffers of {shapes}")
    out = tuple(out)
    pack_counts[packer] += 1
    if packer == "numpy":
        _pack_numpy(xs, ys, ts, ps, windows, out)
        return out
    rc = load().pack_windows(
        np.ascontiguousarray(xs, np.int16), np.ascontiguousarray(ys, np.int16),
        np.ascontiguousarray(ts, np.float64), np.ascontiguousarray(ps, np.uint8),
        windows, n_windows, capacity, *out)
    if rc != 0:
        raise ValueError("window larger than capacity")
    return out


def voxelize_batch(xs: np.ndarray, ys: np.ndarray, ts: np.ndarray, ps: np.ndarray,
                   ns: np.ndarray, num_bins: int, sensor_size: Tuple[int, int]) -> np.ndarray:
    """Host voxel grids (n, B, H, W) f32 of packed buffers (the library's
    ``voxelize_batch``; fewer than 3 events give a zero grid)."""
    n_windows, capacity = xs.shape
    ns = np.asarray(ns)
    if len(ns) != n_windows or (ns > capacity).any() or (ns < 0).any():
        raise ValueError("ns out of range for the packed buffers")
    h, w = sensor_size
    out = np.empty((n_windows, num_bins, h, w), np.float32)
    load().voxelize_batch(
        np.ascontiguousarray(xs, np.int16), np.ascontiguousarray(ys, np.int16),
        np.ascontiguousarray(ts, np.float32), np.ascontiguousarray(ps, np.int8),
        np.ascontiguousarray(ns, np.int32), n_windows, capacity, num_bins, h, w, out)
    return out
