"""The seeded event recording of a traffic mix, in the RPG memmap (MMP)
layout the port's ``MMP`` backend reads.

Frozen from ``chip_smoke.py::write_mmp_sequence`` and extended to any
sensor and to a law of events per frame: ``frames`` frame timestamps at
``fps`` after t = 1000 s, and between consecutive frames (from t = 1000 s
before the first) a window of events uniform in x, y and time, sorted by
time, polarity 0/1 at even odds. The counts of the ``frames - 1`` windows
are the log-uniform quantiles (k + 0.5) / (frames - 1) between
``events_per_frame[0]`` and ``[1]``, in an order drawn from the seed: every
seed has the same sizes, so the same work, in another order. The frames
are uint8 sinusoid gratings with phases drawn from the seed.

A recording is written once per (traffic, its parameters, seed) under
``$TMPDIR/bde2vid_benchmark/`` and renamed into place when complete, so
runs of one seed (both sets of a check, two cells of one traffic) read
the same files and write them once. Writing it is the benchmark making
its input, not the program's set-up: ``recording`` flushes it to disk and
returns the seconds that took, which the entries take out of ``setup_s``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Dict, Tuple

import numpy as np

T_START = 1000.0


def window_counts(params: Dict, rng: np.random.Generator) -> np.ndarray:
    """Events of each of the ``frames - 1`` windows."""
    n = params["frames"] - 1
    lo, hi = (np.log(v) for v in params["events_per_frame"])
    q = (np.arange(n) + 0.5) / n
    return rng.permutation(np.round(np.exp(lo + q * (hi - lo))).astype(np.int64))


def write(path: str, params: Dict, seed: int, stream: int = 0) -> None:
    """Recording ``stream`` of ``params`` for ``seed`` in directory ``path``."""
    rng = np.random.default_rng([seed & ((1 << 63) - 1), 0xE7E, stream])
    h, w = params["sensor"]
    frames = params["frames"]
    frame_ts = T_START + (np.arange(frames) + 1) / params["fps"]
    counts = window_counts(params, rng)
    edges = np.concatenate([[T_START], frame_ts[:-1]])
    ts = np.concatenate([np.sort(rng.uniform(edges[k], edges[k + 1], c)) for k, c in enumerate(counts)])
    n = len(ts)
    xy = np.empty((n, 2), np.int16)
    xy[:, 0] = rng.integers(0, w, n, dtype=np.int16)
    xy[:, 1] = rng.integers(0, h, n, dtype=np.int16)
    os.makedirs(path)
    np.save(os.path.join(path, "t.npy"), ts)
    np.save(os.path.join(path, "xy.npy"), xy)
    np.save(os.path.join(path, "p.npy"), rng.integers(0, 2, n, dtype=np.uint8))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx, fy, phase = rng.uniform(8.0, 32.0, 3), rng.uniform(8.0, 32.0, 3), rng.uniform(0, 2 * np.pi, 3)
    imgs = np.empty((frames, h, w, 1), np.uint8)
    for k in range(frames):
        g = sum(np.sin(xx / fx[j] + k / 3.0 + phase[j]) * np.cos(yy / fy[j]) for j in range(3))
        imgs[k, ..., 0] = np.clip(127.5 + 40.0 * g, 0, 255).astype(np.uint8)
    np.save(os.path.join(path, "images.npy"), imgs)
    np.save(os.path.join(path, "timestamps.npy"), frame_ts)
    with open(os.path.join(path, "dataset_config.json"), "w") as fp:
        json.dump({"sensor_resolution": [h, w]}, fp)


def _sync(top: str) -> None:
    """Flush every file under ``top`` to disk, so that no write-back of the
    recording falls into the measured window."""
    for d, _, files in os.walk(top):
        for f in files:
            fd = os.open(os.path.join(d, f), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)


def recording(traffic: str, params: Dict, seed: int) -> Tuple[str, float]:
    """The directory of the recording of ``traffic`` for ``seed``, written
    first where it is not there yet, and the seconds spent writing it (0
    where it was there). With ``"sequences": n`` in ``params`` it holds n
    recordings, ``seq0`` ... ``seq{n-1}``, a training set."""
    root = os.path.join(tempfile.gettempdir(), "bde2vid_benchmark")
    digest = hashlib.sha1(json.dumps(params, sort_keys=True).encode()).hexdigest()[:8]
    path = os.path.join(root, f"{traffic}-{digest}-{seed}")
    t0 = time.perf_counter()
    if not os.path.isdir(path):
        os.makedirs(root, exist_ok=True)
        partial = tempfile.mkdtemp(prefix=f"{traffic}-{seed}.", dir=root)
        try:
            if "sequences" in params:
                for i in range(params["sequences"]):
                    write(os.path.join(partial, "rec", f"seq{i}"), params, seed, i)
            else:
                write(os.path.join(partial, "rec"), params, seed)
            _sync(partial)
            try:
                os.rename(os.path.join(partial, "rec"), path)
            except OSError:  # another run of the seed finished first
                if not os.path.isdir(path):
                    raise
        finally:
            shutil.rmtree(partial, ignore_errors=True)
        return path, time.perf_counter() - t0
    return path, 0.0
