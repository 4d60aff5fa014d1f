"""Rasterization micro-benchmark (counterpart of
``bde2vid_tpu/events/bench_voxel.py``; reference event_utils.py:763-856):

    python -m bde2vid_tpu_torch.events.bench_voxel [--h5 FILE] [--iters N]
        [--n_events N] [--num_bins B] [--device D]

Times the integer and bilinear images, the voxel grid, the polarity-split
voxel grids, the timestamp images, the batched voxel grids of 64 windows,
the native packer and its host voxelizer, and with ``--h5`` the file's
binary search. Device rows are timed with CUDA events after a warm-up on
the card (wall clock on the CPU); host rows with the wall clock. ``--device``
defaults to CUDA and raises without it.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

BATCH = 64  # windows of the batched row (the eval pipeline's voxel batch)


def device_ms(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Mean ms of ``fn`` after one warm-up call."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    return host_ms(fn, iters)


def host_ms(fn: Callable[[], object], iters: int) -> float:
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def synthetic_events(n: int, sensor: Tuple[int, int] = (180, 240), seed: int = 0):
    """``n`` uniform events over 50 ms: int32 xs, ys, sorted f32 ts, +-1 ps."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, sensor[1], n).astype(np.int32)
    ys = rng.integers(0, sensor[0], n).astype(np.int32)
    ts = np.sort(rng.uniform(0, 0.05, n)).astype(np.float32)
    ps = rng.choice(np.array([-1.0, 1.0], np.float32), n)
    return xs, ys, ts, ps


def run(xs, ys, ts, ps, sensor: Tuple[int, int], num_bins: int, iters: int,
        device: torch.device) -> List[Dict]:
    """One row per path: {"name", "ms", "events", "mev_s"}."""
    from bde2vid_tpu_torch.events.voxel import (
        events_to_image,
        events_to_image_bilinear,
        events_to_neg_pos_voxel,
        events_to_timestamp_image,
        events_to_voxel,
        events_to_voxel_batch,
        pad_events,
    )
    from bde2vid_tpu_torch.native import pack_windows, voxelize_batch

    n = len(xs)
    padded = pad_events(xs, ys, ts, ps)
    nv = padded[4]
    px, py, pt, pp = (torch.from_numpy(a).to(device) for a in padded[:4])
    fx, fy = px.float(), py.float()
    rows = []

    def row(name, ms, events):
        rows.append({"name": name, "ms": ms, "events": events, "mev_s": events / ms / 1e3})

    kw = dict(sensor_size=sensor)
    for name, fn in (
        ("events_to_image", lambda: events_to_image(px, py, pp, nv, **kw)),
        ("events_to_image_bilinear", lambda: events_to_image_bilinear(fx, fy, pp, nv, **kw)),
        (f"events_to_voxel (B={num_bins})",
         lambda: events_to_voxel(px, py, pt, pp, nv, num_bins=num_bins, **kw)),
        ("events_to_neg_pos_voxel",
         lambda: events_to_neg_pos_voxel(px, py, pt, pp, nv, num_bins=num_bins, **kw)),
        ("events_to_timestamp_image", lambda: events_to_timestamp_image(fx, fy, pt, pp, nv, **kw)),
    ):
        row(name, device_ms(fn, iters, device), n)

    bx, by, bt, bp = (t[None].repeat(BATCH, 1) for t in (px, py, pt, pp))
    bn = torch.full((BATCH,), nv, dtype=torch.int32, device=device)
    row(f"events_to_voxel_batch ({BATCH} windows)",
        device_ms(lambda: events_to_voxel_batch(bx, by, bt, bp, bn, num_bins=num_bins, **kw),
                  max(iters // 4, 1), device), BATCH * n)

    windows = np.array([[0, n]], np.int64)
    raw = (xs.astype(np.int16), ys.astype(np.int16), ts.astype(np.float64),
           (ps > 0).astype(np.uint8))
    packed = pack_windows(*raw, windows, len(padded[0]))
    row("native pack_windows (host)", host_ms(lambda: pack_windows(*raw, windows, len(padded[0])),
                                              iters), n)
    row("native voxelize_batch (host)",
        host_ms(lambda: voxelize_batch(*packed, num_bins, sensor), max(iters // 4, 1)), n)
    return rows


def main(argv=None) -> int:
    from bde2vid_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--h5", default=None, help="event h5 file (synthetic events if absent)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--n_events", type=int, default=150_000)
    p.add_argument("--num_bins", type=int, default=5)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    search = None
    if args.h5:
        from bde2vid_tpu_torch.events.h5_io import H5EventReader

        with H5EventReader(args.h5) as r:
            sl = r.events(0, min(args.n_events, r.num_events))
            xs, ys, ts, ps = sl.xs, sl.ys, sl.ts, sl.ps
            sensor = r.sensor_size
            search = host_ms(lambda: r.search_time(float(sl.ts[len(sl.ts) // 2])), args.iters)
    else:
        sensor = (180, 240)
        xs, ys, ts, ps = synthetic_events(args.n_events, sensor)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{len(xs)} events, sensor {sensor}, device {name}, iters {args.iters}")
    if search is not None:
        print(f"{'h5 binary search (host)':40s} {search:9.3f} ms")
    for r in run(xs, ys, ts, ps, sensor, args.num_bins, args.iters, device):
        print(f"{r['name']:40s} {r['ms']:9.3f} ms  ({r['mev_s']:8.1f} Mev/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
