"""Timers with an atexit summary, and a device trace (counterpart of
``bde2vid_tpu/utils/timers.py``; reference utils_func/timers.py).

``Timer`` is the host's wall clock. ``CudaTimer`` records CUDA events on
the current stream around its block and synchronises at exit, so that it
measures the work the block queued on the card, not its dispatch; with
``device="cpu"`` it is the wall clock, by the caller's choice and never as
a fallback. ``DeviceTrace`` profiles its block with ``torch.profiler`` and
writes a Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import atexit
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List

import torch

_timers: Dict[str, List[float]] = defaultdict(list)
_enabled = True


def set_enabled(flag: bool):
    global _enabled
    _enabled = flag


class Timer:
    """Wall-clock context timer accumulating per-name statistics."""

    def __init__(self, name: str = "timer"):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def _record(self, seconds: float) -> None:
        self.interval = seconds
        if _enabled:
            _timers[self.name].append(seconds)

    def __exit__(self, *exc):
        self._record(time.perf_counter() - self.t0)


class CudaTimer(Timer):
    """Device timer (reference CudaTimer, timers.py:15-38): CUDA events on
    the current stream of ``device`` (CUDA unless the CPU is asked for),
    synchronised at exit; on the CPU, the wall clock. ``sync(out)`` keeps
    the JAX package's interface and returns ``out``: the events already
    cover every kernel the block queued."""

    def __init__(self, name: str = "device_timer", device=None):
        from bde2vid_tpu_torch.utils.device import resolve_device

        super().__init__(name)
        self.device = resolve_device(device)
        self.result = None

    def sync(self, result):
        self.result = result
        return result

    def __enter__(self):
        if self.device.type == "cpu":
            return super().__enter__()
        stream = torch.cuda.current_stream(self.device)
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        self._start.record(stream)
        return self

    def __exit__(self, *exc):
        if self.device.type == "cpu":
            return super().__exit__(*exc)
        self._end.record(torch.cuda.current_stream(self.device))
        self._end.synchronize()
        self._record(self._start.elapsed_time(self._end) / 1e3)


def timer_summary() -> str:
    lines = []
    for name, vals in sorted(_timers.items()):
        n = len(vals)
        total = sum(vals)
        lines.append(
            f"{name}: n={n} total={total*1e3:.1f}ms mean={total/n*1e3:.3f}ms "
            f"min={min(vals)*1e3:.3f}ms max={max(vals)*1e3:.3f}ms"
        )
    return "\n".join(lines)


@atexit.register
def _print_summary():  # pragma: no cover
    if _timers and _enabled:
        print("== timer summary ==")
        print(timer_summary())


class DeviceTrace:
    """``torch.profiler`` over the block (host and, for a CUDA ``device``,
    the card's kernels), written as a Chrome trace ``trace.json`` into
    ``log_dir``."""

    def __init__(self, log_dir: str = os.path.join(tempfile.gettempdir(), "bde2vid_trace"),
                 device=None):
        from bde2vid_tpu_torch.utils.device import resolve_device

        self.log_dir = log_dir
        self.device = resolve_device(device)

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.profile = torch.profiler.profile(activities=acts)
        self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profile.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, "trace.json")
        self.profile.export_chrome_trace(self.path)
        if _enabled:
            print(f"device trace written to {self.path}")
