"""What every entry of the benchmark shares: reading a cell's files by name,
the device checks, the result line, the check that no JAX module was
loaded, and the reduction of a traced run to layer times.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix. Its files, found by those names:

- ``configs/<config>.json``: the model as it runs (``model``, ``args``,
  ``num_encoders``, ``sequence_model``, ``reference``: the module under
  ``reference/`` that computes it plainly);
- ``traffic/<traffic>.json``: the parameters of the mix and its ``entry``,
  the module under ``entries/`` that drives it;
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
- ``metrics/<metric>.py``: one reader per per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level modules a run may not load: the JAX stack and the JAX package
# (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "bde2vid_tpu"})
# H100 SXM, NVIDIA's data sheet (dense, 700 W): f32 outside the tensor cores, HBM3
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12


def benchmark() -> Dict:
    with open(ROOT / "BENCHMARK.json") as fp:
        return json.load(fp)


def _json(*parts: str) -> Dict:
    with open(BENCH_DIR.joinpath(*parts)) as fp:
        return json.load(fp)


class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str, bench: Optional[Dict] = None):
        bench = bench or benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
        self.name = name
        self.spec = cells[name]
        self.chips = int(self.spec["chips"])
        self.config = _json("configs", self.spec["config"] + ".json")
        self.traffic = _json("traffic", self.spec["traffic"] + ".json")
        self.limits = _json("limits", name + ".json")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m, bench)]

    def _reports(self, metric: Dict, bench: Dict) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
        return self.name in moved.get("workloads", [self.name])

    def entry(self):
        return importlib.import_module(f"benchmark.entries.{self.traffic['entry']}")

    def reference(self):
        return importlib.import_module(f"benchmark.reference.{self.config['reference']}")


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def check_no_jax() -> None:
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {found}", file=sys.stderr)
        raise SystemExit(4)


def require_cards(chips: int) -> None:
    """Exit without a result unless CUDA has ``chips`` cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: this cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        raise SystemExit(3)


def set_precision() -> None:
    """f32 with TF32 off for matmuls and cuDNN: the precision the cells state."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class tf32:
    """Within: TF32 on for matmuls and cuDNN (the control's precision)."""

    def __enter__(self):
        import torch

        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        set_precision()


def device_info(device, peak_bytes: int, chips: int) -> Dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def built_files() -> int:
    """Files under the checkout's ``build/``, where the program caches what
    it compiles: more after a run than before it means the run compiled."""
    return sum(1 for p in (ROOT / "build").rglob("*") if p.is_file())


def metric(value: float, unit: str) -> Dict:
    return {"value": value, "unit": unit}


def judge(numbers: Dict[str, float], limits: Dict) -> Tuple[bool, Dict]:
    """(correct, {name: {value, limit}}): every number finite and within its
    limit; a number without a limit, or a limit without a number, fails."""
    checks = {n: {"value": numbers.get(n, math.inf), "limit": limits[n]["limit"]} for n in limits}
    for n in numbers:
        checks.setdefault(n, {"value": numbers[n], "limit": None})
    ok = all(c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def emit(result: Dict) -> None:
    """Print the compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output,
    its ``checks`` key last."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


# ---------------------------------------------------------------- tracing

class Ranges:
    """``record_function`` ranges opened and closed by hooks on the modules
    and wrappers of the functions the benchmark hands to the program; all
    removed by ``close``."""

    def __init__(self):
        self._open: List = []
        self._undo: List = []

    def enter(self, name: str) -> None:
        import torch

        rf = torch.autograd.profiler.record_function(name)
        rf.__enter__()
        self._open.append(rf)

    def exit(self) -> None:
        self._open.pop().__exit__(None, None, None)

    def module(self, module, name: str, on_enter=None) -> None:
        def pre(mod, args):
            if on_enter is not None:
                on_enter(mod, args)
            self.enter(name)

        self._undo += [module.register_forward_pre_hook(pre).remove,
                       module.register_forward_hook(lambda *_: self.exit()).remove]

    def hooks(self, *handles) -> None:
        """Hook handles to remove on ``close``."""
        self._undo += [h.remove for h in handles]

    def function(self, owner, attr: str, name: str) -> None:
        """Wrap ``owner[attr]`` (a dict entry) or ``owner.attr`` in a range."""
        is_dict = isinstance(owner, dict)
        fn = owner[attr] if is_dict else getattr(owner, attr)

        def wrapped(*a, **k):
            self.enter(name)
            try:
                return fn(*a, **k)
            finally:
                self.exit()

        if is_dict:
            owner[attr] = wrapped
            self._undo.append(lambda: owner.__setitem__(attr, fn))
        elif attr in vars(owner):  # a module's function
            setattr(owner, attr, wrapped)
            self._undo.append(lambda: setattr(owner, attr, fn))
        else:  # an instance's method: the class's shows again
            setattr(owner, attr, wrapped)
            self._undo.append(lambda: delattr(owner, attr))

    def close(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()


WINDOW_RANGE = "bench.window"
# the host's kernel launches as the profiler records them (runtime and driver API)
LAUNCH = re.compile(r"^cu(da)?Launch(Cooperative)?Kernel")


def profiled(calls, device, library_calls, tries: int = 3) -> Dict:
    """``calls()`` under the profiler inside ``WINDOW_RANGE``, reduced by
    ``summarize``. The profiler drops device records at times: a trace in
    which a kernel launch the host made has no device record, or which
    holds fewer launches than the calls of the program's kernel libraries
    counted meanwhile by ``library_calls()`` (each launches one kernel or
    more), is taken again, up to ``tries`` times. ``calls`` starts afresh
    whatever it accumulates."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for attempt in range(tries):
        before = library_calls()
        with profile(activities=activities) as prof:
            with torch.autograd.profiler.record_function(WINDOW_RANGE):
                calls()
        made = library_calls() - before
        summary = summarize(prof)
        launches, lost = summary["launches"], summary["launches_lost"]
        print(f"trace {attempt}: {launches} kernel launches, {lost} without a device record, "
              f"{summary['unlaunched']} device kernels without a launch record, {made} library calls",
              file=sys.stderr)
        if not cuda or (lost == 0 and launches >= made):
            return summary
    raise RuntimeError(f"{tries} traces lost device records: {lost} of {launches} launches, "
                       f"{made} library calls")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def kernel_name(name: str) -> str:
    """A device kernel's bare name: no return type, namespace or arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def summarize(prof, top: int = 10) -> Dict:
    """Reduce a profile whose steady calls ran under ``WINDOW_RANGE``: device
    ms under each ``bench.*`` range, the busy and window seconds, the
    device kernels by bare name, the host's kernel launches and those of
    them without a device record, and the breakdown: the device operations
    that took most time and the idle time by the innermost range the host
    was in."""
    from torch.autograd import DeviceType

    events = prof.events()
    ranges = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("bench.")]
    window = [e for e in ranges if e.name == WINDOW_RANGE]
    if len(window) != 1:
        raise RuntimeError(f"expected one {WINDOW_RANGE} range in the trace, found {len(window)}")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    # a device operation belongs to the ranges open on the host when the
    # runtime or driver call that launched it ran: the call and the
    # operation carry the same (CUPTI) correlation id
    api = {e.id: e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    launch_ids = {i for i, e in api.items() if LAUNCH.match(e.name)}
    kernel_ids = set()
    within = _Within([e for e in ranges if e.name != WINDOW_RANGE])
    device_ms: Dict[str, float] = {}
    ops: Dict[str, float] = {}
    kernels: Dict[str, int] = {}
    busy = []
    for e in events:
        if (e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("bench.")):
            kernels[kernel_name(e.name)] = kernels.get(kernel_name(e.name), 0) + 1
            if not e.name.startswith(("Memcpy", "Memset")):
                kernel_ids.add(e.id)
            call = api.get(e.id)
            for name in within(call.time_range.start) if call is not None else ():
                device_ms[name] = device_ms.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
            a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if b > a:
                busy.append((a, b))
                ops[e.name[:96]] = ops.get(e.name[:96], 0.0) + (b - a) / 1e6
    busy = _merge(busy)
    label_at = _innermost([e for e in ranges if e.name != WINDOW_RANGE])
    idle: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            label = label_at(0.5 * (a + b))
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return {
        "device_ms": device_ms,
        "launches": len(launch_ids),
        "launches_lost": len(launch_ids - kernel_ids),
        "unlaunched": len(kernel_ids - launch_ids),
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "kernels": kernels,
        "breakdown": {
            "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:top],
        },
    }


class _Within:
    """time -> the names of the ranges open at that time (ranges of one name
    do not nest)."""

    def __init__(self, ranges):
        self.spans: Dict[str, Tuple[List[float], List[float]]] = {}
        for e in sorted(ranges, key=lambda e: e.time_range.start):
            starts, ends = self.spans.setdefault(e.name, ([], []))
            starts.append(e.time_range.start)
            ends.append(e.time_range.end)

    def __call__(self, t: float) -> List[str]:
        import bisect

        out = []
        for name, (starts, ends) in self.spans.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ends[i]:
                out.append(name)
        return out


def _innermost(ranges):
    """time -> the name of the innermost of the (nested) ``ranges`` open at
    that time on the host, or "between ranges"."""
    import bisect

    marks = sorted([(e.time_range.start, 1, -e.time_range.end, e.name) for e in ranges]
                   + [(e.time_range.end, 0, 0, e.name) for e in ranges])
    times, labels, stack = [], [], []
    for t, opens, _, name in marks:
        if opens:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        times.append(t)
        labels.append(stack[-1] if stack else "between ranges")

    def at(t):
        i = bisect.bisect_right(times, t) - 1
        return labels[i] if i >= 0 else "between ranges"

    return at


def read_per_layer(cell: Cell, summary: Dict) -> Dict[str, Dict]:
    """Each per-layer metric of the cell from its reader
    ``metrics/<name>.py::read(summary)``; a reader that finds nothing
    returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        path = BENCH_DIR / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(summary)
        if value is not None:
            out[m["name"]] = metric(value, m["unit"])
    return out


def ensure_importable() -> None:
    """Put the checkout's root first on ``sys.path`` (the program and this
    package live there)."""
    root = str(ROOT)
    if root not in sys.path:
        sys.path.insert(0, root)
    os.environ.setdefault("USE_FLAX", "0")
