#!/usr/bin/env python3
"""Time the port's attention backward (``attn_core_backward``) of one source
tree at the long-row and key-tile shapes on one NVIDIA GPU.

    python3 tools/attn_bwd_times.py ROOT LABEL [--split] [--steps] [--only NAME]

ROOT is a checkout of this repository (an older commit unpacked with ``git
archive`` under ``build/`` compares against it: run parent, change, change,
parent in one session on one card). The tree's kernels are built into its own
``build/kernels``. Each shape, f32 and bf16, prints one JSON line: device ms
a call (``chip_smoke.device_ms`` of this script's tree: CUDA events around
calls queued behind a spin kernel, best of three), the largest error over the
kernel-vs-twin gate (f32 1e-4 x max(1, max|twin|), bf16 2e-2 x max|twin|),
whether two runs are bit-identical, the device memory one call allocates at
its peak beyond its inputs (MiB), the plan's instantiation's occupancy and,
with ``--split``, device us a call by kernel (torch.profiler). Shapes:
the flagship's levels at 21 buffer frames, the 8x8 config's at 17 and
window_size (12, 12) (M 144) at 3 and 7 frames (long rows), the flagship's
level 2 at 31 frames and the first N past the old key limits and far rows
(key tiles), 16 heads; ``--only NAME`` keeps the shapes whose name starts
with NAME. ``--steps`` then runs the tree's own
``chip_smoke.long_buffer_steps`` (a remat train step of the flagship at 21
buffer frames and of the 8x8 config at 17) and prints its step ms and peak
memory.
"""

import importlib.util
import json
import os
import sys
import time

SHAPES = (("long", "flagship L0", 252, 49, 1029, 64), ("long", "flagship L2", 20, 49, 1029, 256),
          ("long", "8x8 L0", 180, 64, 1088, 64), ("long", "8x8 L2", 12, 64, 1088, 256),
          ("long", "12x12 L0 3f", 80, 144, 432, 64), ("long", "12x12 L2 3f", 8, 144, 432, 256),
          ("long", "12x12 L0 7f", 80, 144, 1008, 64), ("long", "12x12 L2 7f", 8, 144, 1008, 256),
          ("tiles", "flagship L2 31f", 20, 49, 1519, 256),
          ("tiles", "edge hd4", 5, 49, 7197, 64), ("tiles", "edge hd16", 5, 49, 1401, 256),
          ("tiles", "edge hd4", 5, 64, 7177, 64), ("tiles", "edge hd16", 5, 64, 1385, 256),
          ("tiles", "edge hd16", 5, 49, 2989, 256), ("tiles", "edge hd4", 5, 49, 7399, 64))
HEADS = 16


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    split, steps = "--split" in sys.argv[3:], "--steps" in sys.argv[3:]
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv else ""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    device_ms = _load("attn_times_smoke", os.path.join(here, "chip_smoke.py")).device_ms
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("attn_bwd_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from bde2vid_tpu_torch.ops import build
    from bde2vid_tpu_torch.ops import window_attn_cuda as w

    t0 = time.perf_counter()
    build.build(["attn_core_bwd"])
    print(json.dumps({"tree": label, "root": root, "build_s": time.perf_counter() - t0}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    for kind, name, b, m, n, c in (s for s in SHAPES if s[1].startswith(only)):
        q32, k32, v32, g32 = rnd(b, m, c), rnd(b, n, c), rnd(b, n, c), rnd(b, m, c)
        bias = rnd(HEADS, m, n, scale=0.5)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, g = (t.to(dt) for t in (q32, k32, v32, g32))

            def fn():
                return w.attn_core_backward(q, k, v, bias, g, HEADS)

            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = fn()
            torch.cuda.synchronize()
            peak_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
            again = fn()
            ref = w.attn_core_backward_reference(q, k, v, bias, g, HEADS)
            torch.cuda.synchronize()
            over = 0.0
            for a, r in zip(got, ref):
                top = r.float().abs().max().item()
                tol = 1e-4 * max(1.0, top) if dt == torch.float32 else 2e-2 * top
                over = max(over, (a.float() - r.float()).abs().max().item() / tol)
            row = {"tree": label, "kind": kind, "shape": name, "b": b, "m": m, "n": n, "c": c,
                   "dtype": str(dt).split(".")[-1], "err_over_gate": over,
                   "bitwise_repeat": all(torch.equal(a, r) for a, r in zip(got, again)),
                   "peak_mib": peak_mib,
                   "device_ms": min(device_ms(torch, fn) for _ in range(3)),
                   "occupancy": {key: val for key, val in
                                 w.attn_core_backward_occupancy(m, n, c, HEADS, dt, 0).items()
                                 if key in ("registers", "spill_bytes", "smem_bytes", "threads",
                                            "blocks_per_sm")}}
            if split:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
                row["split_us"] = {e.key: e.device_time_total / 3 for e in prof.key_averages()
                                   if e.device_time_total > 0}
            print(json.dumps(row), flush=True)
            del got, again, ref
    if steps:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smoke = _load("attn_times_tree_smoke", os.path.join(root, "chip_smoke.py"))
        smoke.phase_build()
        rows = smoke.long_buffer_steps(torch, w.launch_counts)
        for name, r in rows.items():
            print(json.dumps({"tree": label, "steps": name, **{k: r[k] for k in (
                "frames", "keys", "kernel_path_step_ms", "max_memory_allocated_gib", "no_remat_step_ms",
                "no_remat_max_memory_allocated_gib")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
