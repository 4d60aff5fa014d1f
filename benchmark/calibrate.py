#!/usr/bin/env python3
"""Readings that set the limits of a cell's compared numbers
(``limits/<cell>.json``), in one process:

- the program's numbers over ``--seeds``: the timed path at the cell's
  sizes, judged by the reference as a run judges it (the lower readings);
- over ``--control-seeds``: the control, the reference put in the program's
  place and computed in TF32, the precision below the cell's f32 with TF32
  off, and each fault of ``--faults`` planted in it (the upper readings).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 \\
        [--faults half_batch,grad_altered]

One JSON line per seed and variant, then the largest lower and the least
upper reading of each number. Needs the card; the benchmark's runs never
run it.
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    harness.ensure_importable()
    cell = harness.Cell(args.workload)
    harness.require_cards(cell.chips)
    import torch

    harness.set_precision()
    device = torch.device("cuda", 0)
    entry = cell.entry()
    seeds = [int(x) for x in args.seeds.split(",") if x]
    controls = [int(x) for x in args.control_seeds.split(",") if x]
    faults = ["tf32"] + [f for f in args.faults.split(",") if f]
    lower, upper = {}, {}
    for seed in dict.fromkeys(seeds + controls):
        variants = ([""] if seed in seeds else []) + (faults if seed in controls else [])
        t0 = time.perf_counter()
        for variant, numbers in entry.calibration(cell, seed, device, variants).items():
            print(json.dumps({"seed": seed, "variant": variant or "program", **numbers}), flush=True)
            for n, v in numbers.items():
                if variant:
                    upper.setdefault(variant, {})[n] = min(upper.get(variant, {}).get(n, math.inf), v)
                else:
                    lower[n] = max(lower.get(n, 0.0), v)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"workload": cell.name, "lower": lower, "upper": upper}), flush=True)
    harness.check_no_jax()
    return 0


if __name__ == "__main__":
    sys.exit(main())
