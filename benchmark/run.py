#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``bde2vid_tpu_torch``).
Set-up, then a measured window of ``--seconds``, then the check of the
window's outputs against the plain reference. ``--trace 0`` prints the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
profiled stretch after the window. The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, ``setup``: whether the run
compiled, so that its ``setup_s`` holds the build, and the seconds spent
writing the recording, which ``setup_s`` leaves out, and last ``checks``:
each compared number beside its limit). Without enough CUDA cards, or with a
JAX module loaded, the run exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.ensure_importable()
    cell = harness.Cell(args.workload)
    harness.require_cards(cell.chips)
    import torch

    harness.set_precision()
    built = harness.built_files()
    result = cell.entry().run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                              T_START)
    harness.check_no_jax()
    harness.emit({"correct": result["correct"], "attempted": result["attempted"],
                  "failed": result["failed"], "metrics": result["metrics"], "device": result["device"],
                  **({"breakdown": result["breakdown"]} if "breakdown" in result else {}),
                  "setup": {"compiled": harness.built_files() > built, **result["setup"]},
                  "checks": result["checks"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
