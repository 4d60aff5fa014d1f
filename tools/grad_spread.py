#!/usr/bin/env python3
"""Measure how far two runs of one flagship train step's gradients lie apart
on one NVIDIA GPU, with and without deterministic algorithms.

    python3 tools/grad_spread.py [--hw H W] [--t T] [--runs R] [--device cpu]

The flagship BDE2VID (base 32, depths [4, 0, 6], 16 heads, 7x7 windows,
DropPath 0) in training mode takes seeded voxels of T frames at H x W (96 x
128, T 3 by default) and an L1 loss against seeded targets. For each mode
("default", then "deterministic": ``torch.use_deterministic_algorithms(True,
warn_only=True)`` with ``torch.backends.cudnn.deterministic``; the ops that
warned for want of a deterministic version are listed as ``alerts``) and each path (the unfused
PyTorch attention, then the hand-written kernels), the step runs R times
from the same weights. One JSON line a mode and path gives the largest
relative gap between two runs over every parameter's gradient (max |a - b|
over max |b|), the parameter it is at, the gap of
``generator.head.conv2d.weight``'s gradient (absolute and relative), and
whether the runs are bit-equal; then per mode the kernel path against the
unfused path the same way, and the unfused path against itself on voxels
moved by ~1e-7 relative (seeded noise), each with the largest gap of the
output images. The card's name and power limit come
first. ``--device cpu`` runs the same on the CPU, where the kernel path is
the kernels' plain twins (and a run repeats bit for bit). cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG`` for deterministic GEMMs: it
is set here before torch starts.
"""

import argparse
import json
import os
import subprocess
import sys
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HEAD = "generator.head.conv2d.weight"


def gaps(a, b):
    """(largest relative gap and its key, head gap abs, head gap rel, bit-equal)."""
    worst, where, equal = 0.0, None, True
    for k, gb in b.items():
        d = (a[k] - gb).abs().max().item()
        equal = equal and d == 0.0
        rel = d / max(gb.abs().max().item(), 1e-30)
        if rel > worst:
            worst, where = rel, k
    head = (a[HEAD] - b[HEAD]).abs().max().item()
    return {"max_rel_gap": worst, "at": where, "head_abs_gap": head,
            "head_rel_gap": head / max(b[HEAD].abs().max().item(), 1e-30),
            "head_grad_max": b[HEAD].abs().max().item(), "bit_equal": equal}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--hw", type=int, nargs=2, default=[96, 128])
    p.add_argument("--t", type=int, default=3)
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch

    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
    from bde2vid_tpu_torch.train import SequenceLossComputer

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("grad_spread: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True
                             ).stdout.strip(), flush=True)
    gen = {"num_bins": 5, "basechannels": 32, "num_encoders": 3, "ks": 5, "num_res_blocks": 2,
           "buffer_index": [-3, -2, -1, 0, 1, 2, 3], "depths": [4, 0, 6], "num_heads": 16,
           "window_size": [7, 7], "drop_path_rate": 0.0}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = build_model("BDE2VID", {"generator": gen, "use_pallas_attention": True},
                            device=args.device, train=True)
    comp = SequenceLossComputer([{"type": "L1Loss"}])
    rng = np.random.default_rng(8)
    h, w = args.hw
    vox = torch.from_numpy(rng.normal(size=(args.t, 1, 5, h, w)).astype(np.float32)).to(args.device)
    tgt = torch.from_numpy(rng.uniform(size=(args.t, 1, 1, h, w)).astype(np.float32)).to(args.device)

    def step(kernel):
        set_attention_kernel(model, kernel)
        model.zero_grad(set_to_none=True)
        image = model(vox)["image"]
        loss, _ = comp(image, tgt)
        loss.backward()
        if cuda:
            torch.cuda.synchronize()
        return loss.item(), {k: q.grad.clone() for k, q in model.named_parameters()
                             if q.grad is not None}, image.detach()

    def image_gap(a, b):
        return {"image_max_abs_gap": (a[2] - b[2]).abs().max().item()}

    for mode in ("default", "deterministic"):
        det = mode == "deterministic"
        torch.use_deterministic_algorithms(det, warn_only=True)
        torch.backends.cudnn.deterministic = det
        last = {}
        for kernel in (False, True):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                runs = [step(kernel) for _ in range(args.runs)]
            alerts = sorted({str(m.message).strip().splitlines()[0][:200] for m in caught
                             if "determinis" in str(m.message)})
            row = {"mode": mode, "path": "kernel" if kernel else "unfused", "hw": [h, w],
                   "T": args.t, "losses": [r[0] for r in runs], "alerts": alerts}
            pairs = [gaps(a[1], b[1]) for i, a in enumerate(runs) for b in runs[i + 1:]]
            if pairs:
                row.update(max(pairs, key=lambda g: g["max_rel_gap"]))
            print(json.dumps(row), flush=True)
            last[kernel] = runs[0]
        print(json.dumps({"mode": mode, "path": "kernel vs unfused", "hw": [h, w], "T": args.t,
                          **gaps(last[True][1], last[False][1]),
                          **image_gap(last[True], last[False])}), flush=True)
        # the unfused path on voxels moved by ~1e-7 relative: how far a
        # rounding-level change of the inputs moves the gradients
        clean = vox
        vox = clean * (1 + 1e-7 * torch.from_numpy(
            np.random.default_rng(9).standard_normal(clean.shape).astype(np.float32)).to(clean.device))
        moved = step(False)
        print(json.dumps({"mode": mode, "path": "unfused vs unfused on voxels x (1 + 1e-7 noise)",
                          "hw": [h, w], "T": args.t, **gaps(moved[1], last[False][1]),
                          **image_gap(moved, last[False])}), flush=True)
        vox = clean
    return 0


if __name__ == "__main__":
    sys.exit(main())
