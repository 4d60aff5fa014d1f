#!/usr/bin/env python3
"""Time the port's forward attention above head_dim 256 of one source tree on
one NVIDIA GPU: the bare core (``fused_window_attention``) and the Swin
block's and the WindowAttention3D body's whole blocks (with acc), one head.

    python3 tools/attn_fwd_times.py ROOT LABEL [--head_dims HD ...] [--build_only]

ROOT is a checkout of this repository (an older commit unpacked with ``git
archive`` under ``build/`` compares against it: run parent, change, change,
parent in one session on one card). The tree's three forward libraries are
built into its own ``build/kernels`` (``--build_only``: build and stop, so
that several trees build side by side before any is timed). Each (kernel,
head_dim, dtype) prints one JSON line: device ms a call
(``chip_smoke.device_ms`` of this script's tree, best of three), the
largest error over the kernel-vs-twin gate (f32 1e-4 x max(1, max|twin|),
bf16 2e-2 x max|twin|), whether two runs are bit-identical, the launch
counter that counted the calls and, for the bare core, torch's SDPA
forward on the same inputs (``chip_smoke.sdpa_forward_ms``: CUDA-event ms,
backend, device ms). Shapes: the flagship's level-2 windows over 7 frames
(B_ 20, M 49, N 343), one head, at head_dim 384, 512, 1024 and 2048 unless
``--head_dims`` names others (a tree whose plans refuse a head_dim prints
``"refused"`` for it).
"""

import importlib.util
import json
import os
import sys
import time

HEAD_DIMS = (384, 512, 1024, 2048)
B, M, FRAMES = 20, 49, 7


def _smoke():
    """This script's tree's chip_smoke.py (device_ms, block_params)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("attn_times_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def over_gate(torch, got, ref, dt):
    worst = 0.0
    for a, r in zip(got, ref):
        top = r.float().abs().max().item()
        tol = 1e-4 * max(1.0, top) if dt == torch.float32 else 2e-2 * top
        worst = max(worst, (a.float() - r.float()).abs().max().item() / tol)
    return worst


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("root")
    parser.add_argument("label")
    parser.add_argument("--head_dims", type=int, nargs="+", default=list(HEAD_DIMS))
    parser.add_argument("--build_only", action="store_true")
    args = parser.parse_args()
    root, label = os.path.abspath(args.root), args.label
    smoke = _smoke()
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("attn_fwd_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bde2vid_tpu_torch.ops import build
    from bde2vid_tpu_torch.ops import window_attn_cuda as w

    t0 = time.perf_counter()
    build.build(["window_attention", "swin_block", "window_block"])
    print(json.dumps({"tree": label, "root": root, "build_s": time.perf_counter() - t0}), flush=True)
    if args.build_only:
        return 0
    gen = torch.Generator(device="cuda").manual_seed(384)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    n = FRAMES * M
    for hd in args.head_dims:
        q32, k32, v32, bias = rnd(B, M, hd), rnd(B, n, hd), rnd(B, n, hd), rnd(1, M, n, scale=0.5)
        p32 = smoke.block_params(rnd, hd, 1, M, n)
        x32, c32 = rnd(FRAMES, B, M, hd), rnd(B, M, hd)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[-1]
            q, k, v = (t.to(dt) for t in (q32, k32, v32))
            x, ctr, p = x32.to(dt), c32.to(dt), smoke.operand_weights(p32, dt)
            pw = w.WindowBlockParams(*p[:10], p.bias)
            for kernel, fn, twin in (
                    ("window_attention", lambda: (w.fused_window_attention(q, k, v, bias, 1),),
                     lambda: (w.window_attention_reference(q, k, v, bias, 1),)),
                    ("swin_block", lambda: w.fused_swin_block(x, ctr, p, 1, FRAMES // 2, with_acc=True),
                     lambda: w.swin_block_reference(x, ctr, p, 1, FRAMES // 2, with_acc=True)),
                    ("window_block", lambda: w.fused_window_block(x, pw, 1, FRAMES // 2, with_acc=True),
                     lambda: w.window_block_reference(x, pw, 1, FRAMES // 2, with_acc=True))):
                row = {"tree": label, "kernel": kernel, "head_dim": hd, "dtype": name}
                with torch.no_grad():
                    before = dict(w.launch_counts)
                    try:
                        got, again = fn(), fn()
                    except ValueError as err:
                        print(json.dumps({**row, "refused": str(err)}), flush=True)
                        continue
                    ref = twin()
                    torch.cuda.synchronize()
                    row.update(err_over_gate=over_gate(torch, got, ref, dt),
                               bitwise_repeat=all(torch.equal(a, b) for a, b in zip(got, again)),
                               counted=[k for k, v in w.launch_counts.items() if v != before.get(k, 0)],
                               device_ms=min(smoke.device_ms(torch, fn) for _ in range(3)))
                    if kernel == "window_attention":
                        row["sdpa"] = smoke.sdpa_forward_ms(torch, q, k, v, bias, 1)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
