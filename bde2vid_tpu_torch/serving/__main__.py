"""Serving CLI: export checkpoints to bundles, run bundles on voxels
(counterpart of ``bde2vid_tpu/serving/__main__.py``, with its flags).

    python -m bde2vid_tpu_torch.serving export --weights model.pth \\
        --out model.bundle.zip --hw 180 240 [--T 16] [--platforms cuda|cpu]
    python -m bde2vid_tpu_torch.serving run --bundle model.bundle.zip \\
        {--voxels voxels.npy | --h5 seq.h5} [--out_dir imgs/] [--out_npy imgs.npy]

``export`` takes every checkpoint the port's eval CLI loads: the ``.pth``
dialects (``eval/checkpoint.py``) and the JAX package's ``.msgpack``
(``eval/msgpack_checkpoint.py``); orbax directories are refused. It builds
the model on ``--platforms`` (``cuda``, the default, or ``cpu``: one
platform, the one the bundle runs on) and writes a source-free
``torch.export`` bundle. ``--pallas`` (default on CUDA) exports BDE2VID's
attention blocks as the kernel operators, ``--no-pallas`` the unfused body.
``run`` loads ``voxels.npy`` ((T, H, W, C) or (T, N, H, W, C) floats, the
JAX CLI's layout, transposed here to the port's (T, N, C, H, W)), or
voxelizes an event h5 through the standard pipeline with ``--h5``; pads to
the bundle's exported shape (the eval driver's ``CropParameters``), runs in
``--T`` chunks with the exact tail, crops back and writes PNGs.

``export --batch N --dp D`` writes a data-parallel bundle whose programs take
N / D rows; ``torchrun --nproc_per_node D -m bde2vid_tpu_torch.serving run
...`` serves its (T, N, H, W, C) voxels in D shards, one a rank and card
(gloo CPU ranks for a ``--platforms cpu`` bundle), and rank 0 writes the
outputs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _load_spec(path: str, bf16: bool, pallas, device):
    import torch

    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel

    dtype = torch.bfloat16 if bf16 else torch.float32
    path = path.rstrip(os.sep)  # shell tab-completion appends / to dirs
    if path.endswith(".msgpack") or os.path.isdir(path):
        from bde2vid_tpu_torch.eval.msgpack_checkpoint import load_msgpack_checkpoint

        spec = load_msgpack_checkpoint(path, device=device, dtype=dtype)  # refuses orbax dirs
    else:
        from bde2vid_tpu_torch.eval.checkpoint import load_model_from_torch

        spec = load_model_from_torch(path, device=device, dtype=dtype)
    set_attention_kernel(spec.module, device.type == "cuda" if pallas is None else pallas)
    return spec


def _platforms(arg: str):
    from bde2vid_tpu_torch.serving.export import PLATFORMS

    platforms = tuple(p.strip() for p in arg.split(",") if p.strip())
    if len(platforms) != 1 or platforms[0] not in PLATFORMS:
        raise ValueError(f"--platforms takes one of {PLATFORMS} (the device the bundle runs "
                         f"on), got {arg!r}")
    return platforms


def cmd_export(args) -> int:
    from bde2vid_tpu_torch.serving.export import export_spec_bundle, save_bundle
    from bde2vid_tpu_torch.utils.device import resolve_device
    from bde2vid_tpu_torch.utils.padding import optimal_crop_size

    platforms = _platforms(args.platforms)
    spec = _load_spec(args.weights, args.bf16, args.pallas, resolve_device(platforms[0]))
    h, w = args.hw
    # the raw num_encoders (2^0 = 1: no padding for FireNet-class models);
    # cmd_run recomputes CropParameters with the same value from the meta
    factor = spec.num_encoders
    ph, pw = optimal_crop_size(h, factor), optimal_crop_size(w, factor)
    if (ph, pw) != (h, w):
        print(f"padding exported shape {h}x{w} -> {ph}x{pw} "
              f"(/2^{factor} stride; Croper semantics)")
    bundle = export_spec_bundle(spec, ph, pw, seq_len=args.T, batch=args.batch,
                                platforms=platforms, data_parallel=args.dp)
    # the pre-pad sensor shape, so that `run` can crop outputs back
    bundle.meta["sensor_height"], bundle.meta["sensor_width"] = h, w
    save_bundle(args.out, bundle)
    print(json.dumps({
        "out": args.out, "bytes": os.path.getsize(args.out), "model": spec.name,
        "kind": bundle.meta["kind"], "platforms": list(platforms),
        "exported_hw": [ph, pw], "num_params": spec.num_params,
        "data_parallel": args.dp, "programs": len(bundle.functions),
    }))
    return 0


def serve(bundle, voxels) -> np.ndarray:
    """(T, N, C, h, w) sensor-sized voxels (NumPy or torch) through a loaded
    bundle: padded to its exported shape with the eval driver's
    ``CropParameters``, run in chunks of the exported T (the final partial
    chunk through the tail program of its own length), cropped back.
    Returns (T, N, h, w) f32 images."""
    import torch
    import torch.nn.functional as F

    from bde2vid_tpu_torch.serving.export import run_voxels
    from bde2vid_tpu_torch.utils.padding import CropParameters

    meta = bundle.meta
    voxels = torch.as_tensor(voxels).to(bundle.device, torch.float32)
    t, n, c, h, w = voxels.shape
    if n != meta["batch"]:
        raise SystemExit(f"bundle exported at batch={meta['batch']}, got N={n}")
    if c != meta["num_bins"]:
        raise SystemExit(f"bundle exported for num_bins={meta['num_bins']} voxel "
                         f"channels, got C={c}")
    # the eval driver's pad/crop (ceil on top/left, the reference ZeroPad2d
    # parity), so that serving and eval see the same zero borders
    cp = CropParameters(w, h, meta["num_encoders"])
    ph, pw = meta["height"], meta["width"]
    if (cp.height_crop_size, cp.width_crop_size) != (ph, pw):
        raise SystemExit(
            f"voxels {h}x{w} pad to {cp.height_crop_size}x{cp.width_crop_size} but the "
            f"bundle was exported at {ph}x{pw} (sensor {meta.get('sensor_height')}x"
            f"{meta.get('sensor_width')})")
    voxels = F.pad(voxels, (cp.padding_left, cp.padding_right, cp.padding_top, cp.padding_bottom))
    # a sequence bundle: chunks of the exported length (the eval driver's
    # subseq_L: each chunk starts from fresh state), the final partial chunk
    # at its true length: zero-padding it is not exact for a bidirectional model
    images = run_voxels(bundle, voxels, chunked=True)
    return images[:, :, 0, cp.iy0:cp.iy1, cp.ix0:cp.ix1]


def cmd_run(args) -> int:
    import zipfile

    import torch

    from bde2vid_tpu_torch.parallel.mesh import init_distributed

    with zipfile.ZipFile(args.bundle) as zf:  # the platform, before anything is allocated
        platform = json.loads(zf.read("meta.json"))["platforms"][0]
    owns_group = init_distributed(platform)
    try:
        return _run(args)
    finally:
        if owns_group:
            torch.distributed.destroy_process_group()


def _run(args) -> int:
    from bde2vid_tpu_torch.parallel.mesh import rank
    from bde2vid_tpu_torch.serving.export import load_bundle

    bundle = load_bundle(args.bundle)
    if args.h5:
        # events -> voxels through the eval driver's pipeline (between-frames
        # windows), then into the bundle: a serving path with no model source
        from bde2vid_tpu_torch.data.pipeline import load_sequence

        seq = load_sequence(args.h5, num_bins=bundle.meta["num_bins"],
                            normalize=bundle.meta.get("normalize", False))
        voxels = seq.voxels(device=bundle.device)[:, None]  # (T, 1, C, H, W)
    else:
        voxels = np.load(args.voxels)
        if voxels.ndim == 4:
            voxels = voxels[:, None]
        voxels = np.ascontiguousarray(np.moveaxis(voxels, -1, 2))  # (T, N, H, W, C) -> NCHW
    images = serve(bundle, voxels)
    if rank() != 0:
        return 0  # rank 0 writes the outputs
    t = images.shape[0]
    print(f"ran {t} frames: image range [{images.min():.4f}, {images.max():.4f}]")
    if args.out_npy:
        np.save(args.out_npy, images)
    if args.out_dir:
        from bde2vid_tpu_torch.utils.png import write_png

        os.makedirs(args.out_dir, exist_ok=True)
        for i in range(t):
            img = np.clip(images[i, 0] * 255.0 + 0.5, 0, 255).astype(np.uint8)
            write_png(os.path.join(args.out_dir, f"frame_{i:06d}.png"), img)
        print(f"wrote {t} PNGs to {args.out_dir}")
    return 0


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m bde2vid_tpu_torch.serving")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("export", help="checkpoint -> bundle zip")
    pe.add_argument("--weights", required=True,
                    help="checkpoint: .pth (the eval CLI's torch dialects) or .msgpack")
    pe.add_argument("--out", required=True, help="output bundle zip path")
    pe.add_argument("--hw", nargs=2, type=int, required=True, metavar=("H", "W"),
                    help="sensor shape (padded to stride)")
    pe.add_argument("--T", type=int, default=16, help="sequence length for sequence models")
    pe.add_argument("--batch", type=int, default=1)
    pe.add_argument("--platforms", default="cuda",
                    help="cuda (default) or cpu: the device the bundle is exported on and runs on")
    pe.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks: the programs take --batch / D rows, and `run` "
                    "serves under torchrun --nproc_per_node D (at least D ranks)")
    pe.add_argument("--bf16", action="store_true")
    pe.add_argument("--pallas", action=argparse.BooleanOptionalAction, default=None,
                    help="BDE2VID's attention blocks as the hand-written CUDA kernels' "
                    "operators (default: on for cuda, off for the cpu)")
    pe.set_defaults(fn=cmd_export)

    pr = sub.add_parser("run", help="run a bundle over voxels.npy or an event h5")
    pr.add_argument("--bundle", required=True)
    src = pr.add_mutually_exclusive_group(required=True)
    src.add_argument("--voxels", default=None, help=".npy of (T, H, W, C) float voxels")
    src.add_argument("--h5", default=None,
                     help="canonical event h5: voxelized through the eval driver's pipeline, "
                     "then served")
    pr.add_argument("--out_dir", default=None, help="write per-frame PNGs")
    pr.add_argument("--out_npy", default=None, help="write the (T, N, H, W) f32 images")
    pr.set_defaults(fn=cmd_run)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
