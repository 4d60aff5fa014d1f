"""Evaluation CLI of the port (counterpart of ``bde2vid_tpu/eval/__main__.py``,
the subset the BDE2VID, E2VID-family, SPADE, EITR and SNN eval paths need).

    python -m bde2vid_tpu_torch.eval --weights_dir W --data_dir D \\
        --datasets HQF --loader_type MMP --metrics mse ssim --subseq_L 8

Scores every ``*.pth`` under ``--weights_dir``: BDE2VID, E2VID,
E2VIDRecurrent, FireNet, FireNetOrg, FlowNet and EITR checkpoints in the
mmengine, pytorch-template and ``firenet_1000.pth`` dialects, and bare
SPADE state dicts (a file name with "SPADE"; on an H5 tree SPADE reads
``SpadeH5``, the event-rate-split windows). Runs on CUDA unless
``--device cpu``; ``--pallas`` (default on CUDA) runs BDE2VID's attention
blocks through the hand-written kernel, ``--no-pallas`` through the unfused
PyTorch body (the step models have no window attention, and ignore both).
``--normalize`` LegacyNorms the voxels; a template checkpoint whose model
arguments stand under ``model`` asks for it too. Bare EVSNN and PAEVSNN
state dicts (a path with "SNN"; "PAEVSNN" picks the latter) are scored
robust-normalised, by the loaded model's family.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from glob import glob


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="evaluate reconstruction checkpoints on event datasets")
    p.add_argument("--weights_dir", default="weights/", type=str)
    p.add_argument("--data_dir", default="data/eval/", type=str)
    p.add_argument("--st", default=0, type=int)
    p.add_argument("--ed", default=-1, type=int)
    p.add_argument("--datatype", default="org")
    p.add_argument("--datasets", nargs="*", default=["HQF/", "ECD/", "MVSEC/"])
    p.add_argument("--metrics", nargs="*", default=["mse", "ssim"], choices=["mse", "ssim", "psnr"])
    p.add_argument("--subseq_L", default=1000, type=int)
    p.add_argument("--max_length", default=111200, type=int)
    p.add_argument("--loader_type", default="H5", choices=["H5", "SpadeH5", "MMP"])
    p.add_argument("--normalize", action="store_true",
                   help="LegacyNorm each window's voxels (zero mean, unit std over nonzeros)")
    p.add_argument("--output_dir", default=None, type=str,
                   help="where result files go (default: weights_dir)")
    p.add_argument("--bf16", action="store_true", help="run the model in bfloat16")
    p.add_argument("--pallas", action=argparse.BooleanOptionalAction, default=None,
                   help="BDE2VID's attention blocks through the hand-written CUDA kernel "
                   "(default: on for CUDA, off for the CPU)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def read_checkpoints(weights_dir: str, st: int, ed: int):
    """Glob + sort checkpoints by epoch number (reference read_cps :346-360)."""
    files = glob(os.path.join(weights_dir, "*.pth"))

    def parse_num(x):
        name = os.path.basename(x)
        if "epoch_" in name:
            m = re.search(r"\d+", name.split("epoch_")[-1])
            if m:
                return (0, int(m[0]), name)
        return (1, 0, name)

    files.sort(key=parse_num)
    if st > 0 or ed > -1:
        files = files[st if st > 0 else 0 : ed if ed > -1 else len(files)]
    return files


def read_datafiles(data_dir: str, datasets, loader_type: str = "H5"):
    """Sequences under ``data_dir/h5`` (H5, SpadeH5) or ``data_dir/mmp``
    (MMP), from ``eval_data.txt`` when present, filtered by dataset name."""
    h5 = loader_type in ("H5", "SpadeH5")
    root = os.path.join(data_dir, "h5" if h5 else "mmp")
    listing = os.path.join(root, "eval_data.txt")
    if os.path.exists(listing):
        with open(listing) as f:
            files = [l for l in f.read().split("\n") if l]
    elif h5:
        files = sorted(os.path.relpath(p, root)
                       for p in glob(os.path.join(root, "**", "*.h5"), recursive=True))
    else:
        files = sorted(
            os.path.relpath(os.path.dirname(p), root)
            for p in glob(os.path.join(root, "**", "t.npy"), recursive=True)
        )
    return [f for f in files if any(d in f for d in datasets)], root


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch

    from bde2vid_tpu_torch.eval.checkpoint import load_model_from_torch
    from bde2vid_tpu_torch.eval.driver import EvalConfig, evaluate_all
    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
    from bde2vid_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    use_kernel = device.type == "cuda" if args.pallas is None else args.pallas

    datafiles, data_root = read_datafiles(args.data_dir, args.datasets, args.loader_type)
    if not datafiles:
        print(f"no datafiles found under {args.data_dir}")
        return 1
    checkpoints = read_checkpoints(args.weights_dir, args.st, args.ed)
    if not checkpoints:
        print(f"no checkpoints found under {args.weights_dir}")
        return 1

    out_dir = args.output_dir or args.weights_dir
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    for ckpt in checkpoints:
        name = os.path.split(ckpt)[-1].split(".")[0]
        if args.subseq_L:
            result_file = f"{name}_L{args.subseq_L}_{args.datatype}.txt"
        else:
            result_file = f"{name}_{args.datatype}.txt"
        result_file = os.path.join(out_dir, result_file)
        if os.path.exists(result_file):
            print(f"skipping {ckpt} (result exists)")
            continue
        print(f"loading {ckpt} ...")
        spec = load_model_from_torch(ckpt, device=device, dtype=dtype)
        set_attention_kernel(spec.module, use_kernel)
        print(f"{spec.name}: {spec.num_params / 1e6:.2f}M parameters on {device}")
        cfg = EvalConfig(
            ltype=args.loader_type,
            num_bins=spec.num_bins,
            subseq_L=args.subseq_L or None,
            max_length=args.max_length,
            normalize=args.normalize or spec.normalize,
            metrics=tuple(args.metrics),
            # by the loaded family, not only the file name: a lowercase
            # evsnn_e10.pth is an SNN too
            robust_norm_output=spec.name in ("EVSNN", "PAEVSNN") or "SNN" in name,
        )
        evaluate_all(spec, datafiles, data_root, result_file, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
