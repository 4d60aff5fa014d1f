"""Evaluation CLI of the port (counterpart of ``bde2vid_tpu/eval/__main__.py``,
the subset the BDE2VID, E2VID-family, SPADE, EITR and SNN eval paths need).

    python -m bde2vid_tpu_torch.eval --weights_dir W --data_dir D \\
        --datasets HQF --loader_type MMP --subseq_L 8 \\
        [--metrics p_loss mse ssim] [--lpips_lin LIN.pth --lpips_backbone ALEX.pth]

Scores every ``*.pth`` and ``*.msgpack`` under ``--weights_dir``, in
numeric ``epoch_`` order. A ``.msgpack`` is a checkpoint of the JAX
package's train CLI (flax bytes and a ``.json`` sidecar), read without flax
(``eval/msgpack_checkpoint.py``). The ``.pth`` dialects: BDE2VID, E2VID,
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

The JAX CLI's experiment and output flags: ``--pause_st/--pause_ed`` (the
pause experiment; the result file is ``{name}_{datatype}_{st}_{ed}.txt`` and
the sequence runs in one chunk), ``--eq`` (histogram-equalised scoring),
``--filter_hot_events`` (the 100 hottest pixels masked),
``--separate_polarity`` (2B-channel voxels, positive bins first, for a model
that takes them), ``--saveim DIR`` (triptych PNGs), ``--show`` and
``--wait_time`` (a live viewer where cv2 and a display exist).

``--loader_type``: H5, SpadeH5 and H5VOX (the voxel cache that
``events.tools.h5_precompute_voxels`` writes into an h5 file) read
``<data_dir>/h5`` and need ``h5py``; MMP reads memmap directories under
``<data_dir>/mmp``; ENPY (the raw-NPY event layout) and NPY (the
pre-voxelized tree of ``events.tools.h5_to_prevoxelized_npy``) read
directories under ``<data_dir>/npy``.

``--metrics`` defaults to the paper's ``p_loss mse ssim``. ``p_loss`` is
LPIPS (net-lin, AlexNet, v0.1): the lin heads come from ``--lpips_lin`` or,
without it, from discovery (``$BDE2VID_LPIPS_LIN``, ``weights/lpips/alex.pth``),
the torchvision backbone from ``--lpips_backbone``. Without lin weights
``p_loss`` is dropped with a warning; without a backbone it is scored with
a random one, with a warning on stderr.
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
    p.add_argument("--metrics", nargs="*", default=["p_loss", "mse", "ssim"],
                   choices=["p_loss", "mse", "ssim", "psnr"])
    p.add_argument("--subseq_L", default=1000, type=int)
    p.add_argument("--max_length", default=111200, type=int)
    p.add_argument("--pause_st", default=None, type=int)
    p.add_argument("--pause_ed", default=None, type=int)
    p.add_argument("--loader_type", default="H5",
                   choices=["H5", "SpadeH5", "MMP", "NPY", "ENPY", "H5VOX"],
                   help="dataset backend; H5VOX reads the in-h5 voxel cache written by "
                   "h5_precompute_voxels")
    p.add_argument("--separate_polarity", action="store_true",
                   help="2B-channel pos/neg voxel grids instead of combined")
    p.add_argument("--filter_hot_events", action="store_true")
    p.add_argument("--normalize", action="store_true",
                   help="LegacyNorm each window's voxels (zero mean, unit std over nonzeros)")
    p.add_argument("--eq", action="store_true")
    p.add_argument("--saveim", default=None, type=str, help="folder to dump triptych PNGs")
    p.add_argument("--show", action="store_true", help="live [events|pred|gt] cv2 window; ESC quits")
    p.add_argument("--wait_time", default=1, type=int, help="cv2.waitKey ms per frame for --show")
    p.add_argument("--output_dir", default=None, type=str,
                   help="where result files go (default: weights_dir)")
    p.add_argument("--bf16", action="store_true", help="run the model in bfloat16")
    p.add_argument("--pallas", action=argparse.BooleanOptionalAction, default=None,
                   help="BDE2VID's attention blocks through the hand-written CUDA kernel "
                   "(default: on for CUDA, off for the CPU)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lpips_lin", default=None, type=str,
                   help="torch .pth with the LPIPS lin heads (v0.1 alex layout); discovered "
                   "($BDE2VID_LPIPS_LIN, weights/lpips/alex.pth) when omitted")
    p.add_argument("--lpips_backbone", default=None, type=str,
                   help="torchvision alexnet state dict (features.*); without it p_loss uses a "
                   "random backbone")
    return p


def load_lpips_metric(metrics, lpips_lin, lpips_backbone, device):
    """(metrics, LPIPS network or None) for the eval run: the lin heads from
    ``lpips_lin`` or discovery, the backbone from ``lpips_backbone`` (random,
    with a warning on stderr, when absent); ``p_loss`` dropped with a warning
    when there are no lin weights."""
    from bde2vid_tpu_torch.eval.checkpoint import load_torch_file
    from bde2vid_tpu_torch.metrics.lpips import find_default_lpips_lin, load_lpips_state

    if lpips_lin is None and "p_loss" in metrics:
        lpips_lin = find_default_lpips_lin()
        if lpips_lin:
            print(f"lpips: using discovered lin weights {lpips_lin}")
    net = None
    if lpips_lin:
        backbone = load_torch_file(lpips_backbone) if lpips_backbone else None
        if backbone is None:
            # the other metrics stay valid, so eval warns where training refuses
            print("WARNING: p_loss will use a RANDOM LPIPS backbone — pass --lpips_backbone "
                  "(torchvision alexnet weights) for real perceptual scores", file=sys.stderr)
        net = load_lpips_state(load_torch_file(lpips_lin), backbone, device=device)
    metrics = tuple(metrics)
    if "p_loss" in metrics and net is None:
        print("warning: dropping p_loss (no --lpips_lin provided)")
        metrics = tuple(m for m in metrics if m != "p_loss")
    return metrics, net


def read_checkpoints(weights_dir: str, st: int, ed: int):
    """``*.pth`` and ``*.msgpack`` under ``weights_dir``, sorted by epoch
number (reference read_cps :346-360)."""
    files = glob(os.path.join(weights_dir, "*.pth")) + glob(os.path.join(weights_dir, "*.msgpack"))

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


def result_names(checkpoints):
    """{checkpoint: the stem of its result files}: the file name up to its
    first dot, as the reference names them; where two checkpoints share a
    stem (``epoch_1.pth`` beside ``epoch_1.msgpack``) each keeps its
    extension, ``epoch_1_pth`` and ``epoch_1_msgpack``, so neither result
    is skipped as already written."""
    stems = {c: os.path.basename(c).split(".")[0] for c in checkpoints}
    shared = {s for s in stems.values() if list(stems.values()).count(s) > 1}
    return {c: f"{s}_{os.path.splitext(c)[1][1:]}" if s in shared else s
            for c, s in stems.items()}


def read_datafiles(data_dir: str, datasets, loader_type: str = "H5"):
    """Sequences under ``data_dir/h5`` (H5, SpadeH5, H5VOX), ``data_dir/npy``
    (NPY, ENPY) or ``data_dir/mmp`` (MMP), from ``eval_data.txt`` when
    present, filtered by dataset name. Without a listing an h5 backend takes
    every ``*.h5`` below, a directory backend every directory holding a
    ``t.npy``, else every ``<dataset>/<sequence>`` directory."""
    h5 = loader_type in ("H5", "SpadeH5", "H5VOX")
    root = os.path.join(data_dir, "h5" if h5 else "npy" if loader_type in ("NPY", "ENPY") else "mmp")
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
        ) or sorted(os.path.relpath(d, root) for d in glob(os.path.join(root, "*", "*"))
                    if os.path.isdir(d))
    return [f for f in files if any(d in f for d in datasets)], root


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch

    from bde2vid_tpu_torch.eval.checkpoint import load_model_from_torch
    from bde2vid_tpu_torch.eval.driver import EvalConfig, evaluate_all
    from bde2vid_tpu_torch.eval.msgpack_checkpoint import load_msgpack_checkpoint
    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
    from bde2vid_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    use_kernel = device.type == "cuda" if args.pallas is None else args.pallas
    metrics, lpips = load_lpips_metric(args.metrics, args.lpips_lin, args.lpips_backbone, device)

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
    names = result_names(checkpoints)
    for ckpt in checkpoints:
        name = names[ckpt]
        subseq = args.subseq_L or None
        if args.pause_st is not None:
            result_file = f"{name}_{args.datatype}_{args.pause_st}_{args.pause_ed}.txt"
            subseq = None
        elif args.subseq_L:
            result_file = f"{name}_L{args.subseq_L}_{args.datatype}.txt"
        else:
            result_file = f"{name}_{args.datatype}.txt"
        result_file = os.path.join(out_dir, result_file)
        if os.path.exists(result_file):
            print(f"skipping {ckpt} (result exists)")
            continue
        print(f"loading {ckpt} ...")
        load = load_msgpack_checkpoint if ckpt.endswith(".msgpack") else load_model_from_torch
        spec = load(ckpt, device=device, dtype=dtype)
        set_attention_kernel(spec.module, use_kernel)
        print(f"{spec.name}: {spec.num_params / 1e6:.2f}M parameters on {device}")
        cfg = EvalConfig(
            ltype=args.loader_type,
            num_bins=spec.num_bins,
            combined_voxel_channels=not args.separate_polarity,
            subseq_L=subseq,
            max_length=args.max_length,
            pause_st=args.pause_st,
            pause_ed=args.pause_ed,
            filter_hot_events=args.filter_hot_events,
            normalize=args.normalize or spec.normalize,
            eq=args.eq,
            metrics=metrics,
            lpips=lpips,
            # by the loaded family, not only the file name: a lowercase
            # evsnn_e10.pth is an SNN too
            robust_norm_output=spec.name in ("EVSNN", "PAEVSNN") or "SNN" in name,
            save_images_to=args.saveim,
            show=args.show,
            wait_time=args.wait_time,
        )
        evaluate_all(spec, datafiles, data_root, result_file, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
