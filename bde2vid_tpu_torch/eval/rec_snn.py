"""The standalone SNN reconstruction CLI (counterpart of
``bde2vid_tpu/eval/rec_snn.py``; reference model/EVSNN/rec_snn.py:19-102).

    python -m bde2vid_tpu_torch.eval.rec_snn -network EVSNN \\
        -path_to_pretrain_models EVSNN.pth -path_to_event_files events.txt \\
        -save_path results -height 180 -width 240 -num_events_per_pixel 0.5

Reads a ``t x y pol`` text event stream after a 10-line header in chunks of
``int(height * width * num_events_per_pixel)`` events (a short last chunk is
dropped), turns each chunk into a 5-bin voxel grid (timestamps rebased to the
chunk's first event in f64, then cast to f32), pads it to a multiple of 8,
normalises the whole tensor once (the unbiased std over its nonzero
entries), feeds the bins one at a time through the spiking network with its
membranes carried across chunks, and writes one robust-normalised PNG per
bin, ``<save_path>/<network>/result-idx{chunk:04d}{bin:04d}.png``. Runs on
CUDA unless ``--device cpu``. The weights are a reference ``.pth`` (bare,
or under ``"model"``) or a ``.msgpack`` of the JAX package's train CLI,
whose sidecar config builds the network.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

NUM_BINS = 5
HEADER_LINES = 10


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="reconstruct frames from a text event stream with an SNN")
    p.add_argument("-network", type=str, default="EVSNN", choices=["EVSNN", "PAEVSNN"])
    p.add_argument("-path_to_pretrain_models", type=str, required=True)
    p.add_argument("-path_to_event_files", type=str, required=True)
    p.add_argument("-save_path", type=str, default="./results")
    p.add_argument("-height", type=int, default=180)
    p.add_argument("-width", type=int, default=240)
    p.add_argument("-num_events_per_pixel", type=float, default=0.5)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def read_chunks(path: str, n_chunk: int):
    """Chunks of ``n_chunk`` (t, x, y, p) rows, f64, of a text stream whose
    first ``HEADER_LINES`` lines are skipped; lines without four fields are
    ignored."""
    buf = []
    with open(path) as fp:
        for _ in range(HEADER_LINES):
            fp.readline()
        for line in fp:
            parts = line.split()
            if len(parts) != 4:
                continue
            buf.append(parts)
            if len(buf) == n_chunk:
                yield np.asarray(buf, np.float64)
                buf = []


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    import torch

    from bde2vid_tpu_torch.eval.checkpoint import load_model_from_torch
    from bde2vid_tpu_torch.eval.msgpack_checkpoint import load_msgpack_checkpoint
    from bde2vid_tpu_torch.events.voxel import events_to_voxel
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.utils.device import resolve_device
    from bde2vid_tpu_torch.utils.norm import legacy_norm, robust_norm, to_uint8_image
    from bde2vid_tpu_torch.utils.padding import CropParameters
    from bde2vid_tpu_torch.utils.png import write_gray_png

    device = resolve_device(args.device)
    h, w = args.height, args.width
    n_chunk = int(h * w * args.num_events_per_pixel)
    crop = CropParameters(w, h, 3)

    path = args.path_to_pretrain_models
    # a .pth's dialect is picked by "SNN" in its path, as the reference does;
    # a .msgpack's sidecar config builds the network
    load = load_msgpack_checkpoint if path.endswith(".msgpack") else load_model_from_torch
    spec = load(path, device=device)
    if spec.name != args.network:
        raise SystemExit(f"checkpoint is a {spec.name} model but -network says {args.network}; "
                         "pass the matching network name")
    # the CLI normalises the whole voxel itself and feeds one bin a call
    model = build_model(args.network, {**spec.module.config, "normalize_input": False},
                        device=device)
    model.load_state_dict(spec.module.state_dict())

    savepath = os.path.join(args.save_path, args.network)
    os.makedirs(savepath, exist_ok=True)
    state = model.initial_state(1, crop.height_crop_size, crop.width_crop_size)
    for i, arr in enumerate(read_chunks(args.path_to_event_files, n_chunk)):
        # rebase in f64 before the f32 cast: epoch-scale stamps (~1.6e9 s)
        # keep ~128 s of f32 resolution, which would collapse the bins
        ts = torch.from_numpy((arr[:, 0] - arr[:, 0][0]).astype(np.float32))
        xs = torch.from_numpy(arr[:, 1].astype(np.int32))
        ys = torch.from_numpy(arr[:, 2].astype(np.int32))
        ps = torch.from_numpy(np.where(arr[:, 3] > 0, 1.0, -1.0).astype(np.float32))
        voxel = events_to_voxel(*(t.to(device) for t in (xs, ys, ts, ps)), len(arr),
                                num_bins=NUM_BINS, sensor_size=(h, w))
        voxel = legacy_norm(crop.pad(voxel[None]), unbiased=True)
        with torch.no_grad():
            for j in range(NUM_BINS):
                out, state = model(voxel[:, j:j + 1], state)
                img = robust_norm(crop.crop(out["image"])[0, 0].float(), 1, 99)
                write_gray_png(os.path.join(savepath, f"result-idx{i:04d}{j:04d}.png"),
                               to_uint8_image(img))
        print(f"\rProcessing: {i * NUM_BINS}.", end="", flush=True)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
