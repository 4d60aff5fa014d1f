"""Training CLI of the port (counterpart of ``bde2vid_tpu/train/__main__.py``).

    python -m bde2vid_tpu_torch.train --config cfg.json --data_dir D \\
        [--steps N] [--out_dir O] [--batch B] [--loader_type {H5,MMP}] [--device cpu] \\
        [--resume epoch_K.state | W.pth | W.msgpack] [--save_state] [--prefetch P] \\
        [--val_dir V --val_every E [--val_windows W]] \\
        [--lpips_lin LIN.pth --lpips_backbone ALEX.pth]

The json config has the JAX CLI's schema:

    {"name": ..., "model": {"type": "BDE2VID", "args": {...}},
     "losses": [{"type": "L1Loss"}, ...], "loss_inds": null,
     "optimizer": {"type": "Adam", "args": {"lr": 1e-4, "grad_clip": 1.0}},
     "lr_scheduler": {"type": "StepLR", "args": {...}},
     "data": {"sequence_length": 8, "num_bins": 5, "crop_size": 112,
              "proba_pause_when_running": 0.05, "proba_pause_when_paused": 0.9,
              "noise_std": 0.1, "noise_fraction": 0.05,
              "hot_pixel_std": 2.0, "max_hot_pixel_fraction": 0.001,
              "transforms": {"RandomRotationFlip": {...}, "RandomCrop": {"size": 112}}},
     "train": {"steps": 1000, "ckpt_every": 200, "bf16": false, "remat": false}}

Every registered family trains: BDE2VID takes each window in one call; the
step models (E2VID, E2VIDRecurrent, FireNet, FireNetOrg, FlowNet,
SPADEE2VID, EITR, EVSNN, PAEVSNN) run over it from their initial state.

Training windows come from every sequence under ``--data_dir``: ``**/*.h5``
files (``--loader_type H5``, the default and the JAX CLI's only discovery)
or memmap directories (``MMP``). The window stream of step k is a pure
function of (seed, k): each step draws from a fresh numpy
``default_rng([seed, k])``, so the port draws the JAX CLI's windows, crops
and pauses, and a resumed run draws the uninterrupted run's. Voxels stay on
the device from voxelization to the model. Noise and hot pixels draw from
the seeded ``torch.Generator`` "augment" on the main thread, in step order,
DropPath from "droppath". ``--prefetch P`` assembles the next P batches on
a background thread (on CUDA on a stream of its own) and leaves the losses
as they are without it.

``"train": {"bf16": true}`` computes the model in bf16 over f32 weights and
f32 Adam state; ``"train": {"remat": true}`` rematerialises BDE2VID per
time step of its sweeps, and a step model's whole forward, in the backward.

Each checkpoint is ``epoch_N.pth`` in the mmengine layout that the port's and
the JAX package's eval CLIs load; with ``--save_state`` ``epoch_N.state``
beside it holds the full train state (``trainer.save_train_state``), which
``--resume`` continues bit for bit. ``--resume`` also takes a weights file
(``.pth``, or a ``.msgpack`` the JAX package's train CLI wrote, read by
``eval/msgpack_checkpoint.py``): its weights, with a fresh optimizer at step 0,
as the JAX CLI resumes a ``.msgpack``; an orbax directory is refused.
``train_log.jsonl`` in the output
directory gets one line per step: the losses, the step's host seconds and
the part of them spent getting and augmenting the batch. ``--val_dir``
scores held-out windows (``train/validate.py``) into ``val_log.jsonl`` and
keeps the best-MSE weights as ``best.pth``.

PerceptualLoss and VIPLoss entries need the LPIPS AlexNet: its lin heads
(``--lpips_lin``, else ``metrics.lpips.find_default_lpips_lin``) and its
torchvision backbone (``--lpips_backbone``); the CLI refuses such a config
without either, since a random backbone is a silently wrong loss. The LPIPS
weights are frozen and stay out of ``epoch_N.state``. One card per run.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from collections import OrderedDict

import numpy as np

# most sequences a SequenceCache keeps open
MAX_OPEN_SEQUENCES = 64


class SequenceCache:
    """Open sequences kept across windows (re-opening and re-parsing a file
    per window would serialize data assembly with the device step), at most
    ``MAX_OPEN_SEQUENCES`` of them, least recently used first out."""

    def __init__(self, num_bins: int, ltype: str = "H5"):
        self.num_bins, self.ltype = num_bins, ltype
        self._open: "OrderedDict" = OrderedDict()

    def __call__(self, path: str):
        from bde2vid_tpu_torch.data.pipeline import load_sequence

        if path in self._open:
            self._open.move_to_end(path)
            return self._open[path]
        seq = self._open[path] = load_sequence(path, num_bins=self.num_bins, ltype=self.ltype)
        while len(self._open) > MAX_OPEN_SEQUENCES:
            self._open.popitem(last=False)[1].reader.close()
        return seq


def _crop_shape(sensor_hw, crop_size, multiple):
    """Final (ch, cw) crop: the requested size clipped to the sensor and
    rounded down to ``multiple`` (the decoder pyramid's divisibility)."""
    h, w = sensor_hw
    ch, cw = crop_size if crop_size else (h, w)
    ch = min(int(ch), h) // multiple * multiple
    cw = min(int(cw), w) // multiple * multiple
    if ch == 0 or cw == 0:
        raise ValueError(f"sensor {h}x{w} too small to crop to a multiple of {multiple}")
    return ch, cw


def _rotate_voxels(v, fwd):
    """Resample (L, B, H, W) voxels through the 2x3 output-to-input affine
    ``fwd`` (the device twin of RandomRotationFlip)."""
    import torch

    from bde2vid_tpu_torch.data.transforms import affine_base_points
    from bde2vid_tpu_torch.nn.sampling import grid_sample_bilinear

    L, B, H, W = v.shape
    pts = torch.as_tensor(affine_base_points(H, W), dtype=torch.float32, device=v.device)
    grid = pts @ torch.as_tensor(fwd, device=v.device).T
    img = v.reshape(L * B, H, W, 1)
    out = grid_sample_bilinear(img, grid.expand(L * B, H, W, 2))
    return out.reshape(L, B, H, W)


def _one_window(files, rng, seq_len, open_sequence, pause_cfg, crop_size=None, want_flows=False,
                rot_cfg=None, device=None, load=True):
    """One training window from ``files``, opened through ``open_sequence``
    (a SequenceCache): voxels (L, B, ch, cw) on ``device``, frames
    (L, 1, ch, cw) on the host (uint8 where stored so, else f32 in [0, 1]),
    flows (L, 2, ch, cw) or None. Draws from ``rng`` in the JAX CLI's order.
    ``load=False`` makes the same draws and returns None, reading no events
    and no frames (a data-parallel rank skips the windows of other ranks):
    they depend only on the sequences' lengths and sensor sizes, and on
    which of them hold flow."""
    import torch

    from bde2vid_tpu_torch.data.transforms import RandomRotationFlip, sample_pause_mask

    rotflip = None
    if rot_cfg:
        # one rotation/flip per window, shared by its steps (h5_dataset.py:708-712)
        rotflip = RandomRotationFlip(**rot_cfg)
        rotflip.sample_params(rng)
    # random draws first, then every file in an rng-shuffled order, so a run
    # whose long-enough files are rare still finds them
    candidates = [files[int(rng.integers(len(files)))] for _ in range(20)]
    candidates += [files[int(i)] for i in rng.permutation(len(files))]
    for path in candidates:
        seq = open_sequence(path)
        if len(seq) < seq_len:
            continue
        start = int(rng.integers(0, len(seq) - seq_len + 1))
        if want_flows and not seq.has_flows(start + seq_len):
            continue  # this file holds no flow: try another
        idx, paused = sample_pause_mask(seq_len, rng, pause_cfg.get("proba_pause_when_running", 0.0),
                                        pause_cfg.get("proba_pause_when_paused", 0.0))
        if not load:
            h, w = seq.sensor_size
            ch, cw = _crop_shape((h, w), crop_size, 1)
            rng.integers(0, h - ch + 1)
            rng.integers(0, w - cw + 1)
            return None
        flows = seq.flows(start, start + seq_len) if want_flows else None
        vox = seq.voxels(start, start + seq_len, device=device)  # (L, B, H, W)
        frames = seq.frames_u8(start, start + seq_len)
        if frames is None:
            frames = seq.frames(start, start + seq_len)
        frames = frames[idx]
        h, w = int(vox.shape[2]), int(vox.shape[3])
        ch, cw = _crop_shape((h, w), crop_size, 1)
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        # pause: paused steps repeat the previous item with zeroed events
        v = vox[torch.as_tensor(idx, device=vox.device)]
        v = torch.where(torch.as_tensor(paused, device=vox.device)[:, None, None, None],
                        torch.zeros_like(v), v)
        if rotflip is not None:
            # the full sensor rotates before the crop (the reference's order)
            v = _rotate_voxels(v, rotflip.fwd)
            if frames.dtype == np.uint8:
                frames = frames.astype(np.float32) / 255.0
            frames = rotflip(frames)
        v = v[:, :, y0:y0 + ch, x0:x0 + cw]
        frames = frames[:, y0:y0 + ch, x0:x0 + cw]
        if want_flows:
            # paused steps see a static scene: zero displacement
            flows = flows[idx]
            if rotflip is not None:
                flows = np.stack([rotflip(f, is_flow=True) for f in flows])
            flows[np.asarray(paused)] = 0.0
            flows = flows[:, :, y0:y0 + ch, x0:x0 + cw]
        return v, frames[:, None], flows
    need = f">= {seq_len} items" + (" with flow data" if want_flows else "")
    raise ValueError(f"no sequence among {len(files)} files has {need}: shorten "
                     "sequence_length or add data")


def _discover(data_dir: str, ltype: str):
    if ltype == "H5":
        return sorted(glob.glob(os.path.join(data_dir, "**", "*.h5"), recursive=True))
    if ltype == "MMP":
        return sorted(os.path.dirname(p)
                      for p in glob.glob(os.path.join(data_dir, "**", "t.npy"), recursive=True))
    raise NotImplementedError(f"loader type {ltype!r} is not ported yet (H5, MMP)")


def iterate_training_windows(data_dir, seq_len, num_bins, pause_cfg, batch=1, seed=0, multiple=1,
                             crop_size=None, want_flows=False, rot_cfg=None, ltype="H5",
                             device=None, start_step=0, rows=None):
    """Yield (voxels (L, N, B, H, W), frames (L, N, 1, H, W), flows
    (L, N, 2, H, W) or None) batches of ``batch`` independent windows on
    ``device``, one run-wide crop shape (from the smallest sensor, rounded
    down to ``multiple``), from step ``start_step`` on. Step k draws from
    ``default_rng([seed, k])``, so a run resumed at step k draws what the
    uninterrupted run drew there. ``rows`` (lo, hi) keeps windows [lo, hi)
    of each batch, a data-parallel rank's rows: the others' draws are
    replayed without loading them."""
    import torch

    from bde2vid_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    files = _discover(data_dir, ltype)
    if not files:
        raise FileNotFoundError(f"no {ltype} sequences under {data_dir}")
    open_sequence = SequenceCache(num_bins, ltype)
    sensors = [open_sequence(p).sensor_size for p in files]
    min_hw = (min(s[0] for s in sensors), min(s[1] for s in sensors))
    crop_hw = _crop_shape(min_hw, crop_size, multiple)
    lo, hi = (0, batch) if rows is None else rows
    step = int(start_step)
    while True:
        rng = np.random.default_rng([int(seed), step])
        step += 1
        windows = [_one_window(files, rng, seq_len, open_sequence, pause_cfg, crop_hw, want_flows,
                               rot_cfg, device, load=lo <= n < hi) for n in range(batch)]
        vs, fs, fls = zip(*windows[lo:hi])
        # a batch mixing uint8- and float-stored files scales before stacking
        if len({f.dtype for f in fs}) > 1:
            fs = tuple(f.astype(np.float32) / 255.0 if f.dtype == np.uint8 else f for f in fs)
        fr = np.stack(fs, axis=1)
        frames = torch.from_numpy(fr).to(device)
        frames = frames.float() / 255.0 if fr.dtype == np.uint8 else frames
        flows = torch.from_numpy(np.stack(fls, axis=1)).to(device) if want_flows else None
        yield torch.stack(vs, dim=1), frames, flows


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train reconstruction models on event sequences")
    p.add_argument("--config", required=True)
    p.add_argument("--data_dir", default="data/train")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--batch", type=int, default=1,
                   help="independent windows per step; under torchrun split over the ranks")
    p.add_argument("--loader_type", default="H5", choices=["H5", "MMP"],
                   help="H5 event files (default) or memmap directories")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--resume", default=None,
                   help="an epoch_N.state (exact resume at step N: weights, optimizer, "
                   "scheduler and generator states), or a weights .pth or a .msgpack of the "
                   "JAX package (fresh optimizer, step 0)")
    p.add_argument("--save_state", action="store_true",
                   help="also write the full train state epoch_N.state beside each epoch_N.pth")
    p.add_argument("--val_dir", default=None,
                   help="held-out sequences: score MSE/SSIM on fixed windows every --val_every "
                   "steps, append val_log.jsonl, keep the best-MSE weights as best.pth")
    p.add_argument("--val_every", type=int, default=0,
                   help="validation interval in steps (0 disables)")
    p.add_argument("--val_windows", type=int, default=4,
                   help="number of held-out windows scored per validation")
    p.add_argument("--prefetch", type=int, default=0,
                   help="batches assembled ahead by a background thread (0: none)")
    p.add_argument("--lpips_lin", default=None,
                   help="LPIPS lin heads (v0.1 alex .pth) for PerceptualLoss/VIPLoss; "
                   "discovered ($BDE2VID_LPIPS_LIN, weights/lpips/alex.pth) when omitted")
    p.add_argument("--lpips_backbone", default=None,
                   help="torchvision alexnet state dict (features.*) for PerceptualLoss/VIPLoss")
    return p


def load_lpips_for_losses(losses_cfg, lpips_lin, lpips_backbone, device):
    """The frozen LPIPS network the config's PerceptualLoss / VIPLoss
    entries need, or None when it has none. Refuses (SystemExit) without lin
    weights after discovery, and without a backbone."""
    names = {"PerceptualLoss", "VIPLoss"} & {c["type"] for c in losses_cfg}
    if not names:
        return None
    from bde2vid_tpu_torch.eval.checkpoint import load_torch_file
    from bde2vid_tpu_torch.metrics.lpips import find_default_lpips_lin, load_lpips_state

    lpips_lin = lpips_lin or find_default_lpips_lin()
    if not lpips_lin:
        raise SystemExit(f"losses {sorted(names)} need LPIPS weights: pass --lpips_lin "
                         "(and --lpips_backbone)")
    if not lpips_backbone:
        raise SystemExit(f"losses {sorted(names)} need a REAL feature backbone: pass "
                         "--lpips_backbone (torchvision alexnet weights); lin heads alone leave "
                         "the alexnet at random init")
    net = load_lpips_state(load_torch_file(lpips_lin), load_torch_file(lpips_backbone),
                           device=device)
    print(f"lpips: lin {lpips_lin} backbone {lpips_backbone}")
    return net


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch

    from bde2vid_tpu_torch.parallel.mesh import init_distributed

    owns_group = init_distributed(args.device)
    try:
        return _train(args)
    finally:
        if owns_group:
            torch.distributed.destroy_process_group()


def _gather_generator_states(generators):
    """Every rank's {name: state} of ``generators``, in rank order."""
    import torch

    from bde2vid_tpu_torch.parallel.mesh import world_size

    states = {k: g.get_state() for k, g in generators.items()}
    if world_size() == 1:
        return [states]
    out = [None] * world_size()
    torch.distributed.all_gather_object(out, states)
    return out


def _train(args) -> int:
    import torch

    from bde2vid_tpu_torch.data.transforms import (draw_hot_pixels, hot_pixels_from_draws,
                                                   noise_from_draws)
    from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked, load_torch_file
    from bde2vid_tpu_torch.eval.msgpack_checkpoint import check_not_orbax, read_msgpack_state_dict
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.parallel.mesh import barrier, rank, row_block, world_size
    from bde2vid_tpu_torch.parallel.sharded_train import (broadcast_state, make_dp_train_step,
                                                          rank_seed)
    from bde2vid_tpu_torch.train.optim import build_optimizer
    from bde2vid_tpu_torch.train.trainer import (SequenceLossComputer, is_train_state,
                                                 restore_train_state, save_checkpoint,
                                                 save_train_state)
    from bde2vid_tpu_torch.utils.config import Config
    from bde2vid_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    ranks, index = world_size(), rank()
    lead = index == 0  # rank 0 writes the logs, checkpoints and validation results
    if ranks > 1 and not (args.batch > 1 and args.batch % ranks == 0):
        raise SystemExit(f"--batch {args.batch} over {ranks} ranks: a data-parallel run needs a "
                         "batch larger than 1 that divides over the ranks (the JAX CLI trains "
                         "any other batch unsharded on one device)")
    lo, hi = row_block(args.batch, ranks, index)
    cfg = Config.from_json(args.config, make_run_dir=args.out_dir is None and lead)
    out_dir = args.out_dir or cfg.run_dir
    if lead:
        os.makedirs(out_dir, exist_ok=True)

    model_cfg = dict(cfg["model"].get("args", {}))
    model_name = cfg["model"]["type"]
    train_cfg = cfg.get("train", {})
    remat = bool(train_cfg.get("remat", False))
    if remat and model_name == "BDE2VID":
        # per-step remat inside the sequence model; a step model's whole
        # forward is recomputed instead (train_step's ``remat``), as in JAX
        model_cfg["remat"] = True
    # bf16 compute over f32 weights and optimizer state
    dtype = torch.bfloat16 if train_cfg.get("bf16") else torch.float32

    data_cfg = cfg.get("data", {})
    seq_len = int(data_cfg.get("sequence_length", 8))
    num_bins = int(data_cfg.get("num_bins", 5))
    noise_std = float(data_cfg.get("noise_std", 0.0))
    noise_fraction = float(data_cfg.get("noise_fraction", 0.0))
    # H/W divisibility of the decoder pyramid (BDE2VID keeps it under "generator")
    num_encoders = int(model_cfg.get("generator", model_cfg).get("num_encoders", 3))
    crop_size = data_cfg.get("crop_size")
    transforms_cfg = dict(data_cfg.get("transforms", {}))
    rot_cfg = transforms_cfg.pop("RandomRotationFlip", None)
    rc = transforms_cfg.pop("RandomCrop", None)
    if rc is not None and crop_size is None:
        crop_size = rc["size"]
    if transforms_cfg:
        raise SystemExit(f"unknown data.transforms entries: {sorted(transforms_cfg)} "
                         "(supported: RandomRotationFlip, RandomCrop)")
    if crop_size is not None:
        crop_size = ((int(crop_size), int(crop_size)) if np.isscalar(crop_size)
                     else (int(crop_size[0]), int(crop_size[1])))
    hot_std = float(data_cfg.get("hot_pixel_std", 1.0))
    hot_frac = float(data_cfg.get("max_hot_pixel_fraction", 0.0))

    losses_cfg = cfg.get("losses", [{"type": "L1Loss"}])
    want_flows = any(c["type"] == "TemporalConsistencyLoss" for c in losses_cfg)
    lpips = load_lpips_for_losses(losses_cfg, args.lpips_lin, args.lpips_backbone, device)
    comp = SequenceLossComputer(losses_cfg, cfg.get("loss_inds"), lpips=lpips)

    # parameters from a fixed seed, without touching the caller's global RNG
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(model_name, model_cfg, device=device, train=True)
    optimizer, scheduler, grad_clip, desc = build_optimizer(
        model.parameters(), cfg.get("optimizer"), cfg.get("lr_scheduler"))
    print(f"optimizer: {desc}")
    # noise and hot pixels draw from "augment", over the whole batch on every
    # rank; DropPath from "droppath", a stream of each rank's own
    generators = {"augment": torch.Generator(device=device).manual_seed(42),
                  "droppath": torch.Generator(device=device).manual_seed(rank_seed(1, index, ranks))}
    start_step = 0
    if args.resume:
        # an orbax directory's sidecar says train_state too: refuse it first
        check_not_orbax(args.resume)
        if is_train_state(args.resume):
            start_step = restore_train_state(args.resume, model, optimizer, scheduler, generators,
                                             rank=index, ranks=ranks)
            print(f"exact resume from {args.resume} at step {start_step}")
        else:
            # a .msgpack of the JAX package gives its params only, as its CLI resumes it
            if args.resume.endswith(".msgpack"):
                sd = read_msgpack_state_dict(args.resume)
            else:
                sd = load_torch_file(args.resume)
                sd = sd.get("state_dict", sd)
            load_state_dict_checked(model, sd)
            print(f"weights from {args.resume}; fresh optimizer at step 0")

    broadcast_state(model)  # every rank starts from rank 0's weights
    step_fn = make_dp_train_step(model, optimizer, comp, grad_clip=grad_clip,
                                 scheduler=scheduler, dtype=dtype, remat=remat)
    if ranks > 1 and lead:
        print(f"sharding batch {args.batch} over {ranks} ranks")

    validator = None
    if args.val_dir and args.val_every > 0 and lead:
        from bde2vid_tpu_torch.train.validate import Validator

        validator = Validator(model_name, model_cfg, args.val_dir, seq_len=seq_len,
                              num_bins=num_bins, windows=args.val_windows,
                              multiple=2**num_encoders, crop_size=crop_size, dtype=dtype,
                              ltype=args.loader_type, device=device)

    it = iterate_training_windows(
        args.data_dir, seq_len, num_bins, data_cfg, batch=args.batch, multiple=2**num_encoders,
        crop_size=crop_size, want_flows=want_flows, rot_cfg=rot_cfg, ltype=args.loader_type,
        device=device, start_step=start_step, rows=(lo, hi),
    )
    if args.prefetch > 0:
        from bde2vid_tpu_torch.data.prefetch import Prefetcher

        it = Prefetcher(it, size=args.prefetch, device=device)
    steps = args.steps or int(train_cfg.get("steps", 1000))
    ckpt_every = int(train_cfg.get("ckpt_every", 200))
    t_start = time.perf_counter()
    log = open(os.path.join(out_dir, "train_log.jsonl"), "a") if lead else None
    try:
        for i in range(start_step, steps):
            t0 = time.perf_counter()
            voxels, gts, flows = next(it)
            # augmentation draws stay here, in step order, with or without
            # prefetch, over the whole batch: each rank keeps its own rows
            full = (voxels.shape[0], args.batch, *voxels.shape[2:])
            g = generators["augment"]
            if noise_std > 0:
                normal = torch.randn(full, dtype=voxels.dtype, generator=g, device=voxels.device)
                uniform = torch.rand(full, generator=g, device=voxels.device)
                voxels = noise_from_draws(voxels, normal[:, lo:hi], uniform[:, lo:hi], noise_std,
                                          noise_fraction)
            if hot_frac > 0:
                # one hot-pixel pattern per window, shared by its steps
                # (data_augmentation.py:48-59)
                draws = [draw_hot_pixels(g, full[-2], full[-1], voxels.device, hot_std, hot_frac)
                         for _ in range(args.batch)]
                voxels = torch.stack([hot_pixels_from_draws(voxels[:, n - lo], *draws[n])
                                      for n in range(lo, hi)], dim=1)
            t_data = time.perf_counter() - t0
            loss_dict = step_fn(voxels, gts, flows, generator=generators["droppath"])
            losses = dict(zip(loss_dict, torch.stack(list(loss_dict.values())).tolist()))
            if lead:
                log.write(json.dumps({"step": i, **losses, "seconds": time.perf_counter() - t0,
                                      "data_seconds": t_data}) + "\n")
                log.flush()
                if i % 20 == 0:
                    rate = (i + 1 - start_step) / (time.perf_counter() - t_start)
                    print(f"step {i}: loss={losses['loss']:.5f} ({rate:.2f} steps/s)", flush=True)
            if args.val_dir and args.val_every > 0 and ((i + 1) % args.val_every == 0
                                                        or i + 1 == steps):
                if validator is not None:
                    rec = validator.log_and_track(out_dir, i + 1, model)
                    print(f"val step {i + 1}: mse={rec['mse']:.6f} ssim={rec['ssim']:.4f}"
                          + (" (new best)" if rec["best"] else ""), flush=True)
                barrier()
            if (i + 1) % ckpt_every == 0 or i + 1 == steps:
                rank_states = _gather_generator_states(generators) if args.save_state else None
                if lead:
                    path = os.path.join(out_dir, f"epoch_{i + 1}.pth")
                    save_checkpoint(path, model, model_name, model_cfg)
                    print(f"saved {path}", flush=True)
                    if args.save_state:
                        spath = os.path.join(out_dir, f"epoch_{i + 1}.state")
                        save_train_state(spath, model, optimizer, scheduler, i + 1, generators,
                                         model_name, model_cfg,
                                         rank_generators=rank_states if ranks > 1 else None)
                        print(f"saved {spath}", flush=True)
                barrier()
    finally:
        it.close()  # stops a prefetch thread
        if log is not None:
            log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
