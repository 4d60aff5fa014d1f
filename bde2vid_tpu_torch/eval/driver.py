"""Sequence evaluation driver (counterpart of ``bde2vid_tpu/eval/driver.py``;
reference eval_models_seq.py:99-290).

Per sequence: the backend's windows -> voxels on the device (or the stored
voxels of an NPY or H5VOX sequence; LegacyNorm'd
with ``normalize``), the model over ``subseq_L`` chunks, crop back to the
sensor size, then per-step metrics. A sequence model (BDE2VID) runs each
chunk as one forward with fresh recurrent state (the reference resets state
on every call of a sequence model, bde2vid.py:31). A step model (the E2VID
family) starts from one ``initial_state`` per sequence and carries its state
across chunks, as the reference's per-step loop does: ``subseq_L`` only
bounds the steps of one dispatch, and the result does not depend on it.
An event-rate-split sequence (``seq.item_last``, SpadeH5) runs the model
over every sub-voxel up to item T-1's last, and item i's prediction is the
output at ``item_last[i]``; SPADE on an H5 tree is read as SpadeH5. With
``robust_norm_output`` (the SNNs, whose output is a membrane potential)
each cropped prediction is robust-normalised to its 1st and 99th
percentiles before scoring (reference eval_models_seq.py:246-248).

The pause experiment (``pause_st``/``pause_ed``, reference
eval_models_seq.py:174-189): steps in (pause_st, pause_ed] repeat the last
real item with zeroed voxels and do not advance the stream, so the run
extends past the sequence up to ``max_length`` steps and every later step
scores a delayed item; a step model carries its state through the paused
steps. ``eq`` equalises the histograms of predictions and ground truth on
the host after the crop (and any robust norm), the ground truth read as
floats. ``save_images_to`` writes one [events | prediction | ground truth]
PNG a step, the event frame being the step's voxels summed over bins;
``show`` displays them (the JAX package's viewer, which warns and goes on
where cv2 or a display is missing).
``p_loss`` is LPIPS (``EvalConfig.lpips``, a network from
``metrics.load_lpips_state``) per frame, as the reference's
perceptual_loss(target, pred) on [-1, 1] inputs with gray replicated to 3
channels, in chunks of ``LPIPS_CHUNK`` frames, in f32.
``shard_data`` (the CLI's ``--shard_data``) under a process group of more
than one rank shards the ``subseq_L`` chunks over the ranks
(``parallel/sharded_eval.py``), where the JAX driver would: ``subseq_L``
set, more than one chunk, no event-rate split. Each rank voxelizes only its
own chunks; a step model's state then resets at every chunk, as in JAX.
Rank 0 alone reads the frames, scores them and writes the files, and it
alone evaluates a sequence that does not shard.
Results keep the reference JSON schema: ``{dataset: {sequence: {metric: sum over steps / T}}}`` plus a
per-step detail file and a table.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bde2vid_tpu_torch.data.pipeline import EventSequence, load_sequence
from bde2vid_tpu_torch.metrics.basic import mse, psnr, ssim
from bde2vid_tpu_torch.metrics.lpips import LPIPS, to_pm1_3ch
from bde2vid_tpu_torch.models.api import ModelSpec, run_sequence
from bde2vid_tpu_torch.parallel.mesh import rank, world_size
from bde2vid_tpu_torch.parallel.sharded_eval import ChunkPlan, gather_blocks, run_chunks_sharded
from bde2vid_tpu_torch.utils.norm import robust_norm
from bde2vid_tpu_torch.utils.padding import CropParameters
from bde2vid_tpu_torch.utils.png import write_gray_png

_METRICS = {"mse": mse, "psnr": psnr, "ssim": ssim}
# frames an LPIPS call scores at once (the JAX driver's lpips_chunk)
LPIPS_CHUNK = 32


@dataclasses.dataclass
class EvalConfig:
    num_bins: int = 5
    ltype: str = "H5"
    combined_voxel_channels: bool = True
    subseq_L: Optional[int] = 1000
    max_length: Optional[int] = 111200
    pause_st: Optional[int] = None
    pause_ed: Optional[int] = None
    filter_hot_events: bool = False
    voxel_batch: int = 64
    normalize: bool = False
    eq: bool = False
    metrics: Tuple[str, ...] = ("mse", "ssim")
    lpips: Optional[LPIPS] = None  # the network p_loss needs
    robust_norm_output: bool = False
    save_images_to: Optional[str] = None
    show: bool = False
    wait_time: int = 1  # cv2.waitKey ms a frame under show; ESC ends the run
    shard_data: bool = False  # shard the subseq_L chunks over the process group's ranks


def _equalize_hist(img: np.ndarray) -> np.ndarray:
    """cv2.equalizeHist on a [0, 1] float image through its uint8 rounding
    (reference eval_models_seq.py:249-252), by histogram."""
    u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    hist = np.bincount(u8.ravel(), minlength=256)
    cdf = hist.cumsum()
    nonzero = cdf[cdf > 0]
    if len(nonzero) == 0:
        return img
    cdf_min = nonzero[0]
    total = cdf[-1]
    if total == cdf_min:
        return img
    lut = np.round((cdf - cdf_min) / (total - cdf_min) * 255.0).clip(0, 255)
    return lut[u8].astype(np.float32) / 255.0


def _pause_item_map(T: int, pause_st: int, pause_ed: int):
    """(item_idx[T], paused[T]): step i scores item item_idx[i]; the steps in
    (pause_st, pause_ed] repeat the last real item, and the stream resumes
    delayed by the pause, so T - (pause_ed - pause_st) real items are
    consumed (reference eval_models_seq.py:184-189)."""
    t_idx = np.arange(T)
    paused = (t_idx > pause_st) & (t_idx <= pause_ed)
    item_idx = np.where(t_idx <= pause_ed, np.minimum(t_idx, pause_st), t_idx - (pause_ed - pause_st))
    return item_idx, paused


def _check_pause(cfg: EvalConfig, length: int) -> None:
    if (cfg.pause_st is None) != (cfg.pause_ed is None):
        raise ValueError("pause_st and pause_ed must be set together "
                         f"(got pause_st={cfg.pause_st}, pause_ed={cfg.pause_ed})")
    if cfg.pause_st is None:
        return
    if cfg.pause_ed < cfg.pause_st:
        raise ValueError(f"pause_ed ({cfg.pause_ed}) must be >= pause_st ({cfg.pause_st}) — a "
                         "negative pause would silently skip items")
    if cfg.pause_st >= length:
        raise ValueError(f"pause_st ({cfg.pause_st}) is beyond the sequence ({length} items) — the "
                         "reference would exhaust the dataloader before pausing")


def evaluate_sequence(spec: ModelSpec, seq: EventSequence,
                      cfg: EvalConfig) -> Optional[Tuple[Dict[str, float], Dict[str, List[float]]]]:
    """Evaluate one model on one sequence; returns (result, detail) on rank
    0 and None on the other ranks of a process group, which take part only
    in a sharded forward (``shard_data``)."""
    unknown = [m for m in cfg.metrics if m not in _METRICS and m != "p_loss"]
    if unknown:
        raise NotImplementedError(f"metrics {unknown} are not ported yet "
                                  f"({sorted(_METRICS) + ['p_loss']})")
    if "p_loss" in cfg.metrics and cfg.lpips is None:
        raise ValueError("p_loss requested but no LPIPS network configured (EvalConfig.lpips); "
                         "pass --lpips_lin/--lpips_backbone or drop p_loss from metrics")
    _check_pause(cfg, len(seq))
    T = len(seq)
    pause = cfg.pause_st is not None
    if pause:
        # the pause consumes no items: the run extends past the sequence, up
        # to max_length and at most until the stream is exhausted
        pause_len = cfg.pause_ed - cfg.pause_st
        T = cfg.max_length if cfg.max_length is not None else T + pause_len
        T = min(T, len(seq) + pause_len)
    elif cfg.max_length is not None:
        T = min(T, cfg.max_length)
    h, w = seq.sensor_size
    crop = CropParameters(w, h, spec.num_encoders)
    device, dtype = spec.device, spec.dtype

    if pause:
        if seq.item_last is not None:
            raise ValueError("the pause experiment is not defined for ev_rate-split (SpadeH5) "
                             "sequences — the reference never combines them")
        item_idx, paused = _pause_item_map(T, cfg.pause_st, cfg.pause_ed)
        n_real = int(item_idx[-1]) + 1 if T else 0
        frame_items, n_steps = item_idx, T
    else:
        frame_items, n_real = np.arange(T), T
        n_steps = T if seq.item_last is None else int(seq.item_last[T - 1]) + 1
    chunk = cfg.subseq_L or n_steps
    ranks, index = world_size(), rank()
    use_shard = (cfg.shard_data and ranks > 1 and seq.item_last is None
                 and cfg.subseq_L is not None and n_steps > chunk)
    if cfg.shard_data and not use_shard and index == 0:
        print("note: --shard_data inactive (needs >1 rank, subseq_L chunking with multiple "
              "chunks, and no ev_rate splitting)")
    if ranks > 1 and not use_shard and index != 0:
        return None  # rank 0 evaluates this sequence alone

    if pause:
        real = seq.voxels(0, n_real, device=device, batch=cfg.voxel_batch)
        paused_voxels = torch.where(torch.from_numpy(paused).to(real.device)[:, None, None, None],
                                    torch.zeros((), device=real.device),
                                    real[torch.from_numpy(item_idx).to(real.device)])
        steps = lambda a, b: paused_voxels[a:b]
    else:
        steps = lambda a, b: seq.voxels(a, b, device=device, batch=cfg.voxel_batch)

    viz = bool(cfg.save_images_to or cfg.show)
    preds, ev_frames = [], []
    if use_shard:
        # chunks shard over the ranks; each voxelizes only its own. For step
        # models sharding resets the state at every chunk, a documented
        # divergence from the sequential default (which carries it)
        if not spec.is_sequence_model and index == 0:
            print(f"note: --shard_data resets recurrent state every {chunk} steps (chunk "
                  "independence is what shards)")
        own_ev = {}

        def voxels_of(a, b):
            v = steps(a, b)
            if viz:
                own_ev[a] = v.sum(1)
            return crop.pad(v[:, None]).to(dtype)

        hw = (crop.height_crop_size, crop.width_crop_size)
        preds.append(run_chunks_sharded(spec, voxels_of, n_steps, chunk, hw))
        if viz:
            plan = ChunkPlan(n_steps, chunk, ranks, spec.is_sequence_model)
            own = [own_ev[a] for a, _ in plan.chunks(index)]
            tail = own_ev[plan.tail[0]] if plan.tail and index == plan.tail_rank else None
            ev_frames.append(gather_blocks(plan, torch.cat(own) if own else None, (h, w),
                                           tail=tail, device=device))
        if index != 0:
            return None  # rank 0 reads the frames and scores
    else:
        if not spec.is_sequence_model:
            state = spec.initial_state(1, crop.height_crop_size, crop.width_crop_size)
        for s in range(0, n_steps, chunk):
            v = steps(s, min(s + chunk, n_steps))
            if viz:
                ev_frames.append(v.sum(1))
            x = crop.pad(v[:, None]).to(dtype)  # (L, 1, B, H', W')
            with torch.no_grad():
                if spec.is_sequence_model:
                    images = spec.module(x)["image"]
                else:
                    images, state = run_sequence(spec.module, x, state)
            preds.append(images.float())
    preds = torch.cat(preds)
    if seq.item_last is not None:
        preds = preds[torch.from_numpy(seq.item_last[:T]).to(preds.device)]
    preds = crop.crop(preds)[:, 0, 0]  # (T, H, W)
    if cfg.robust_norm_output:
        preds = torch.stack([robust_norm(p, 1, 99) for p in preds])

    # the ground truth as stored uint8 where the backend has it, but as
    # floats under eq, which equalises host floats
    u8 = None if cfg.eq else seq.frames_u8(0, n_real)
    frames = (u8 if u8 is not None else seq.frames(0, n_real))[frame_items]  # (T, H, W)
    if cfg.eq:
        preds = torch.from_numpy(np.stack([_equalize_hist(p) for p in preds.cpu().numpy()])).to(device)
        gts = torch.from_numpy(np.stack([_equalize_hist(g) for g in frames])).to(device)
    elif u8 is not None:
        gts = torch.from_numpy(frames).to(device).float() / 255.0
    else:
        gts = torch.from_numpy(frames).to(device)

    if viz:
        ev = torch.cat(ev_frames)
        if seq.item_last is not None:  # the sub-window of each item's prediction
            ev = ev[torch.from_numpy(seq.item_last[:T]).to(ev.device)]
        ev = ev.cpu().numpy()
        gt_f32 = frames.astype(np.float32) / 255.0 if frames.dtype == np.uint8 else frames
        pred_np = preds.cpu().numpy()
        if cfg.save_images_to:
            os.makedirs(cfg.save_images_to, exist_ok=True)
            _save_triptychs(cfg.save_images_to, ev, pred_np, gt_f32)
        if cfg.show:
            _show_triptychs(ev, pred_np, gt_f32, cfg.wait_time)

    detail = {n: (_p_loss(cfg.lpips, preds, gts) if n == "p_loss" else _METRICS[n](preds, gts))
              .cpu().numpy() for n in cfg.metrics}
    result = {n: float(np.sum(vals) / T) for n, vals in detail.items()}
    return result, {n: [float(v) for v in vals] for n, vals in detail.items()}


def _p_loss(net: LPIPS, preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """LPIPS of each (T, H, W) frame pair, ``LPIPS_CHUNK`` frames a call: a
    frame's ``lpips_distance(net, pred, gt)``, batched."""
    net = net.to(preds.device)
    chunks = []
    with torch.no_grad():
        for s in range(0, len(preds), LPIPS_CHUNK):
            p = to_pm1_3ch(preds[s:s + LPIPS_CHUNK, None].float(), True)
            g = to_pm1_3ch(gts[s:s + LPIPS_CHUNK, None].float(), True)
            chunks.append(net(g, p))
    return torch.cat(chunks)


def _triptych(ev_i, pred_i, gt_i) -> np.ndarray:
    """[event frame | prediction | ground truth] uint8 strip, the event
    frame scaled to its own range (reference eval_models_seq.py:263-264)."""
    rng = ev_i.max() - ev_i.min()
    e = (ev_i - ev_i.min()) / (rng + 1e-6)
    img = np.concatenate([e, pred_i, gt_i], axis=1)
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def _save_triptychs(folder, ev, pred, gt):
    """One ``frame_{i:010d}.png`` a step in ``folder`` (reference saveim
    :266-270), written by ``utils/png.py``."""
    for i in range(len(pred)):
        write_gray_png(os.path.join(folder, f"frame_{i:010d}.png"), _triptych(ev[i], pred[i], gt[i]))


def _show_triptychs(ev, pred, gt, wait_time: int = 1):
    """The JAX package's live viewer (reference showim :272-276): a cv2
    window a step, ESC ends the run with code 0. Without cv2 or a display it
    prints a warning and the evaluation goes on."""
    try:
        import cv2
    except ImportError:
        print("warning: --show requested but cv2 is not available")
        return
    # Qt's headless failure is an abort() no except catches: look for a display first
    if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        print("warning: --show disabled (no display in this environment)")
        return
    for i in range(len(pred)):
        try:
            cv2.imshow("result", _triptych(ev[i], pred[i], gt[i]))
            key = cv2.waitKey(wait_time) & 0xFF
        except cv2.error as err:
            print(f"warning: --show disabled ({err})")
            return
        if key == 27:  # ESC
            raise SystemExit(0)


def evaluate_all(spec: ModelSpec, datafiles: Sequence[str], data_dir: str, result_file: str,
                 cfg: EvalConfig) -> Dict:
    """Evaluate over many sequences; write the result JSON, the per-step
    detail JSON and the table (reference eval_model_alldata :99-144,
    including the result-file skip lock)."""
    from bde2vid_tpu_torch.eval.tables import generate_table

    if os.path.exists(result_file):
        print(f"skipping {result_file} (exists)")
        return {}
    results = collections.defaultdict(dict)
    details = collections.defaultdict(dict)
    # the reference pairs SPADE with event-rate splitting
    ltype = "SpadeH5" if spec.name == "SPADEE2VID" and cfg.ltype == "H5" else cfg.ltype
    for datafile in datafiles:
        dataset_name, filename = os.path.split(datafile)
        dataset_name = os.path.basename(dataset_name) or "unknown"
        filename = filename.split(".h5")[0]
        seq = load_sequence(os.path.join(data_dir, datafile), num_bins=cfg.num_bins,
                            ltype=ltype, normalize=cfg.normalize,
                            combined_voxel_channels=cfg.combined_voxel_channels,
                            hot_filter=cfg.filter_hot_events)
        try:
            scored = evaluate_sequence(spec, seq, cfg)
        finally:
            seq.reader.close()
        if scored is None:
            continue  # another rank than 0 under a process group
        results[dataset_name][filename], details[dataset_name][filename] = scored

    if rank() != 0:
        return {}  # rank 0 writes the files
    os.makedirs(os.path.dirname(result_file) or ".", exist_ok=True)
    with open(result_file, "w") as fp:
        json.dump(results, fp)
    root, ext = os.path.splitext(result_file)
    with open(f"{root}_detail{ext or '.txt'}", "w") as fp:
        json.dump(details, fp)
    generate_table([result_file], f"{root}_table{ext or '.txt'}")
    return dict(results)
