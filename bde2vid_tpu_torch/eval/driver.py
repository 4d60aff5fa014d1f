"""Sequence evaluation driver (counterpart of ``bde2vid_tpu/eval/driver.py``;
reference eval_models_seq.py:99-290).

Per sequence: between-frames windows -> voxels on the device (LegacyNorm'd
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
from bde2vid_tpu_torch.models.api import ModelSpec, run_sequence
from bde2vid_tpu_torch.utils.norm import robust_norm
from bde2vid_tpu_torch.utils.padding import CropParameters

_METRICS = {"mse": mse, "psnr": psnr, "ssim": ssim}


@dataclasses.dataclass
class EvalConfig:
    num_bins: int = 5
    ltype: str = "H5"
    subseq_L: Optional[int] = 1000
    max_length: Optional[int] = 111200
    voxel_batch: int = 64
    normalize: bool = False
    metrics: Tuple[str, ...] = ("mse", "ssim")
    robust_norm_output: bool = False


def evaluate_sequence(spec: ModelSpec, seq: EventSequence,
                      cfg: EvalConfig) -> Tuple[Dict[str, float], Dict[str, List[float]]]:
    """Evaluate one model on one sequence; returns (result, detail)."""
    unknown = [m for m in cfg.metrics if m not in _METRICS]
    if unknown:
        raise NotImplementedError(f"metrics {unknown} are not ported yet ({sorted(_METRICS)})")
    T = len(seq)
    if cfg.max_length is not None:
        T = min(T, cfg.max_length)
    h, w = seq.sensor_size
    crop = CropParameters(w, h, spec.num_encoders)
    device, dtype = spec.device, spec.dtype

    preds = []
    n_steps = T if seq.item_last is None else int(seq.item_last[T - 1]) + 1
    chunk = cfg.subseq_L or n_steps
    if not spec.is_sequence_model:
        state = spec.initial_state(1, crop.height_crop_size, crop.width_crop_size)
    for s in range(0, n_steps, chunk):
        v = seq.voxels(s, min(s + chunk, n_steps), device=device, batch=cfg.voxel_batch)
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

    u8 = seq.frames_u8(0, T)
    if u8 is not None:
        gts = torch.from_numpy(u8).to(device).float() / 255.0
    else:
        gts = torch.from_numpy(seq.frames(0, T)).to(device)

    detail = {n: _METRICS[n](preds, gts).cpu().numpy() for n in cfg.metrics}
    result = {n: float(np.sum(vals) / T) for n, vals in detail.items()}
    return result, {n: [float(v) for v in vals] for n, vals in detail.items()}


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
                            ltype=ltype, normalize=cfg.normalize)
        try:
            result, detail = evaluate_sequence(spec, seq, cfg)
        finally:
            seq.reader.close()
        results[dataset_name][filename] = result
        details[dataset_name][filename] = detail

    os.makedirs(os.path.dirname(result_file) or ".", exist_ok=True)
    with open(result_file, "w") as fp:
        json.dump(results, fp)
    root, ext = os.path.splitext(result_file)
    with open(f"{root}_detail{ext or '.txt'}", "w") as fp:
        json.dump(details, fp)
    generate_table([result_file], f"{root}_table{ext or '.txt'}")
    return dict(results)
