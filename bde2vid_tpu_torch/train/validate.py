"""Held-out validation in the training loop (counterpart of
``bde2vid_tpu/train/validate.py``).

Every ``--val_every`` steps the model being trained is scored on a fixed set
of held-out windows: MSE (the mean of the per-step ``metrics.basic.mse``) and
SSIM (``structural_similarity`` at the eval CLI's ``data_range=2.0``). Each
round appends one line to ``val_log.jsonl``, and a round whose MSE beats
every earlier one writes ``best.pth`` (the train CLI's checkpoint layout).

- The windows come from the training window sampler with a private seed and
  no pause, noise or rotation, at the run's crop and loader. They are
  assembled once, at construction, and kept on the device: a round reads no
  file.
- A round runs the model in eval mode under ``no_grad``: DropPath off,
  BatchNorm/InstanceNorm on their running statistics, no rematerialisation,
  in the run's compute type. The model goes back to training mode after.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bde2vid_tpu_torch.metrics.basic import mse, structural_similarity
from bde2vid_tpu_torch.train.__main__ import iterate_training_windows
from bde2vid_tpu_torch.train.trainer import save_checkpoint, sequence_forward

# the private seed of the held-out window stream (JAX ``Validator``)
VAL_SEED = 20240 + 613


class Validator:
    """``validator(model) -> {"mse", "ssim"}`` over the held-out windows,
    and the best round so far (``log_and_track``)."""

    def __init__(self, model_name: str, model_cfg: Dict, val_dir: str, *, seq_len: int,
                 num_bins: int, windows: int = 4, multiple: int = 1, crop_size=None,
                 dtype: torch.dtype = torch.float32, ltype: str = "H5", device=None,
                 seed: int = VAL_SEED):
        self.model_name, self.model_cfg = model_name, dict(model_cfg)
        self.dtype = dtype
        it = iterate_training_windows(val_dir, seq_len, num_bins, {}, batch=1, seed=seed,
                                      multiple=multiple, crop_size=crop_size, ltype=ltype,
                                      device=device)
        self.batches: List = [next(it)[:2] for _ in range(int(windows))]
        self.best_mse: Optional[float] = None

    @torch.no_grad()
    def __call__(self, model: torch.nn.Module) -> Dict[str, float]:
        was_training = model.training
        model.eval()
        try:
            ms, ss = [], []
            for voxels, gts in self.batches:
                preds = sequence_forward(model, voxels.to(self.dtype)).float()
                p = preds.reshape((-1,) + preds.shape[2:])
                g = gts.float().reshape((-1,) + gts.shape[2:])
                ms.append(torch.stack([mse(a, b) for a, b in zip(p, g)]).mean())
                ss.append(structural_similarity(p, g))
            ms, ss = torch.stack(ms).tolist(), torch.stack(ss).tolist()
        finally:
            model.train(was_training)
        return {"mse": float(np.mean(ms)), "ssim": float(np.mean(ss))}

    def update_best(self, mse_value: float) -> bool:
        """Record ``mse_value``; True when it beats the best so far."""
        if self.best_mse is None or mse_value < self.best_mse:
            self.best_mse = float(mse_value)
            return True
        return False

    def log_and_track(self, out_dir: str, step: int, model: torch.nn.Module) -> Dict:
        """One round: score, append ``val_log.jsonl``, and write ``best.pth``
        when MSE improved. Returns the record (with its ``best`` flag)."""
        vals = self(model)
        improved = self.update_best(vals["mse"])
        rec = {"step": int(step), "time": time.time(), **vals, "best": bool(improved)}
        with open(os.path.join(out_dir, "val_log.jsonl"), "a") as fp:
            fp.write(json.dumps(rec) + "\n")
        if improved:
            save_checkpoint(os.path.join(out_dir, "best.pth"), model, self.model_name,
                            self.model_cfg)
        return rec
