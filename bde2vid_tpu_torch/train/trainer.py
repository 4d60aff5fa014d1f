"""Sequence loss, the train step and checkpoints (counterpart of
``bde2vid_tpu/train/trainer.py``).

Loss semantics follow the reference BDE2VID in-loop computation
(bde2vid_cross_scale_propogation_V5.py:210-241):

- losses are evaluated per step, optionally only at ``loss_inds`` (an int n
  means steps {0, n, 2n, ...} within the first 40, reference :40-43);
- L1Loss and PerceptualLoss take (pred, gt); VIPLoss also takes the
  previous evaluated step's (pred, gt) features, its state, which each
  VIPLoss entry keeps for itself and which starts anew with each sequence;
  TemporalConsistencyLoss takes (prev_gt, cur_gt, prev_pred, cur_pred,
  flow) and applies only for t > L0;
- total = mean over the evaluated steps per loss, summed over losses; the
  same loss type may appear twice and counts twice.

Images are (T, N, 1, H, W) and flows (T, N, 2, H, W), the port's layout. A
Python loop over T is the whole computation: the JAX package's ``lax.scan``
form exists only to bound its trace size.

A sequence model (BDE2VID) takes the whole window in one call; a step model
runs ``models/api.py::run_sequence`` from its ``initial_state``, and its
train-mode BatchNorm moves the running statistics once per step, which
compounds over T as the JAX step's carried ``batch_stats`` do.

Checkpoints: ``epoch_N.pth`` holds the weights in the mmengine layout that
both packages' eval CLIs load; ``epoch_N.state`` (``save_train_state``) is
the full train state for an exact resume.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bde2vid_tpu_torch.losses import build_loss
from bde2vid_tpu_torch.models.api import run_sequence
from bde2vid_tpu_torch.nn.remat import checkpoint_step


class SequenceLossComputer:
    """Builds losses from a config list and evaluates them over an image
    sequence. ``lpips`` is the frozen LPIPS network that PerceptualLoss and
    VIPLoss entries take (``metrics.load_lpips_state``)."""

    def __init__(self, losses_cfg: Sequence[Dict], loss_inds: Optional[Any] = None,
                 lpips=None):
        # a list of (type, fn) pairs, not a dict keyed by type: two entries of
        # one type (two L1 terms at different weights) both count
        self.losses = [(cfg["type"], build_loss(cfg, lpips=lpips)) for cfg in losses_cfg]
        if loss_inds is not None and not isinstance(loss_inds, (list, tuple)):
            loss_inds = [t for t in range(40) if t % int(loss_inds) == 0]
        self.loss_inds = loss_inds

    def _gate(self, T: int) -> np.ndarray:
        if self.loss_inds is None:
            return np.ones(T, bool)
        g = np.zeros(T, bool)
        for t in self.loss_inds:
            if t < T:
                g[t] = True
        return g

    def _short_names(self):
        """Keys of the loss dict; a repeated type gets an index suffix."""
        seen: Dict[str, int] = {}
        out = []
        for name, _ in self.losses:
            short = "L_" + "".join(c for c in name if c.isupper())
            k = seen.get(short, 0)
            seen[short] = k + 1
            out.append(short if k == 0 else f"{short}{k + 1}")
        return out

    def __call__(self, preds: torch.Tensor, gts: torch.Tensor,
                 flows: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        T = preds.shape[0]
        gate = self._gate(T)
        if flows is None and any(n == "TemporalConsistencyLoss" for n, _ in self.losses):
            raise ValueError("TemporalConsistencyLoss requires flows")
        sums = [preds.new_zeros(()) for _ in self.losses]
        counts = [0] * len(self.losses)
        vip_states: Dict[int, Any] = {}  # each VIPLoss entry's feature state
        prev_gt = prev_pd = None
        for t in range(T):
            cur_pd, cur_gt = preds[t], gts[t]
            if gate[t]:
                for j, (name, fn) in enumerate(self.losses):
                    if name in ("L1Loss", "PerceptualLoss"):
                        v = fn(cur_pd, cur_gt)
                    elif name == "VIPLoss":
                        v, vip_states[j] = fn(cur_pd, cur_gt, vip_states.get(j))
                    elif name == "TemporalConsistencyLoss":
                        if t <= fn.L0 or prev_gt is None:
                            continue
                        v = fn(prev_gt, cur_gt, prev_pd, cur_pd, flows[t])
                    else:
                        raise ValueError(f"unknown loss {name}")
                    sums[j] = sums[j] + v
                    counts[j] += 1
            prev_gt, prev_pd = cur_gt, cur_pd
        loss_dict = {}
        total = preds.new_zeros(())
        for j, short in enumerate(self._short_names()):
            mean = sums[j] / max(counts[j], 1)
            loss_dict[short] = mean
            total = total + mean
        loss_dict["loss"] = total
        return total, loss_dict


def _cast_state(state, dtype: torch.dtype):
    """A step model's (nested) state with its float tensors in ``dtype``."""
    if isinstance(state, torch.Tensor):
        return state.to(dtype) if state.is_floating_point() else state
    if isinstance(state, (tuple, list)):
        return type(state)(_cast_state(s, dtype) for s in state)
    if isinstance(state, dict):
        return {k: _cast_state(v, dtype) for k, v in state.items()}
    return state


def sequence_forward(model: torch.nn.Module, voxels: torch.Tensor,
                     generator: Optional[torch.Generator] = None, remat: bool = False) -> torch.Tensor:
    """Images (T, N, 1, H, W) of ``voxels`` (T, N, B, H, W) in the voxels'
    type. A sequence model takes the window in one call, with ``generator``
    for its DropPath (its ``remat`` is its own config). A step model runs
    from its ``initial_state`` in the voxels' type; ``remat`` recomputes that
    whole forward in the backward (JAX ``make_loss_fn``'s ``jax.checkpoint``)."""
    if getattr(model, "is_sequence_model", False):
        return model(voxels, generator=generator)["image"]
    n, h, w = voxels.shape[1], voxels.shape[3], voxels.shape[4]
    state = _cast_state(model.initial_state(n, h, w), voxels.dtype)

    def run(v):
        return run_sequence(model, v, state)[0]

    return checkpoint_step(run, voxels) if remat else run(voxels)


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               loss_computer: SequenceLossComputer, voxels: torch.Tensor, frames: torch.Tensor,
               flows: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
               grad_clip: Optional[float] = None, scheduler=None,
               dtype: torch.dtype = torch.float32, remat: bool = False,
               ranks=None, rows=None) -> Dict[str, torch.Tensor]:
    """One step (counterpart of ``make_train_step``): forward in training
    mode (``sequence_forward``), sequence loss, backward, global-norm clip,
    optimizer and scheduler step. voxels (T, N, B, H, W), frames (T, N, 1,
    H, W), flows (T, N, 2, H, W) or None. ``dtype`` bfloat16 computes the
    model in bf16 over its f32 weights (the JAX CLI's ``"train": {"bf16":
    true}``): the gradients and the optimizer stay f32, and the loss is
    taken in f32. ``remat``: a step model's whole forward is recomputed in
    the backward (a sequence model rematerialises by its own config).
    ``ranks``: in a data-parallel step (``parallel.make_dp_train_step``),
    the ``RankMean`` that averages the gradients and losses over the ranks
    before the clip and the running statistics after the step; None in one
    process. ``rows``: in a row-sharded step, ``rows(forward, voxels)`` runs
    ``forward`` on this rank's band of the voxels' rows and gathers the
    images (``parallel.sharded_train``). Returns the detached loss dict."""
    optimizer.zero_grad(set_to_none=True)

    def forward(v):
        return sequence_forward(model, v, generator, remat)

    preds = (forward(voxels.to(dtype)) if rows is None else rows(forward, voxels.to(dtype))).float()
    total, loss_dict = loss_computer(preds, frames, flows)
    total.backward()
    losses = {k: v.detach() for k, v in loss_dict.items()}
    if ranks is not None:
        losses = ranks.mean_gradients(losses)
    if grad_clip is not None:
        torch.nn.utils.clip_grad_norm_(model.parameters(), grad_clip)
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    if ranks is not None:
        ranks.mean_statistics()
    return losses


def save_checkpoint(path: str, model: torch.nn.Module, model_name: str, config: Dict) -> None:
    """``{"meta": {"cfg": <python config source>}, "state_dict": ...}``: the
    mmengine layout the port's ``eval/checkpoint.py`` and the JAX package's
    ``load_model_from_torch`` both read (the torch-native counterpart of the
    JAX package's msgpack + json sidecar)."""
    cfg_text = "model = " + repr({"type": model_name, **config}) + "\n"
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"meta": {"cfg": cfg_text}, "state_dict": state}, path)


def save_train_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     scheduler, step: int, generators: Dict[str, torch.Generator],
                     model_name: str, config: Dict,
                     rank_generators: Optional[Sequence[Dict[str, torch.Tensor]]] = None) -> None:
    """The full train state in one ``torch.save`` file, for an exact resume
    (JAX ``save_train_state_orbax``): the model's state dict (BatchNorm
    running statistics included), the optimizer's (Adam moments and step
    counts), the scheduler's, the step, and the state of each generator the
    loop draws from (the port's counterpart of JAX's saved PRNG key: a
    ``torch.Generator`` carries its state where JAX splits a key). A
    ``<path>.json`` sidecar ``{"model", "config", "train_state": true}``
    tells it from a weights-only file (``is_train_state``). A data-parallel
    run passes ``rank_generators``, every rank's generator states in rank
    order, so that each rank of a resumed run continues its own draws."""
    state = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        "scheduler": None if scheduler is None else scheduler.state_dict(),
        "step": int(step),
        "generators": {k: g.get_state() for k, g in generators.items()},
    }
    if rank_generators is not None:
        state["rank_generators"] = list(rank_generators)
    torch.save(state, path)
    with open(path + ".json", "w") as fp:
        json.dump({"model": model_name, "config": config, "train_state": True}, fp)


def is_train_state(path: str) -> bool:
    """True if ``path`` is a full train state (its sidecar says so)."""
    try:
        with open(path + ".json") as fp:
            return bool(json.load(fp).get("train_state"))
    except (OSError, ValueError):
        return False


def restore_train_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                        scheduler, generators: Dict[str, torch.Generator], rank: int = 0,
                        ranks: int = 1) -> int:
    """Load a ``save_train_state`` file into the freshly built ``model``,
    ``optimizer``, ``scheduler`` and ``generators`` of the same run config,
    the generators of rank ``rank`` of ``ranks``: a data-parallel state
    resumes only at the world size it was saved at, and a one-process
    state only in one process. Returns the step to continue from."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if (state["scheduler"] is None) != (scheduler is None):
        raise ValueError(f"{path}: the saved run and this config disagree on the lr scheduler")
    saved = state.get("rank_generators", [state["generators"]])
    if len(saved) != ranks:
        raise ValueError(f"{path}: saved by {len(saved)} rank(s), resumed by {ranks}: a resumed "
                         "run draws exactly only at the world size it was saved at")
    state["generators"] = saved[rank]
    if set(state["generators"]) != set(generators):
        raise ValueError(f"{path}: generators {sorted(state['generators'])}, "
                         f"expected {sorted(generators)}")
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    if scheduler is not None:
        scheduler.load_state_dict(state["scheduler"])
    for k, g in generators.items():
        g.set_state(state["generators"][k])
    return int(state["step"])
