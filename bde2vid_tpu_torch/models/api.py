"""Model registry, the built-model record and the step-model sequence
runners (counterpart of ``bde2vid_tpu/models/api.py``).

A step model maps one frame and its state to ``({"image": ...}, state)``
and makes its first state with ``initial_state(batch, H, W)``; a sequence
model (BDE2VID) maps a whole (T, N, B, H, W) sequence at once and keeps its
state inside the call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        return cls

    return deco


def build_model(name: str, config: Dict[str, Any], device=None, dtype=torch.float32,
                train: bool = False):
    """Instantiate a registered model family by name on ``device`` (CUDA
    unless the CPU is asked for) in ``dtype``, in training mode with
    ``train`` (DropPath active) and evaluation mode otherwise."""
    from bde2vid_tpu_torch.utils.device import resolve_device

    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODEL_REGISTRY)}")
    dev = resolve_device(device)
    return MODEL_REGISTRY[name](config=config).to(device=dev, dtype=dtype).train(train)


@dataclasses.dataclass
class ModelSpec:
    """A built model and what the eval driver needs to run it."""

    name: str
    module: torch.nn.Module
    num_bins: int = 5
    num_encoders: int = 0  # spatial padding to /2^num_encoders
    is_sequence_model: bool = False  # BDE2VID: one forward per (sub)sequence
    normalize: bool = False  # the checkpoint asks for LegacyNorm'd voxels

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.module.parameters()).dtype

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    def initial_state(self, batch: int, height: int, width: int):
        return self.module.initial_state(batch, height, width)

    def step(self, voxel: torch.Tensor, state):
        return self.module(voxel, state)


def run_sequence(module: torch.nn.Module, voxels: torch.Tensor, state) -> Tuple[torch.Tensor, Any]:
    """Run a step model over (T, N, B, H, W) voxels from ``state``: the
    stacked images (T, N, 1, H, W) and the state after the last step."""
    images = []
    for voxel in voxels:
        out, state = module(voxel, state)
        images.append(out["image"])
    return torch.stack(images), state


def run_sequence_chunked(module: torch.nn.Module, voxels: torch.Tensor, state,
                         chunk: int = 1000) -> torch.Tensor:
    """``run_sequence`` over chunks of ``chunk`` steps, each from ``state``
    afresh (the reference's ``subseq_L`` reset)."""
    return torch.cat([run_sequence(module, voxels[s:s + chunk], state)[0]
                      for s in range(0, voxels.shape[0], chunk)])
