"""Model registry and the built-model record (counterpart of
``bde2vid_tpu/models/api.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

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

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.module.parameters()).dtype

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())
