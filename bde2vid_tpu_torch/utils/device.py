"""Device selection for the port's entry points: CUDA unless the caller asks
for the CPU, and an error (never a silent CPU run) when CUDA is missing.
Under a process group (``parallel.init_distributed``) a bare "cuda" names
the rank's own card, the current device, never cuda:0 for every rank."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means CUDA. Raises when a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
