"""Seeded weights, made by the benchmark and handed to both sides: the
program under test loads them, the reference reads them.

All of a model's float tensors come from one ``torch.rand`` call of a
``torch.Generator`` seeded with the run's seed, on the device the model
runs on, then each slice is scaled by its kind: weight matrices and
kernels uniform with variance 1/fan_in, biases within +-0.05, norm scales
1 +- 0.1, running means within +-0.1, running variances in [0.5, 1.5),
relative-position bias tables within +-0.02 and LPIPS's lin heads in [0, 1)
(they are non-negative by construction)."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

SEED_MASK = (1 << 63) - 1


def _scaled(name: str, shape: Tuple[int, ...], u: torch.Tensor) -> torch.Tensor:
    """``u`` uniform in [-1, 1) scaled for the tensor ``name``."""
    if name.endswith(".running_var"):
        return 1.0 + 0.5 * u
    if name.endswith(".running_mean"):
        return 0.1 * u
    if name.endswith("relative_position_bias_table"):
        return 0.02 * u
    if name.startswith("lin") and name.endswith(".model.1.weight"):
        return 0.5 * (u + 1.0)
    if len(shape) == 1:
        return 1.0 + 0.1 * u if name.endswith(".weight") else 0.05 * u
    fan_in = math.prod(shape[1:])
    if "transposed" in name:  # (in, out, kh, kw) at stride 2: a quarter of in * kh * kw
        fan_in = shape[0] * math.prod(shape[2:]) / 4
    return math.sqrt(3.0 / fan_in) * u


def seeded_state(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """Name -> f32 tensor on ``device`` for every entry of ``shapes``, in
    name order, from one uniform draw."""
    names = sorted(shapes)
    total = sum(math.prod(shapes[n]) for n in names)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & SEED_MASK)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for n in names:
        size = math.prod(shapes[n])
        out[n] = _scaled(n, shapes[n], flat[off:off + size].view(shapes[n]))
        off += size
    return out
