"""Spiking neurons as pure state updates (counterpart of
``bde2vid_tpu/nn/spiking.py``; reference model/EVSNN/neurons/spiking_neuron.py).

Every neuron is a function ``(v, x, ...) -> (out, v')`` with the membrane
``v`` explicit state, where the reference keeps it inside a spikingjelly
module. Firing nodes (LIF, IF, PLIF) charge, fire through a Heaviside whose
gradient is the ATan surrogate, and reset: soft (``v_reset`` None, v -= spike
threshold) or hard (v = (1 - spike) v + spike v_reset). Membrane nodes (MpLIF,
MpIF, Mp_AdaLIF) never fire: their output is the membrane.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


class _ATanSpike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, alpha: float) -> Tensor:
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return (x >= 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g: Tensor):
        (x,) = ctx.saved_tensors
        alpha = ctx.alpha
        return g * (alpha / 2.0 / (1.0 + (math.pi / 2.0 * alpha * x) ** 2)), None


def atan_spike(x: Tensor, alpha: float = 2.0) -> Tensor:
    """Heaviside ``x >= 0`` forward; backward the ATan surrogate
    ``alpha / 2 / (1 + (pi / 2 alpha x)^2)`` (spikingjelly surrogate.ATan)."""
    return _ATanSpike.apply(x, alpha)


def _reset(v: Tensor, spike: Tensor, v_threshold: float, v_reset: Optional[float]) -> Tensor:
    if v_reset is None:  # soft reset
        return v - spike * v_threshold
    return (1.0 - spike) * v + spike * v_reset


def lif_step(v: Tensor, x: Tensor, tau: float = 2.0, v_threshold: float = 1.0,
             v_reset: Optional[float] = None, alpha: float = 2.0) -> Tuple[Tensor, Tensor]:
    """LIF: charge ``v += (x - (v - v_reset)) / tau`` (``v_reset`` None or
    0: ``(x - v) / tau``), fire, reset. Returns (spike, v')."""
    if v_reset is None or v_reset == 0.0:
        v = v + (x - v) / tau
    else:
        v = v + (x - (v - v_reset)) / tau
    spike = atan_spike(v - v_threshold, alpha)
    return spike, _reset(v, spike, v_threshold, v_reset)


def if_step(v: Tensor, x: Tensor, v_threshold: float = 1.0, v_reset: Optional[float] = None,
            alpha: float = 2.0) -> Tuple[Tensor, Tensor]:
    """Integrate-and-fire: ``v += x``, fire, reset."""
    v = v + x
    spike = atan_spike(v - v_threshold, alpha)
    return spike, _reset(v, spike, v_threshold, v_reset)


def plif_step(v: Tensor, x: Tensor, w: Tensor, v_threshold: float = 1.0,
              v_reset: Optional[float] = None, alpha: float = 2.0) -> Tuple[Tensor, Tensor]:
    """Parametric LIF: the leak is ``sigmoid(w)`` of a learned scalar ``w``."""
    leak = torch.sigmoid(w)
    if v_reset is None or v_reset == 0.0:
        v = v + (x - v) * leak
    else:
        v = v + (x - (v - v_reset)) * leak
    spike = atan_spike(v - v_threshold, alpha)
    return spike, _reset(v, spike, v_threshold, v_reset)


def mp_lif_step(v: Tensor, x: Tensor, tau: float = 2.0) -> Tensor:
    """Non-firing LIF membrane: ``v' = v + (x - v) / tau``, the output."""
    return v + (x - v) / tau


def mp_if_step(v: Tensor, x: Tensor) -> Tensor:
    """Non-firing IF membrane: ``v' = v + x``."""
    return v + x


def mp_ada_lif_step(v: Tensor, x: Tensor, w: Tensor) -> Tensor:
    """Adaptive-leak membrane: ``v' = v + (x - v) sigmoid(w)``, ``w``
    predicted per sample."""
    return v + (x - v) * torch.sigmoid(w)
