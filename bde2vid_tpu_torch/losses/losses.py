"""Training losses (counterpart of ``bde2vid_tpu/losses/losses.py``;
reference model/losses/losses.py).

- L1Loss (:131-138).
- TemporalConsistencyLoss (:165-231): Lai ECCV'18 warping error with an
  exponential visibility mask, through bilinear grid sampling.
- PerceptualLoss and VIPLoss need an LPIPS network, which the port does not
  have yet (ROADMAP A9); building them raises.

Images are NCHW, the port's model layout: (N, 1, H, W) images and
(N, 2, H, W) flows.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from bde2vid_tpu_torch.nn.sampling import warp_by_flow

LOSS_REGISTRY: Dict[str, Callable] = {}


def register_loss(name):
    def deco(cls):
        LOSS_REGISTRY[name] = cls
        return cls

    return deco


def build_loss(cfg: Dict[str, Any]):
    cfg = dict(cfg)
    name = cfg.pop("type")
    if name not in LOSS_REGISTRY:
        raise KeyError(f"unknown loss {name!r}; have {sorted(LOSS_REGISTRY)}")
    return LOSS_REGISTRY[name](**cfg)


@register_loss("L1Loss")
class L1Loss:
    def __init__(self, weight: float = 1.0):
        self.weight = weight

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return (pred - target).abs().mean() * self.weight


class _NeedsLPIPS:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} needs an LPIPS network, which the port does not have yet "
            "(ROADMAP A9, LPIPS)"
        )


@register_loss("PerceptualLoss")
class PerceptualLoss(_NeedsLPIPS):
    """LPIPS distance as a loss (reference :141-162); not ported yet."""


@register_loss("VIPLoss")
class VIPLoss(_NeedsLPIPS):
    """Video-consistency perceptual loss (reference :15-128); not ported yet."""


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def temporal_consistency_loss(image0, image1, processed0, processed1, flow01,
                              alpha: float = 50.0) -> torch.Tensor:
    """Lai ECCV'18 warping error (reference :192-231). Images (N, C, H, W);
    flow01 (N, 2, H, W), the displacement from image1 to image0."""
    flow = _nhwc(flow01)
    image0_w = warp_by_flow(_nhwc(image0), flow)
    visibility = torch.exp(-alpha * (_nhwc(image1) - image0_w) ** 2)
    processed0_w = warp_by_flow(_nhwc(processed0), flow)
    p1 = _nhwc(processed1)
    tc_map = visibility * (p1 - processed0_w).abs() / (p1.abs() + processed0_w.abs() + 1e-5)
    return tc_map.mean()


@register_loss("TemporalConsistencyLoss")
class TemporalConsistencyLoss:
    """Applies from step L0 onward (reference V5:232-236 gates on
    idx_t > func.L0)."""

    def __init__(self, L0: int = 2, weight: float = 1.0):
        self.L0 = L0
        self.weight = weight

    def __call__(self, image0, image1, processed0, processed1, flow01) -> torch.Tensor:
        return temporal_consistency_loss(image0, image1, processed0, processed1, flow01) * self.weight
