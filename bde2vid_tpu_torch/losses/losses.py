"""Training losses (counterpart of ``bde2vid_tpu/losses/losses.py``;
reference model/losses/losses.py).

- L1Loss (:131-138).
- PerceptualLoss (:141-162): the LPIPS net-lin distance, called as
  (pred, target).
- VIPLoss (:15-128): the sum over backbone slices of 1 - cosine similarity
  between the raw backbone features (after the v0.1 shift and scale, not
  unit-normalised), plus, once the previous step's features exist, the
  temporal term 1 - cos(x - u, y - z) with (u, z) the previous step's
  (pred, target) features. The reference caches those on the module; here
  they are explicit state, passed in and returned.
- TemporalConsistencyLoss (:165-231): Lai ECCV'18 warping error with an
  exponential visibility mask, through bilinear grid sampling.

PerceptualLoss and VIPLoss take a frozen LPIPS network with loaded backbone
weights (``build_loss(cfg, lpips=...)``, from ``metrics.load_lpips_state``):
it runs in f32, on the prediction's device, and gradient reaches the
prediction only.

Images are NCHW, the port's model layout: (N, 1, H, W) images and
(N, 2, H, W) flows.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from bde2vid_tpu_torch.metrics.lpips import LPIPS, cos_sim, to_pm1_3ch
from bde2vid_tpu_torch.nn.sampling import warp_by_flow

LOSS_REGISTRY: Dict[str, Callable] = {}


def register_loss(name):
    def deco(cls):
        LOSS_REGISTRY[name] = cls
        return cls

    return deco


def build_loss(cfg: Dict[str, Any], lpips: Optional[LPIPS] = None):
    """The loss of ``cfg``; ``lpips`` is the network an LPIPS-backed loss
    (PerceptualLoss, VIPLoss) takes, and is not passed to the others."""
    cfg = dict(cfg)
    name = cfg.pop("type")
    if name not in LOSS_REGISTRY:
        raise KeyError(f"unknown loss {name!r}; have {sorted(LOSS_REGISTRY)}")
    cls = LOSS_REGISTRY[name]
    if issubclass(cls, _LPIPSLoss):
        cfg["lpips"] = lpips
    return cls(**cfg)


@register_loss("L1Loss")
class L1Loss:
    def __init__(self, weight: float = 1.0):
        self.weight = weight

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return (pred - target).abs().mean() * self.weight


class _LPIPSLoss:
    """Holds the frozen LPIPS network of an LPIPS-backed loss."""

    def __init__(self, net: str, lpips: Optional[LPIPS]):
        name = type(self).__name__
        if lpips is None:
            raise ValueError(f"{name} needs an LPIPS network: build_loss(cfg, lpips=...) with "
                             "metrics.load_lpips_state(lin, backbone)")
        if lpips.net != net:
            raise ValueError(f"{name}(net={net!r}) was given an LPIPS network of net {lpips.net!r}")
        if not lpips.pretrained_backbone:
            # random backbone features make a silently wrong loss
            raise ValueError(f"{name} needs an LPIPS network with loaded backbone weights")
        self.lpips = lpips.float().eval().requires_grad_(False)

    def _network(self, device: torch.device) -> LPIPS:
        if self.lpips.scaling.shift.device != device:
            self.lpips.to(device)
        return self.lpips


@register_loss("PerceptualLoss")
class PerceptualLoss(_LPIPSLoss):
    """LPIPS distance as a loss, called as (pred, target) (reference
    losses.py:160; the metric calls it as (target, pred))."""

    def __init__(self, net: str = "alex", weight: float = 1.0, lpips: Optional[LPIPS] = None):
        super().__init__(net, lpips)
        self.weight = weight

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        net = self._network(pred.device)
        dist = net(to_pm1_3ch(pred.float(), True), to_pm1_3ch(target.float(), True))
        return dist.mean() * self.weight


VIPState = Optional[Tuple[List[torch.Tensor], List[torch.Tensor]]]


@register_loss("VIPLoss")
class VIPLoss(_LPIPSLoss):
    """Video-consistency perceptual loss. State: None (a sequence's first
    evaluated step, or ``init_state()``) or the previous evaluated step's
    (pred features, target features)."""

    def __init__(self, net: str = "alex", normalize: bool = True, w: float = 1.0,
                 lpips: Optional[LPIPS] = None):
        super().__init__(net, lpips)
        self.normalize = normalize
        self.w = w

    def init_state(self) -> VIPState:
        return None

    def _feats(self, net: LPIPS, x: torch.Tensor) -> List[torch.Tensor]:
        return net.backbone(net.scaling(to_pm1_3ch(x.float(), self.normalize)))

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 state: VIPState = None) -> Tuple[torch.Tensor, VIPState]:
        net = self._network(pred.device)
        outsx, outsy = self._feats(net, pred), self._feats(net, target)
        dist = 0.0
        for kk in range(len(outsx)):
            cur = 1.0 - cos_sim(outsx[kk], outsy[kk])
            if state is not None:
                outsu, outsz = state
                cur = cur + (1.0 - cos_sim(outsx[kk] - outsu[kk], outsy[kk] - outsz[kk]))
            dist = dist + cur
        return dist.mean() * self.w, (outsx, outsy)


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
