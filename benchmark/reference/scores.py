"""Plain references of the eval protocol's per-frame scores.

- ``mse``: the mean of the squared difference over the frame.
- ``ssim``: skimage.metrics.structural_similarity as the protocol calls it
  (uniform 7x7 window, K1 0.01, K2 0.03, the sample covariance factor
  49/48, valid windows only, data_range 2.0), with the window means taken
  by ``F.avg_pool2d``.
- ``p_loss``: LPIPS v0.1 over the AlexNet trunk (richzhang/
  PerceptualSimilarity, lpips/pretrained_networks.py and lpips/lpips.py):
  inputs scaled from [0, 1] to [-1, 1], gray replicated to 3 channels, the
  ScalingLayer's shift and scale, the trunk's relu1-relu5 taps each
  unit-normalised over channels, squared differences weighted by the lin
  heads' 1x1 kernels, averaged over space and summed over the taps; called
  as (target, prediction).

Weights of the LPIPS net are a flat dict under its names (``backbone.
features.{i}.*``, ``lin{k}.model.1.weight``); ``lpips_shapes`` lists them.
Imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

# AlexNet's features: (index, out channels, in channels, kernel, stride, padding), each
# conv followed by a ReLU at index + 1, max-pools (3, 2) at 2, 5 and 12
_ALEX = ((0, 64, 3, 11, 4, 2), (3, 192, 64, 5, 1, 2), (6, 384, 192, 3, 1, 1), (8, 256, 384, 3, 1, 1),
         (10, 256, 256, 3, 1, 1))
_POOL_AFTER = (0, 3)  # convs whose ReLU output is max-pooled before the next conv
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def lpips_shapes() -> Dict[str, Tuple[int, ...]]:
    s = {}
    for k, (i, co, ci, ks, _, _) in enumerate(_ALEX):
        s[f"backbone.features.{i}.weight"] = (co, ci, ks, ks)
        s[f"backbone.features.{i}.bias"] = (co,)
        s[f"lin{k}.model.1.weight"] = (1, co, 1, 1)
    return s


def _alex_taps(p, x):
    taps = []
    for i, _, _, _, stride, pad in _ALEX:
        x = torch.relu(F.conv2d(x, p[f"backbone.features.{i}.weight"], p[f"backbone.features.{i}.bias"],
                                stride, pad))
        taps.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return taps


def _unit(x):
    return x / (torch.sqrt((x * x).sum(1, keepdim=True)) + 1e-10)


def p_loss(p: Dict[str, torch.Tensor], pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(L, H, W) frames in [0, 1] -> (L,) LPIPS distances."""
    shift = torch.tensor(_SHIFT, device=pred.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=pred.device).view(1, 3, 1, 1)

    def prep(x):
        return ((2.0 * x[:, None] - 1.0).expand(-1, 3, -1, -1) - shift) / scale

    total = 0.0
    for k, (a, b) in enumerate(zip(_alex_taps(p, prep(target)), _alex_taps(p, prep(pred)))):
        d = (_unit(a) - _unit(b)) ** 2
        total = total + F.conv2d(d, p[f"lin{k}.model.1.weight"]).mean(dim=(1, 2, 3))
    return total


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean(dim=(-2, -1))


def ssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(L, H, W) -> (L,)."""
    x, y = pred[:, None], target[:, None]

    def mean(z):
        return F.avg_pool2d(z, 7, stride=1)

    ux, uy = mean(x), mean(y)
    norm = 49.0 / 48.0
    vx = norm * (mean(x * x) - ux * ux)
    vy = norm * (mean(y * y) - uy * uy)
    vxy = norm * (mean(x * y) - ux * uy)
    c1, c2 = (0.01 * 2.0) ** 2, (0.03 * 2.0) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2, 3))


SCORES = {"mse": mse, "ssim": ssim}


def score(name: str, lpips: Dict[str, torch.Tensor], pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return p_loss(lpips, pred, target) if name == "p_loss" else SCORES[name](pred, target)
