"""MSE, PSNR and SSIM (counterpart of ``bde2vid_tpu/metrics/basic.py``).

SSIM is skimage.metrics.structural_similarity as the reference calls it
(evaluate/metrics.py:46-65, no kwargs): a uniform 7x7 window, K1=0.01,
K2=0.03, the sample-covariance correction NP/(NP-1), valid windows only, and
``data_range=2.0`` — skimage's range for float images, although the images
are in [0, 1]. That quirk is part of the published protocol.

Each function reduces over the trailing ``(H, W)`` dims of ``(..., H, W)``
inputs and keeps the leading dims, so one call scores a whole sequence.
"""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over (H, W) (== F.mse_loss per image)."""
    d = pred.float() - target.float()
    return (d * d).mean(dim=(-2, -1))


def psnr(pred: torch.Tensor, target: torch.Tensor, peak: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over (H, W)."""
    m = ((pred.float() - target.float()) ** 2).mean(dim=(-2, -1))
    return 10.0 * torch.log10(peak**2 / torch.clamp(m, min=1e-12))


def _uniform_filter_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean over win x win windows at valid positions, as shifted-slice adds
    (the same f32 additions, in the same order, as the JAX version)."""
    h, w = x.shape[-2], x.shape[-1]
    rows = x[..., : h - win + 1, :]
    for i in range(1, win):
        rows = rows + x[..., i : h - win + 1 + i, :]
    out = rows[..., : w - win + 1]
    for i in range(1, win):
        out = out + rows[..., i : w - win + 1 + i]
    return out * (1.0 / (win * win))


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 2.0,
         win_size: int = 7) -> torch.Tensor:
    """SSIM over (H, W) with the skimage algorithm."""
    im1 = pred.float()
    im2 = target.float()
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)
    ux = _uniform_filter_valid(im1, win_size)
    uy = _uniform_filter_valid(im2, win_size)
    uxx = _uniform_filter_valid(im1 * im1, win_size)
    uyy = _uniform_filter_valid(im2 * im2, win_size)
    uxy = _uniform_filter_valid(im1 * im2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    dr = torch.tensor(data_range, dtype=torch.float32)
    c1 = (0.01 * dr) ** 2
    c2 = (0.03 * dr) ** 2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return ((a1 * a2) / (b1 * b2)).mean(dim=(-2, -1))


def structural_similarity(pred: torch.Tensor, target: torch.Tensor, data_range: float = 2.0,
                          win_size: int = 7) -> torch.Tensor:
    """Batch SSIM of (N, C, H, W) images: mean over channels and batch
    (skimage ``multichannel=True`` per image, as the reference wrapper)."""
    if pred.ndim != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(pred.shape)}")
    return ssim(pred, target, data_range, win_size).mean()


class MseMetric:
    """Streaming length-weighted MSE (reference mmengine MseMetric,
    evaluate/metrics.py:14-39): each call's MSE over all its elements,
    weighted by its number of steps."""

    def __init__(self, prefix: str = "MSE"):
        self.prefix = prefix
        self.results = []

    def process(self, preds: torch.Tensor, gts: torch.Tensor, seq_name: str = "unknown",
                dataset: str = "unknown"):
        d = preds.float() - gts.float()
        self.results.append({self.prefix: float((d * d).mean()), "L": preds.shape[0],
                             "seq_name": seq_name, "dataset": dataset})

    def compute_metrics(self):
        total = sum(r[self.prefix] * r["L"] for r in self.results)
        n = sum(r["L"] for r in self.results)
        return {self.prefix: total / max(n, 1)}
