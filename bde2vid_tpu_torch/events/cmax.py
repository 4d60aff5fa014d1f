"""Contrast maximization: the linear-velocity warp, images of warped events
(IWE), their objectives and the BFGS loop (counterpart of
``bde2vid_tpu/events/cmax.py``; reference events_contrast_maximization/
utils/{events_cmax.py:47-120, objectives.py:56-438, warps.py:20-37}).

Warps and objectives are differentiable torch functions of the warp
parameters: ``torch.autograd`` gives the gradients that the reference
derives by hand, and scipy's BFGS consumes them. Everything runs on the
device of its inputs; ``optimize_contrast`` takes NumPy events and a
``device`` (CUDA unless the CPU is asked for).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from bde2vid_tpu_torch.events.voxel import (
    Count,
    events_to_image_bilinear,
    events_to_image_drv,
    events_to_timestamp_image,
    pad_events,
)
from bde2vid_tpu_torch.utils.device import resolve_device

# ----------------------------------------------------------------------- warps


def linvel_warp(xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor, params: torch.Tensor,
                t0=0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global optic flow: p' = p - (t - t0) v, params = (vx, vy)
    (reference warps.py:20-37)."""
    dt = ts - t0
    return xs - dt * params[0], ys - dt * params[1]


def linvel_warp_jacobian(ts: torch.Tensor, t0=0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(jx, jy), each (2, N): the warped coordinates' derivatives with
    respect to (vx, vy) (reference warps.py:32-36)."""
    dt = ts - t0
    zeros = torch.zeros_like(dt)
    return torch.stack([-dt, zeros]), torch.stack([zeros, -dt])


LINVEL_DIMS = 2


def events_bounds_mask(xs: torch.Tensor, ys: torch.Tensor, x_min, x_max, y_min, y_max
                       ) -> torch.Tensor:
    """1.0 for events inside (min, max] on both axes, the reference's
    open-at-min convention (event_utils.py:141-147)."""
    keep_x = ~((xs <= x_min) | (xs > x_max))
    keep_y = ~((ys <= y_min) | (ys > y_max))
    return (keep_x & keep_y).float()


# ------------------------------------------------------------------------- IWE


def _symmetric_index(n: int, radius: int, device) -> torch.Tensor:
    """Source rows of numpy's ``"symmetric"`` pad by ``radius``: the edge
    repeats, ``[1 0 | 0 1 2 3 | 3 2]`` (torch's ``"reflect"`` would skip it)."""
    i = torch.arange(-radius, n + radius, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def gaussian_blur(img: torch.Tensor, sigma: Optional[float]) -> torch.Tensor:
    """Separable Gaussian blur of the last two dims (scipy's gaussian_filter,
    truncate 4, boundary ``reflect`` = numpy ``symmetric``). The taps are
    explicit f32 multiply-adds, never a convolution: a TF32 convolution's
    ~1e-3 relative noise swamps the ~1e-4 objective steps of BFGS's line
    search, and multiply-adds stay f32 whatever the backend flags."""
    if sigma is None or sigma <= 0:
        return img
    radius = int(4.0 * sigma + 0.5)
    offs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (offs / np.float32(sigma)) ** 2).astype(np.float32)
    k = (k / k.sum(dtype=np.float32)).astype(np.float32)
    h, w = img.shape[-2:]
    img = img.index_select(-2, _symmetric_index(h, radius, img.device))
    img = img.index_select(-1, _symmetric_index(w, radius, img.device))
    rows = sum(float(k[i]) * img[..., i:i + h, :] for i in range(2 * radius + 1))
    return sum(float(k[i]) * rows[..., i:i + w] for i in range(2 * radius + 1))


def _warp_to_last(params, xs, ys, ts, img_size):
    """Events warped to ``ts[-1]`` (the padded buffer's last, which
    pad_events fills with the last valid ts) and their bounds mask."""
    wx, wy = linvel_warp(xs.float(), ys.float(), ts, params, t0=ts[-1])
    return wx, wy, events_bounds_mask(wx, wy, 0, img_size[1], 0, img_size[0])


def get_iwe(params: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor,
            ps: torch.Tensor, n_events: Count, img_size: Tuple[int, int] = (180, 240),
            use_polarity: bool = True, blur_sigma: Optional[float] = None) -> torch.Tensor:
    """Image of events warped to the last timestamp (objectives.py:56-71):
    events warped outside (0, img_size] drop before the bilinear raster,
    which runs at ``img_size``; then the blur."""
    wx, wy, mask = _warp_to_last(params, xs, ys, ts, img_size)
    weights = ps if use_polarity else ps.abs()
    iwe = events_to_image_bilinear(wx * mask, wy * mask, weights * mask, n_events,
                                   sensor_size=img_size)
    return gaussian_blur(iwe, blur_sigma)


def get_iwe_drv(params: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor,
                ps: torch.Tensor, n_events: Count, img_size: Tuple[int, int] = (180, 240),
                use_polarity: bool = True, blur_sigma: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The IWE and its analytic derivative planes (2, H, W) with respect to
    the warp parameters (the reference's ``compute_gradient=True`` chain,
    objectives.py:57-71, event_utils.py:186-249); the masked events' jacobians
    are zeroed too. A cross-check of the autograd gradients."""
    wx, wy, mask = _warp_to_last(params, xs, ys, ts, img_size)
    jx, jy = linvel_warp_jacobian(ts, t0=ts[-1])
    weights = ps if use_polarity else ps.abs()
    iwe, d_iwe = events_to_image_drv(wx * mask, wy * mask, weights * mask, jx * mask, jy * mask,
                                     n_events, sensor_size=img_size)
    return gaussian_blur(iwe, blur_sigma), gaussian_blur(d_iwe, blur_sigma)


# ------------------------------------------------------------------ objectives


def variance_objective(iwe: torch.Tensor) -> torch.Tensor:
    """Negative variance, ddof 0 (Gallego'18; objectives.py:73-113)."""
    return -torch.var(iwe, correction=0)


def rms_objective(iwe: torch.Tensor) -> torch.Tensor:
    """Negative 'RMS' (objectives.py:115-138) over the SPECTRAL norm, which
    the reference's ``np.linalg.norm(iwe, 2)`` computes on a 2-D image;
    kept for value parity."""
    s = torch.linalg.matrix_norm(iwe, ord=2)
    return -(s * s) / (iwe.shape[0] * iwe.shape[1])


def sos_objective(iwe: torch.Tensor) -> torch.Tensor:
    """Negative mean of squares (Stoffregen'19; objectives.py:157-198)."""
    return -torch.mean(iwe ** 2)


def soe_objective(iwe: torch.Tensor) -> torch.Tensor:
    """Negative mean of exponentials (objectives.py:200-241)."""
    return -torch.mean(torch.exp(iwe))


def moa_objective(iwe: torch.Tensor) -> torch.Tensor:
    """Negative max of accumulations (objectives.py:243-271)."""
    return -torch.max(iwe)


def isoa_objective(iwe: torch.Tensor, thresh: float = 0.5) -> torch.Tensor:
    """Sum of soft suprathreshold accumulations (objectives.py:273-318): a
    sigmoid in place of the reference's count keeps it differentiable."""
    return torch.sum(torch.sigmoid((iwe - thresh) * 50.0))


def sosa_objective(iwe: torch.Tensor, p: float = 3.0) -> torch.Tensor:
    """Negative sum of suppressed accumulations exp(-p iwe)
    (objectives.py:320-345)."""
    return -torch.sum(torch.exp(-p * iwe))


OBJECTIVES: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "variance": variance_objective,
    "rms": rms_objective,
    "sos": sos_objective,
    "soe": soe_objective,
    "moa": moa_objective,
    "isoa": isoa_objective,
    "sosa": sosa_objective,
}


def zhu_timestamp_objective(params: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                            ts: torch.Tensor, ps: torch.Tensor, n_events: Count,
                            img_size: Tuple[int, int] = (180, 240),
                            blur_sigma: Optional[float] = 2.0) -> torch.Tensor:
    """Negative sum of the squared timestamp images (Zhu CVPR'19,
    objectives.py:366-400): events warped to ts[-1], out-of-bounds ones
    zeroed in coordinates, ts and polarity (so they join the non-positive
    image at the origin, a reference quirk), per-polarity timestamp images
    at ``img_size``, blurred. ``blur_sigma=None`` means zhu's 2.0; pass 0
    for no blur."""
    if blur_sigma is None:
        blur_sigma = 2.0
    wx, wy, mask = _warp_to_last(params, xs, ys, ts, img_size)
    img_pos, img_neg = events_to_timestamp_image(wx * mask, wy * mask, ts * mask, ps * mask,
                                                 n_events, sensor_size=img_size)
    img_pos = gaussian_blur(img_pos, blur_sigma)
    img_neg = gaussian_blur(img_neg, blur_sigma)
    return -(torch.sum(img_pos * img_pos) + torch.sum(img_neg * img_neg))


# ---------------------------------------------------------------- optimization


def objective_fn(objective: str, img_size: Tuple[int, int], use_polarity: bool,
                 blur_sigma: Optional[float]):
    """``f(params, xs, ys, ts, ps, n_events)`` of one configuration. zhu
    keeps two reference behaviours (objectives.py:366-393): ``blur_sigma``
    None means 2.0, and it splits by raw polarity, so it refuses
    ``use_polarity=False`` rather than ignore it."""
    if objective == "zhu":
        if not use_polarity:
            raise ValueError("the zhu objective ignores use_polarity (it splits events "
                             "by raw polarity); pass use_polarity=True")
        sigma = 2.0 if blur_sigma is None else blur_sigma
        return lambda p, *ev: zhu_timestamp_objective(p, *ev, img_size=img_size, blur_sigma=sigma)
    obj = OBJECTIVES[objective]
    return lambda p, *ev: obj(get_iwe(p, *ev, img_size=img_size, use_polarity=use_polarity,
                                      blur_sigma=blur_sigma))


def optimize_contrast(xs: np.ndarray, ys: np.ndarray, ts: np.ndarray, ps: np.ndarray,
                      objective: str = "variance", x0: Optional[np.ndarray] = None,
                      img_size: Tuple[int, int] = (180, 240), blur_sigma: Optional[float] = 1.0,
                      use_polarity: bool = True, device=None, full_output: bool = False):
    """BFGS over the warp parameters (reference optimize_contrast :47-77)
    with autograd gradients, the events padded once and held on ``device``.
    Returns the parameters that maximize the contrast, or with
    ``full_output`` scipy's ``fmin_bfgs`` tuple (xopt, fopt, gopt, Bopt,
    func_calls, grad_calls, warnflag)."""
    import scipy.optimize as opt

    dev = resolve_device(device)
    f = objective_fn(objective, tuple(img_size), use_polarity, blur_sigma)
    padded = pad_events(xs.astype(np.float32), ys.astype(np.float32), ts, ps)
    events = [torch.from_numpy(a).to(dev) for a in padded[:4]]
    n = padded[4]
    last: Dict[str, object] = {}

    def value_and_grad(p):
        key = np.asarray(p, np.float32).tobytes()
        if last.get("key") != key:
            params = torch.tensor(np.asarray(p, np.float32), device=dev, requires_grad=True)
            v = f(params, *events, n)
            (g,) = torch.autograd.grad(v, params)
            last.update(key=key, v=v.item(), g=g.double().cpu().numpy())
        return last["v"], last["g"]

    x0 = np.zeros(LINVEL_DIMS) if x0 is None else np.asarray(x0, np.float64)
    return opt.fmin_bfgs(lambda p: value_and_grad(p)[0], x0, fprime=lambda p: value_and_grad(p)[1],
                         disp=False, full_output=full_output)


def optimize_r2(xs, ys, ts, ps, objective: str = "sos", **kw) -> np.ndarray:
    """Two stages, the second SoE at blur 1.0 (reference :102-120)."""
    argmax = optimize_contrast(xs, ys, ts, ps, objective=objective, blur_sigma=None, **kw)
    return optimize_contrast(xs, ys, ts, ps, objective="soe", x0=argmax, blur_sigma=1.0, **kw)
