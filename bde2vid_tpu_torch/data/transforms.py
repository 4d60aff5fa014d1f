"""Training augmentation (counterpart of ``bde2vid_tpu/data/transforms.py``;
reference utils_func/data_augmentation.py and SequenceDataset,
h5_dataset.py:668-756).

Host-side pieces are NumPy (the pause chain, RandomRotationFlip on frames
and flows); noise and hot pixels run on the device from a
``torch.Generator``. Each random function is split into the draws and a
plain function of them (``*_from_draws``), so tests feed both packages the
same random numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# ----------------------------- geometric (host) -----------------------------


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x, is_flow: bool = False):
        for t in self.transforms:
            x = t(x, is_flow=is_flow)
        return x


class CenterCrop:
    """Centre crop of (..., H, W) arrays or tensors (reference :90-124); the
    offsets use Python's round(), which rounds a half to even."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, x, is_flow: bool = False):
        h, w = x.shape[-2:]
        th, tw = self.size
        i = int(round((h - th) / 2.0))
        j = int(round((w - tw) / 2.0))
        return x[..., i : i + th, j : j + tw]


class RandomCrop:
    """Random crop; ``sample_params(h, w, rng)`` once per sequence, so that
    every item crops the same way."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self._ij: Optional[Tuple[int, int]] = None

    def sample_params(self, h: int, w: int, rng: np.random.Generator):
        th, tw = self.size
        self._ij = (int(rng.integers(0, h - th + 1)), int(rng.integers(0, w - tw + 1)))

    def __call__(self, x, is_flow: bool = False):
        if self._ij is None:
            raise RuntimeError("call sample_params first")
        i, j = self._ij
        th, tw = self.size
        return x[..., i : i + th, j : j + tw]


def np_grid_sample_bilinear(img: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """NumPy bilinear sampling (align_corners=False, zero padding): img
    (H, W, C), grid (H, W, 2) of normalized (x, y)."""
    h, w, _ = img.shape
    fx = ((grid[..., 0].astype(np.float64) + 1.0) * w - 1.0) * 0.5
    fy = ((grid[..., 1].astype(np.float64) + 1.0) * h - 1.0) * 0.5
    x0 = np.floor(fx)
    y0 = np.floor(fy)
    dx = (fx - x0)[..., None].astype(np.float32)
    dy = (fy - y0)[..., None].astype(np.float32)

    def fetch(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xc = np.clip(xi, 0, w - 1).astype(np.int64)
        yc = np.clip(yi, 0, h - 1).astype(np.int64)
        return img[yc, xc] * inb[..., None].astype(np.float32)

    return (fetch(x0, y0) * (1 - dx) * (1 - dy) + fetch(x0 + 1, y0) * dx * (1 - dy)
            + fetch(x0, y0 + 1) * (1 - dx) * dy + fetch(x0 + 1, y0 + 1) * dx * dy)


def affine_base_points(h: int, w: int) -> np.ndarray:
    """(H, W, 3) homogeneous pixel-centre coords of F.affine_grid
    (align_corners=False)."""
    gx = (2.0 * np.arange(w) + 1.0) / w - 1.0
    gy = (2.0 * np.arange(h) + 1.0) / h - 1.0
    xx, yy = np.meshgrid(gx, gy)
    return np.stack([xx, yy, np.ones_like(xx)], axis=-1)


class RandomRotationFlip:
    """Continuous-angle rotation plus axis flips by affine grid sampling
    (reference :158-246). ``sample_params(rng)`` draws the angle and the
    flips once per window; ``fwd`` (2, 3) maps output to input coords. Flow
    fields also get their channels mixed by the inverse matrix. Operates on
    (C, H, W) arrays."""

    def __init__(self, degrees=0.0, p_hflip: float = 0.5, p_vflip: float = 0.5):
        if isinstance(degrees, (int, float)):
            if degrees < 0:
                raise ValueError("degrees must be non-negative")
            degrees = (-degrees, degrees)
        self.degrees = tuple(degrees)
        self.p_hflip = p_hflip
        self.p_vflip = p_vflip
        self.fwd: Optional[np.ndarray] = None
        self.inv: Optional[np.ndarray] = None

    def sample_params(self, rng: np.random.Generator) -> None:
        # the reference get_params draw order (:201-212)
        angle = rng.uniform(self.degrees[0], self.degrees[1])
        hflip = rng.random() < self.p_hflip
        vflip = rng.random() < self.p_vflip
        self.set_params(angle, hflip, vflip)

    def set_params(self, angle_deg: float, hflip: bool, vflip: bool) -> None:
        a = np.deg2rad(angle_deg)
        m = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
        if hflip:
            m[:, 0] *= -1
        if vflip:
            m[:, 1] *= -1
        self.fwd = m[:2, :].astype(np.float32)
        self.inv = np.linalg.inv(m)[:2, :2].astype(np.float32)

    def __call__(self, x, is_flow: bool = False) -> np.ndarray:
        if self.fwd is None:
            raise RuntimeError("call sample_params/set_params first")
        x = np.asarray(x, np.float32)
        _, h, w = x.shape
        grid = (affine_base_points(h, w) @ self.fwd.T).astype(np.float32)
        out = np_grid_sample_bilinear(x.transpose(1, 2, 0), grid)
        out = np.ascontiguousarray(out.transpose(2, 0, 1))
        if is_flow:
            a = self.inv
            vx, vy = out[0].copy(), out[1].copy()
            out[0] = a[0, 0] * vx + a[0, 1] * vy
            out[1] = a[1, 0] * vx + a[1, 1] * vy
        return out


# ------------------------------ noise (device) -------------------------------


def noise_from_draws(voxel: torch.Tensor, normal: torch.Tensor, uniform: torch.Tensor,
                     noise_std: float, noise_fraction: float) -> torch.Tensor:
    noise = noise_std * normal
    if noise_fraction < 1.0:
        noise = torch.where(uniform >= noise_fraction, torch.zeros_like(noise), noise)
    return voxel + noise


def add_noise_to_voxel(voxel: torch.Tensor, generator: torch.Generator, noise_std: float = 1.0,
                       noise_fraction: float = 0.1) -> torch.Tensor:
    """Gaussian noise on a random fraction of voxel entries (reference
    data_augmentation.py:40-45)."""
    kw = dict(generator=generator, device=voxel.device)
    normal = torch.randn(voxel.shape, dtype=voxel.dtype, **kw)
    uniform = torch.rand(voxel.shape, **kw)
    return noise_from_draws(voxel, normal, uniform, noise_std, noise_fraction)


def hot_pixels_from_draws(voxels: torch.Tensor, fraction: torch.Tensor, xs: torch.Tensor,
                          ys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """The first ``int(fraction * H * W)`` of the drawn pixels get their
    value added at every step: voxels (T, ..., H, W)."""
    h, w = voxels.shape[-2:]
    n_active = (fraction * (h * w)).to(torch.int32)
    active = (torch.arange(xs.shape[0], device=voxels.device) < n_active).to(voxels.dtype)
    img = voxels.new_zeros(h * w).index_add_(0, ys * w + xs, vals.to(voxels.dtype) * active)
    return voxels + img.view(h, w)


def add_hot_pixels_to_sequence(voxels: torch.Tensor, generator: torch.Generator,
                               hot_pixel_std: float = 1.0,
                               max_hot_pixel_fraction: float = 0.001) -> torch.Tensor:
    """Persistent hot pixels, the same pixels and values at every step of a
    (T, ..., H, W) voxel window (reference :48-59)."""
    h, w = voxels.shape[-2:]
    kw = dict(generator=generator, device=voxels.device)
    max_n = max(int(max_hot_pixel_fraction * h * w), 1)
    fraction = torch.rand((), **kw) * max_hot_pixel_fraction
    xs = torch.randint(0, w, (max_n,), **kw)
    ys = torch.randint(0, h, (max_n,), **kw)
    vals = torch.randn((max_n,), **kw) * hot_pixel_std
    return hot_pixels_from_draws(voxels, fraction, xs, ys, vals)


# --------------------------- training sequences ------------------------------


def sample_pause_mask(length: int, rng: np.random.Generator, proba_pause_when_running: float = 0.0,
                      proba_pause_when_paused: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Markov pause chain (reference SequenceDataset, h5_dataset.py:721-747):
    step 0 never pauses; a paused step repeats the previous item with zeroed
    events. Returns the item offset of each step and the pause mask."""
    idx = np.zeros(length, np.int64)
    paused = np.zeros(length, bool)
    k = 0
    is_paused = False
    for t in range(1, length):
        p = proba_pause_when_paused if is_paused else proba_pause_when_running
        is_paused = rng.random() < p
        if not is_paused:
            k += 1
        idx[t] = k
        paused[t] = is_paused
    return idx, paused


def normalize_image_sequence(frames: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """1-99 percentile rescale of a whole frame sequence, clamped to [0, 1]
    (reference :30-37); the percentiles interpolate linearly between ranks,
    as np.percentile does."""
    flat = torch.sort(frames.reshape(-1).float()).values
    n = flat.numel()

    def perc(q):
        pos = q / 100.0 * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        return flat[lo] * (1.0 - frac) + flat[hi] * frac

    mini, maxi = perc(1.0), perc(99.0)
    return torch.clamp((frames - mini) / (maxi - mini + eps), 0.0, 1.0)


def subsample_events(xs, ys, ts, ps, rng: np.random.Generator, min_event_num: int):
    """A window of more than ``min_event_num`` events keeps a random sorted
    subset of a uniform size in [min_event_num, len] (reference
    SynchronizedNPYDataset, dataset.py:309-314)."""
    n = len(xs)
    if n <= min_event_num:
        return xs, ys, ts, ps
    keep = int(rng.integers(min_event_num, n + 1))
    idx = np.sort(rng.choice(n, keep, replace=False))
    return xs[idx], ys[idx], ts[idx], ps[idx]
