"""Optic-flow visualisation (counterpart of ``bde2vid_tpu/utils/flow_viz.py``;
reference utils_func/training_utils.py:6-44).

``flow2rgb`` builds the reference's colour code: a normalised coordinate
grid minus the displacement, in polar magnitude and angle, rendered as HSV
(hue = angle / 2, OpenCV's 0-179 convention) and converted to BGR. Plain
NumPy, no OpenCV.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _hsv_to_bgr_u8(hsv: np.ndarray) -> np.ndarray:
    """OpenCV-convention HSV (H in [0, 180), S and V in [0, 255]) -> BGR uint8."""
    h = hsv[..., 0].astype(np.float32) * 2.0  # degrees
    s = hsv[..., 1].astype(np.float32) / 255.0
    v = hsv[..., 2].astype(np.float32) / 255.0
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - np.abs(hp % 2.0 - 1.0))
    z = np.zeros_like(c)
    sector = np.floor(hp).astype(np.int32) % 6
    conds = [sector == k for k in range(5)]
    r = np.select(conds, [c, x, z, z, x], c)
    g = np.select(conds, [x, c, c, x, z], z)
    b = np.select(conds, [z, z, x, c, c], x)
    m = v - c
    bgr = np.stack([b + m, g + m, r + m], axis=-1)
    return np.clip(bgr * 255.0, 0, 255).astype(np.uint8)


def flow2rgb(disp_x: np.ndarray, disp_y: np.ndarray,
             max_magnitude: Optional[float] = None) -> np.ndarray:
    """(H, W) x and y displacements -> (H, W, 3) BGR uint8 colour map."""
    if disp_x.shape != disp_y.shape:
        raise ValueError(f"disp_x {disp_x.shape} and disp_y {disp_y.shape} differ in shape")
    h, w = disp_x.shape
    X, Y = np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h))
    fx = (X - disp_x) * (w / 2.0)
    fy = (Y - disp_y) * (h / 2.0)
    magnitude = np.hypot(fx, fy)
    angle = np.arctan2(fy, fx)
    angle = np.where(angle < 0, angle + 2 * np.pi, angle)  # cv2.cartToPolar's range
    if max_magnitude is None:
        # cv2.normalize(NORM_MINMAX, CV_8U): (m - min) / (max - min) * 255,
        # rounded (saturate_cast), not m / max
        mmin, mmax = magnitude.min(), magnitude.max()
        if mmax > mmin:
            v = np.round((magnitude - mmin) / (mmax - mmin) * 255.0)
        else:
            v = np.zeros_like(magnitude)
        v = np.clip(v, 0, 255).astype(np.uint8)
    else:
        v = (255.0 * magnitude / max_magnitude).astype(np.uint8)
    hsv = np.zeros((h, w, 3), np.uint8)
    hsv[..., 1] = 255
    hsv[..., 0] = (0.5 * angle * 180.0 / np.pi).astype(np.uint8)
    hsv[..., 2] = v
    return _hsv_to_bgr_u8(hsv)
