"""LPIPS host-side image helpers (counterpart of
``bde2vid_tpu/metrics/lpips_util.py``; reference LPIPS/util/util.py:1-457).

The metric-path pieces (normalize_tensor, the l2/dssim fakes, voc_ap, the
2AFC/JND scorers) are in ``metrics/lpips.py``; this module holds the report
and visualisation helpers: NHWC <-> uint8 image conversion, Lab colour
space, bootstrap confidence intervals, montage grids, 255-range PSNR, and
the small debug, patch, resize, display and directory helpers (reference
:152-256). All NumPy on host images, NHWC like the JAX package's (these are
not model tensors); the reference's astropy and skimage dependencies are
replaced by self-contained implementations.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def tensor2im(image: np.ndarray, imtype=np.uint8, cent: float = 1.0,
              factor: float = 255.0 / 2.0) -> np.ndarray:
    """(N, H, W, C) [-1,1] float -> (H, W, C) uint8 of element 0
    (reference util.tensor2im :141-145, NHWC here)."""
    img = np.asarray(image, np.float32)
    if img.ndim == 4:
        img = img[0]
    return ((img + cent) * factor).astype(imtype)


def im2tensor(image: np.ndarray, cent: float = 1.0,
              factor: float = 255.0 / 2.0) -> np.ndarray:
    """(H, W, C) uint8 -> (1, H, W, C) float32 in [-1,1]
    (reference util.im2tensor :147-150, NHWC here)."""
    return (np.asarray(image, np.float32) / factor - cent)[np.newaxis]


def psnr(p0: np.ndarray, p1: np.ndarray, peak: float = 255.0) -> float:
    """255-range PSNR (reference util.psnr :52-53) in NumPy, with the
    reference's uint8-scale peak default and metrics.basic.psnr's zero-MSE
    guard."""
    mse = float(
        np.mean((np.asarray(p0, np.float32) - np.asarray(p1, np.float32)) ** 2)
    )
    return float(10.0 * np.log10(peak * peak / max(mse, 1e-12)))


def rand_flip(input1, input2, rng: Optional[np.random.Generator] = None):
    """Randomly swap a pair (reference util.rand_flip :43-47) — used when
    assembling 2AFC judgments so patch order carries no signal."""
    rng = rng or np.random.default_rng()
    return (input1, input2) if rng.binomial(1, 0.5) == 1 else (input2, input1)


def bootstrap(in_vec, num_samples: int = 100,
              bootfunc: Callable = np.mean,
              rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Bootstrap resampling of a statistic (reference util.bootstrap :39-41,
    which defers to astropy.stats.bootstrap: ``num_samples`` resamples with
    replacement at full length, ``bootfunc`` applied to each). Returns the
    (num_samples,) array of resampled statistics; np.percentile of it gives
    confidence intervals for 2AFC scores."""
    vec = np.asarray(in_vec)
    rng = rng or np.random.default_rng()
    idx = rng.integers(0, len(vec), size=(num_samples, len(vec)))
    return np.array([bootfunc(vec[row]) for row in idx])


# ------------------------------ color space ----------------------------------

# sRGB (D65) -> XYZ matrix and Lab constants (CIE standard; same math
# skimage.color.rgb2lab applies for the reference's :59-64)
_RGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    np.float64,
)
_XYZ_REF_WHITE = np.array([0.95047, 1.0, 1.08883], np.float64)


def rgb2lab(in_img: np.ndarray, mean_cent: bool = False) -> np.ndarray:
    """sRGB [0,1] (H, W, 3) -> CIE Lab (reference util.rgb2lab :59-64 via
    skimage). ``mean_cent`` subtracts 50 from L, centering it near 0."""
    rgb = np.asarray(in_img, np.float64)
    # sRGB inverse companding
    lin = np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    xyz = lin @ _RGB2XYZ.T
    xyz = xyz / _XYZ_REF_WHITE
    eps, kappa = 216.0 / 24389.0, 24389.0 / 27.0
    f = np.where(xyz > eps, np.cbrt(xyz), (kappa * xyz + 16.0) / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    lab = np.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], -1)
    if mean_cent:
        lab[..., 0] -= 50.0
    return lab


def lab2rgb(lab: np.ndarray) -> np.ndarray:
    """Inverse of rgb2lab (reference tensorlab2tensor :118-131 via skimage),
    clipped to [0,1]."""
    lab = np.asarray(lab, np.float64)
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = fy + lab[..., 1] / 500.0
    fz = fy - lab[..., 2] / 200.0
    eps, kappa = 216.0 / 24389.0, 24389.0 / 27.0

    def finv(f):
        f3 = f**3
        return np.where(f3 > eps, f3, (116.0 * f - 16.0) / kappa)

    xyz = np.stack([finv(fx), finv(fy), finv(fz)], -1) * _XYZ_REF_WHITE
    lin = xyz @ np.linalg.inv(_RGB2XYZ).T
    rgb = np.where(
        lin > 0.0031308, 1.055 * np.maximum(lin, 1e-12) ** (1 / 2.4) - 0.055,
        12.92 * lin,
    )
    return np.clip(rgb, 0.0, 1.0)


def tensor2tensorlab(image: np.ndarray, to_norm: bool = True,
                     mc_only: bool = False) -> np.ndarray:
    """(N, H, W, 3) [-1,1] -> (1, H, W, 3) Lab of element 0, optionally
    mean-centered/normalized (reference util.tensor2tensorlab :102-116,
    NHWC here). Faithful to the reference chain: tensor2im FIRST (uint8
    quantization of element 0 only), then rgb2lab of the quantized image —
    skipping the round-trip would shift L by up to the 1/255 code step."""
    img = tensor2im(image)  # uint8 (H, W, 3)
    lab = rgb2lab(img.astype(np.float64) / 255.0)
    if mc_only:
        lab[..., 0] -= 50.0
    if to_norm and not mc_only:
        lab[..., 0] -= 50.0
        lab /= 100.0
    return lab[np.newaxis].astype(np.float32)


# -------------------------------- montage ------------------------------------


def montage(
    imgs: np.ndarray,
    pad: int = 5,
    ratio: float = 16.0 / 9.0,
    mm: int = -1,
    nn: int = -1,
    prime_dir: int = 0,
    back_clr: Tuple[float, float, float] = (0, 0, 0),
) -> np.ndarray:
    """Tile N images into one grid image (reference util.montage :265-372,
    deterministic placement instead of its np.random.permutation write
    order — the output is identical since tiles never overlap).

    imgs: (Y, X, C, N) or (Y, X, N); returns (MM*(Y+pad)-pad, NN*(X+pad)-pad[, C]).
    """
    imgs = np.asarray(imgs)
    to_exp = imgs.ndim == 3
    if to_exp:
        imgs = imgs[:, :, np.newaxis, :]
    y, x, c, n = imgs.shape
    if mm == -1 and nn == -1:
        nn = int(np.ceil(np.sqrt(1.0 * n * ratio)))
        mm = int(np.ceil(1.0 * n / nn))
        nn = int(np.ceil(1.0 * n / mm))
    elif mm == -1:
        mm = int(np.ceil(1.0 * n / nn))
    elif nn == -1:
        nn = int(np.ceil(1.0 * n / mm))
    if n > mm * nn:
        raise ValueError(
            f"montage grid {mm}x{nn} cannot hold {n} images "
            "(the reference would IndexError here too)"
        )
    if prime_dir == 0:  # top-to-bottom
        grid_mm, grid_nn = np.meshgrid(np.arange(mm), np.arange(nn))
    else:  # left-to-right
        grid_nn, grid_mm = np.meshgrid(np.arange(nn), np.arange(mm))
    grid_mm = grid_mm.flatten()[:n]
    grid_nn = grid_nn.flatten()[:n]
    out = np.zeros(((y + pad) * mm - pad, (x + pad) * nn - pad, c), imgs.dtype)
    # (reference broadcasts a 3-vector backClr against any C, which only
    # works at C==3; size it to the channel count instead)
    bc = np.asarray(back_clr).flatten()
    bc = bc[:c] if bc.size >= c else np.full(c, bc[0])
    out += bc[np.newaxis, np.newaxis, :].astype(out.dtype)
    for i in range(n):
        r0, c0 = grid_mm[i] * (y + pad), grid_nn[i] * (x + pad)
        out[r0 : r0 + y, c0 : c0 + x] = imgs[:, :, :, i]
    return out[:, :, 0] if to_exp else out


def tensor2vec(vector_tensor: np.ndarray) -> np.ndarray:
    """(N, 1, 1, C) NHWC -> (N, C) (reference util.tensor2vec :152-153,
    which squeezes the trailing 1x1 spatial dims of an NCHW tensor)."""
    return np.asarray(vector_tensor)[:, 0, 0, :]


def diagnose_network(net, name: str = "network") -> float:
    """Mean over parameters of the mean absolute gradient (reference
    util.diagnose_network :155-165): ``net`` is a torch module, or an
    iterable of gradient tensors; parameters without a gradient are skipped,
    as the reference's ``param.grad is None`` check does. Prints and returns
    the mean."""
    grads = [p.grad for p in net.parameters()] if hasattr(net, "parameters") else list(net)
    leaf_means = [float(g.detach().abs().mean()) for g in grads if g is not None]
    mean = float(np.mean(leaf_means)) if leaf_means else 0.0
    print(name)
    print(mean)
    return mean


def grab_patch(img_in: np.ndarray, P: int, yy: int, xx: int) -> np.ndarray:
    """P×P crop at (yy, xx) of an (H, W, C) image (reference util.grab_patch
    :167-168)."""
    return img_in[yy : yy + P, xx : xx + P, :]


def load_image(path: str) -> np.ndarray:
    """Image file -> (H, W, 3) RGB uint8 (reference util.load_image
    :170-181; its rawpy DNG branch is dropped — rawpy isn't a dependency
    here — and the matplotlib fallback becomes the same cv2 read)."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"load_image: cannot read {path}")
    return img[:, :, ::-1]


def resize_image(img: np.ndarray, max_size: int = 256) -> np.ndarray:
    """Zoom so the longest side is max_size (reference util.resize_image
    :184-192 via scipy.ndimage.zoom)."""
    from scipy.ndimage import zoom

    max_dim = max(img.shape[:2])
    zoom_factor = 1.0 * max_size / max_dim
    return zoom(img, [zoom_factor, zoom_factor, 1])


def resize_image_zoom(img: np.ndarray, zoom_factor: float = 1.0,
                      order: int = 3) -> np.ndarray:
    """Spline zoom with explicit factor (reference util.resize_image_zoom
    :194-198); factor 1 returns the input unchanged."""
    if zoom_factor == 1:
        return img
    from scipy.ndimage import zoom

    return zoom(img, [zoom_factor, zoom_factor, 1], order=order)


def prep_display_image(img: np.ndarray, dtype: str = "uint8") -> np.ndarray:
    """Clip to display range: [0,255] uint8 or [0,1] float (reference
    util.prep_display_image :205-209)."""
    if dtype == "uint8":
        return np.clip(img, 0, 255).astype("uint8")
    return np.clip(img, 0, 1.0)


def info(obj, spacing: int = 10, collapse: int = 1) -> None:
    """Print an object's callable attributes with their docstrings
    (reference util.info :212-226; ``collections.Callable`` there is the
    pre-3.10 spelling of callable())."""
    method_list = [e for e in dir(obj) if callable(getattr(obj, e))]
    process = (lambda s: " ".join(s.split())) if collapse else (lambda s: s)
    print(
        "\n".join(
            f"{m.ljust(spacing)} {process(str(getattr(obj, m).__doc__))}"
            for m in method_list
        )
    )


def varname(p) -> Optional[str]:
    """Best-effort source-level name of the argument at the call site
    (reference util.varname :229-233): inspects the caller's source line
    for ``varname(<identifier>)``. None when the line can't be parsed."""
    import inspect
    import re

    frame = inspect.currentframe().f_back
    for line in inspect.getframeinfo(frame)[3] or []:
        m = re.search(r"\bvarname\s*\(\s*([A-Za-z_][A-Za-z0-9_]*)\s*\)", line)
        if m:
            return m.group(1)
    return None


def print_numpy(x: np.ndarray, val: bool = True, shp: bool = False) -> None:
    """Print shape and/or summary stats of an array (reference
    util.print_numpy :236-245)."""
    x = np.asarray(x).astype(np.float64)
    if shp:
        print("shape,", x.shape)
    if val:
        x = x.flatten()
        print(
            "mean = %3.3f, min = %3.3f, max = %3.3f, median = %3.3f, std=%3.3f"
            % (np.mean(x), np.min(x), np.max(x), np.median(x), np.std(x))
        )


def mkdir(path: str) -> None:
    """mkdir -p one directory (reference util.mkdir :259-261)."""
    import os

    os.makedirs(path, exist_ok=True)


def mkdirs(paths) -> None:
    """mkdir -p one path or a list of paths (reference util.mkdirs
    :248-256)."""
    if isinstance(paths, list) and not isinstance(paths, str):
        for path in paths:
            mkdir(path)
    else:
        mkdir(paths)


def save_image(image: np.ndarray, path: str) -> None:
    """uint8 (H, W[, C]) -> PNG on disk (reference util.save_image :201-203,
    via the repo's dependency-free PNG writer instead of matplotlib).
    Rejects non-uint8 input: a silent cast would truncate float images in
    [0,1] to black (use ``tensor2im`` / explicit scaling first)."""
    from bde2vid_tpu_torch.utils.png import write_png

    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(
            f"save_image expects uint8, got {image.dtype}; scale floats "
            "explicitly (e.g. tensor2im) before saving"
        )
    write_png(path, image)
