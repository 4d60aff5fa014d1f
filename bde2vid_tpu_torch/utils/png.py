"""A minimal PNG writer (counterpart of ``bde2vid_tpu/utils/png.py``): 8-bit
grayscale or RGB, one zlib-compressed IDAT chunk."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) grayscale or (H, W, 3) RGB uint8 as an 8-bit PNG."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError("expected (H, W) or (H, W, 3) uint8")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[:, :, 0]
    if img.ndim == 3 and img.shape[-1] != 3:
        raise ValueError("color images must have 3 channels")
    color_type = 0 if img.ndim == 2 else 2  # grayscale / truecolor
    h, w = img.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n")
        fp.write(chunk(b"IHDR", ihdr))
        fp.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fp.write(chunk(b"IEND", b""))


def write_gray_png(path: str, img: np.ndarray) -> None:
    """Write a (H, W) uint8 array as an 8-bit grayscale PNG."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError("expected (H, W) uint8")
    write_png(path, img)
