"""Operation and byte counts of the program's kernels, for their roofline
shares. Frozen from ``chip_smoke.py`` (``swin_block_cost``), with the window
count of a Swin block's call worked out from its input's shape."""

from __future__ import annotations

from typing import Tuple


def swin_block_cost(d, b, m, c, heads, hidden, elem_bytes):
    """(FLOPs, bytes) one fused_swin_block call needs: 2 per multiply-add of
    the projections, attention and MLP; each input read once (x, ctr,
    weights in the operand type, vectors and the bias in f32), the output
    written once."""
    n = d * m
    hd = c // heads
    flops = (2 * d * b * m * c * 2 * c + 2 * b * m * c * c + 2 * 2 * b * heads * m * n * hd
             + 2 * b * m * c * c + 2 * 2 * b * m * c * hidden)
    nbytes = (elem_bytes * (d * b * m * c + 2 * b * m * c + 4 * c * c + 2 * c * hidden)
              + 4 * (heads * m * n + 10 * c + hidden))
    return flops, nbytes


def swin_windows(h: int, w: int, win: Tuple[int, int], dilate: bool) -> int:
    """Windows a sample of an (h, w) map runs in one Swin block: the map
    padded (centred) to window multiples, then cut into windows, or for a
    dilated block sampled by dilation-2 windows every window's width over
    the map padded by one more window (DTransformer.py's F.unfold)."""
    wh, ww = win
    hp, wp = h + (wh - h % wh) % wh, w + (ww - w % ww) % ww
    if not dilate:
        return (hp // wh) * (wp // ww)
    return ((hp + wh - 2 * (wh - 1) - 1) // wh + 1) * ((wp + ww - 2 * (ww - 1) - 1) // ww + 1)
