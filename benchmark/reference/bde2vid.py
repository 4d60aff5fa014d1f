"""Plain PyTorch reference of BDE2VID (BDE2VIDCrossscalePropogationV5) in
evaluation mode, the model the benchmark's flagship cells run.

Written from the published model (gaopinghai/BDE2VID,
model/BDE2VID/bde2vid_cross_scale_propogation_V5.py and DTransformer.py):
a 5x5 head conv; per level a forward and a backward ConvLSTM encoder sweep
(a stride-2 conv, then the cell over time) whose outputs are summed; at a
level with attention, every frame t is replaced by itself plus a stack of
Swin blocks over the buffer ``t + buffer_index`` (zeros out of range; the
past frames already updated, the future ones not), odd blocks on
dilation-2 windows; bilinear-upsampling decoders over summed skips, the
last level's feature taken twice; a 1x1 prediction over the head's
features and a sigmoid.

Everything is unfused f32 PyTorch: convolutions, ``F.unfold`` / ``F.fold``
for the dilated windows as the published code does, and the attention as
explicit q k^T, softmax and v products over blocks of windows. Weights are
a flat dict under the checkpoint's names (``generator.*``); ``param_shapes``
lists them. The reference imports nothing of the program under test.

Covered configuration: sum skips, no norm, ConvLSTM cells, a last level
with attention, ReLU / GELU, sigmoid output. Anything else raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# windows of one attention batch, so that the (windows, heads, M, N) scores fit
WINDOW_BATCH = 512


def _gen(cfg: Dict) -> Dict:
    g = dict(cfg.get("generator", cfg))
    unsupported = {k: g[k] for k in ("norm", "skip_type", "recurrent_block_type", "parallel_attention",
                                     "nwindow_size", "q_idx") if g.get(k) not in (None, "sum", "convlstm", False)}
    if unsupported:
        raise NotImplementedError(f"the reference covers no {unsupported}")
    if g.get("activation", {"type": "Sigmoid"}).get("type") != "Sigmoid":
        raise NotImplementedError("the reference covers a sigmoid output only")
    depths = list(g.get("depths", (4, 0, 6)))
    if depths[g["num_encoders"] - 1] == 0:
        raise NotImplementedError("the reference covers a last level with attention only")
    return g


def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every float tensor of the model's state dict."""
    g = _gen(cfg)
    base, enc, ks, bins = g["basechannels"], g["num_encoders"], g["ks"], g["num_bins"]
    heads, depths = g["num_heads"], list(g["depths"])
    wd, (wh, ww) = len(g["buffer_index"]), tuple(g["window_size"])
    ins = [base * 2 ** i for i in range(enc)]
    outs = [base * 2 ** (i + 1) for i in range(enc)]
    s = {"generator.head.conv2d.weight": (base, bins, ks, ks), "generator.head.conv2d.bias": (base,)}
    for side in ("forward_encoder", "backward_encoder"):
        for i, (ci, co) in enumerate(zip(ins, outs)):
            p = f"generator.{side}.{i}"
            s[f"{p}.conv.conv2d.weight"] = (co, ci, ks, ks)
            s[f"{p}.conv.conv2d.bias"] = (co,)
            s[f"{p}.recurrent_block.Gates.weight"] = (4 * co, 2 * co, 3, 3)
            s[f"{p}.recurrent_block.Gates.bias"] = (4 * co,)
    for i, co in enumerate(outs):  # in the checkpoint layout, never called
        s[f"generator.fusion_layers.{i}.weight"] = (co, 2 * co, 1, 1)
        s[f"generator.fusion_layers.{i}.bias"] = (co,)
    for lvl, c in enumerate(outs):
        for b in range(depths[lvl] if lvl < len(depths) else 0):
            p = f"generator.feat_attns.{lvl}.blocks.{b}"
            s[f"{p}.attn.relative_position_bias_table"] = ((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), heads)
            for n in ("norm_q", "norm_kv"):
                s[f"{p}.attn.{n}.weight"] = (c,)
                s[f"{p}.attn.{n}.bias"] = (c,)
            for n, rows in (("q", c), ("kv", 2 * c), ("proj", c)):
                s[f"{p}.attn.{n}.weight"] = (rows, c)
                s[f"{p}.attn.{n}.bias"] = (rows,)
            s[f"{p}.norm2.weight"] = (c,)
            s[f"{p}.norm2.bias"] = (c,)
            s[f"{p}.mlp.fc1.weight"] = (4 * c, c)
            s[f"{p}.mlp.fc1.bias"] = (4 * c,)
            s[f"{p}.mlp.fc2.weight"] = (c, 4 * c)
            s[f"{p}.mlp.fc2.bias"] = (c,)
    for i, (ci, co) in enumerate(zip(outs[::-1], ins[::-1])):
        s[f"generator.decoders.{i}.1.conv2d.weight"] = (co, ci, ks, ks)
        s[f"generator.decoders.{i}.1.conv2d.bias"] = (co,)
    s["generator.predI.1.weight"] = (1, base, 1, 1)
    s["generator.predI.1.bias"] = (1,)
    return s


def _conv(p, name, x, stride=1, pad=0):
    return F.conv2d(x, p[name + ".weight"], p[name + ".bias"], stride, pad)


def _lstm_sweep(p, pre: str, x: torch.Tensor, ks: int, reverse: bool) -> torch.Tensor:
    """(T, N, C, H, W) -> (T, N, C', H/2, W/2): ReLU(stride-2 conv), then the
    ConvLSTM cell (gates i, f, o, g from one 3x3 conv over [x, h]) stepping
    through time, backwards when ``reverse``."""
    t_len, n = x.shape[:2]
    y = torch.relu(_conv(p, pre + ".conv.conv2d", x.flatten(0, 1), 2, ks // 2)).unflatten(0, (t_len, n))
    h = c = torch.zeros_like(y[0])
    outs: List[torch.Tensor] = [None] * t_len
    for t in (reversed(range(t_len)) if reverse else range(t_len)):
        i, f, o, g = _conv(p, pre + ".recurrent_block.Gates", torch.cat([y[t], h], 1), 1, 1).chunk(4, 1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs[t] = h
    return torch.stack(outs)


def relative_position_index(wd: int, wh: int, ww: int, h: int, w: int) -> np.ndarray:
    """(wd h w, wd h w) index into the (2wd-1)(2wh-1)(2ww-1) bias table:
    offsets over the actual (h, w) window grid, strides of the configured
    (wh, ww) window (DTransformer.py, WindowAttention3D)."""
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(h), np.arange(w), indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + np.array([wd - 1, wh - 1, ww - 1])
    return rel[..., 0] * (2 * wh - 1) * (2 * ww - 1) + rel[..., 1] * (2 * ww - 1) + rel[..., 2]


def _layer_norm(p, name, x):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], 1e-5)


def _linear(p, name, x):
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def _window_attention(p, pre: str, tok: torch.Tensor, heads: int, q_ind: int,
                      bias: torch.Tensor) -> torch.Tensor:
    """(D, B_, M, C) window tokens -> (B_, M, C): q from frame ``q_ind``'s
    tokens, keys and values from all D frames' (frame-major), in batches of
    WINDOW_BATCH windows."""
    d, nwin, m, c = tok.shape
    hd = c // heads
    out = torch.empty(nwin, m, c, dtype=tok.dtype, device=tok.device)
    for s in range(0, nwin, WINDOW_BATCH):
        t = tok[:, s:s + WINDOW_BATCH]
        b = t.shape[1]
        q = _linear(p, pre + ".q", _layer_norm(p, pre + ".norm_q", t[q_ind]))
        kv = _layer_norm(p, pre + ".norm_kv", t.permute(1, 0, 2, 3).reshape(b, d * m, c))
        k, v = _linear(p, pre + ".kv", kv).chunk(2, -1)
        q = q.view(b, m, heads, hd).transpose(1, 2)
        k = k.reshape(b, d * m, heads, hd).transpose(1, 2)
        v = v.reshape(b, d * m, heads, hd).transpose(1, 2)
        a = torch.softmax((q * hd ** -0.5) @ k.transpose(-2, -1) + bias, dim=-1)
        out[s:s + b] = _linear(p, pre + ".proj", (a @ v).transpose(1, 2).reshape(b, m, c))
    return out


def _swin_block(p, pre: str, x: torch.Tensor, center: torch.Tensor, cfg: Dict, dilate: bool,
                m1: Optional[torch.Tensor] = None, m2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One SwinTransformerBlock3D: x (D, B, H, W, C) the buffer, ``center``
    (B, H, W, C) its live centre frame -> the new centre. ``m1``, ``m2``:
    the DropPath multipliers (B,) of the attention and the MLP branch."""
    d, b, h, w, c = x.shape
    heads, q_ind = cfg["num_heads"], d // 2
    cwh, cww = cfg["window_size"]
    wh, ww = min(h, cwh), min(w, cww)
    x = torch.cat([x[:q_ind], center[None], x[q_ind + 1:]])
    ph, pw = (wh - h % wh) % wh, (ww - w % ww) % ww
    pt, pl = ph // 2, pw // 2
    xp = F.pad(x, (0, 0, pl, pw - pl, pt, ph - pt))
    hp, wp = h + ph, w + pw
    if dilate:  # F.unfold / F.fold with dilation 2 over the map padded by a window
        z = F.pad(xp.permute(0, 1, 4, 2, 3).reshape(d * b, c, hp, wp), (0, ww, 0, wh))
        cols = F.unfold(z, (wh, ww), dilation=2, stride=(wh, ww))
        nl = cols.shape[-1]
        tok = cols.view(d, b, c, wh * ww, nl).permute(0, 1, 4, 3, 2).reshape(d, b * nl, wh * ww, c)
    else:
        tok = xp.view(d, b, hp // wh, wh, wp // ww, ww, c).permute(0, 1, 2, 4, 3, 5, 6)
        tok = tok.reshape(d, -1, wh * ww, c)
    m = wh * ww
    idx = relative_position_index(d, cwh, cww, wh, ww)[q_ind * m:(q_ind + 1) * m]
    table = p[pre + ".attn.relative_position_bias_table"]
    bias = table[torch.as_tensor(idx.reshape(-1), device=table.device)].view(m, d * m, heads).permute(2, 0, 1)
    out = _window_attention(p, pre + ".attn", tok, heads, q_ind, bias)
    if dilate:
        cols = out.view(b, -1, m, c).permute(0, 3, 2, 1).reshape(b, c * m, -1)
        y = F.fold(cols, (hp + wh, wp + ww), (wh, ww), dilation=2, stride=(wh, ww))
        y = y[:, :, :hp, :wp].permute(0, 2, 3, 1)
    else:
        y = out.view(b, hp // wh, wp // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    y = y[:, pt:pt + h, pl:pl + w]
    y = center + (y if m1 is None else m1.view(-1, 1, 1, 1) * y)
    mlp = _linear(p, pre + ".mlp.fc2", F.gelu(_linear(p, pre + ".mlp.fc1", _layer_norm(p, pre + ".norm2", y))))
    return y + (mlp if m2 is None else m2.view(-1, 1, 1, 1) * mlp)


def _attend(p, lvl: int, merged: torch.Tensor, cfg: Dict, masks: Optional[Dict] = None,
            recompute: bool = False) -> torch.Tensor:
    """Frame t += the block stack over its buffer, t in order (V5:151-169).
    ``masks[(lvl, t, block)]``: DropPath multipliers; ``recompute``: each
    block's activations are recomputed in the backward (memory only)."""
    seq = list(merged.permute(0, 1, 3, 4, 2).unbind(0))  # T x (N, H, W, C)
    t_len, offsets = len(seq), list(cfg["buffer_index"])
    zero = torch.zeros_like(seq[0])
    for t in range(t_len):
        x = torch.stack([seq[t + o] if 0 <= t + o < t_len else zero for o in offsets])
        center = x[len(offsets) // 2]
        for blk in range(cfg["depths"][lvl]):
            args = (p, f"generator.feat_attns.{lvl}.blocks.{blk}", x, center, cfg, blk % 2 == 1,
                    *(masks or {}).get((lvl, t, blk), (None, None)))
            center = checkpoint(_swin_block, *args, use_reentrant=False) if recompute else _swin_block(*args)
        seq[t] = center + seq[t]
    return torch.stack(seq).permute(0, 1, 4, 2, 3)


def drop_path_masks(cfg: Dict, t_len: int, n: int, generator: torch.Generator, device) -> Dict:
    """The DropPath multipliers of a training forward, drawn in the model's
    order: levels, then frames, then blocks; two (n,) draws (attention,
    then MLP branch) for each block of a rate above 0, the rates
    ``linspace(0, drop_path_rate, depth)`` per level, each in {0, 1/keep}."""
    g = _gen(cfg)
    rate, out = float(g.get("drop_path_rate", 0.2)), {}
    for lvl, depth in enumerate(g["depths"]):
        rates = np.linspace(0, rate, depth).tolist() if depth else []
        for t in range(t_len):
            for blk, r in enumerate(rates):
                if r > 0:
                    keep = 1.0 - r
                    probs = torch.full((n,), keep, device=device)
                    out[(lvl, t, blk)] = tuple(torch.bernoulli(probs, generator=generator) / keep
                                               for _ in range(2))
    return out


def forward(p: Dict[str, torch.Tensor], cfg: Dict, voxels: torch.Tensor, masks: Optional[Dict] = None,
            recompute: bool = False) -> torch.Tensor:
    """voxels (T, N, bins, H, W), H and W multiples of 2^num_encoders ->
    images (T, N, 1, H, W). In training, ``masks`` are the DropPath
    multipliers of ``drop_path_masks``."""
    g = _gen(cfg)
    t_len, n = voxels.shape[:2]
    enc, ks = g["num_encoders"], g["ks"]
    if voxels.shape[-2] % 2 ** enc or voxels.shape[-1] % 2 ** enc:
        raise ValueError(f"sensor {tuple(voxels.shape[-2:])} is no multiple of {2 ** enc}")
    head = torch.relu(_conv(p, "generator.head.conv2d", voxels.flatten(0, 1), 1, ks // 2))
    target = head.unflatten(0, (t_len, n))
    feats = []
    depths = list(g["depths"])
    for lvl in range(enc):
        merged = (_lstm_sweep(p, f"generator.forward_encoder.{lvl}", target, ks, False)
                  + _lstm_sweep(p, f"generator.backward_encoder.{lvl}", target, ks, True))
        if lvl < len(depths) and depths[lvl] > 0:
            merged = _attend(p, lvl, merged, g, masks, recompute)
        target = merged
        feats.append(merged.flatten(0, 1))
    feats.append(feats[-1])  # the reference's aliased list: the last level twice
    x = feats[-1]
    for i in range(enc):
        up = F.interpolate(feats[-2 - i] + x, scale_factor=2, mode="bilinear", align_corners=False)
        x = F.relu6(_conv(p, f"generator.decoders.{i}.1.conv2d", up, 1, ks // 2))
    img = torch.sigmoid(_conv(p, "generator.predI.1", x + head))
    return img.unflatten(0, (t_len, n))


class Runner:
    """Runs the reference chunk by chunk over a sequence: every chunk from
    fresh recurrent state, as the eval driver runs a sequence model."""

    carries_state = False

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict):
        self.params, self.cfg = params, cfg

    def chunk(self, voxels: torch.Tensor) -> torch.Tensor:
        """(L, bins, H, W) -> (L, H, W)."""
        return forward(self.params, self.cfg, voxels[:, None])[:, 0, 0]

    def reset(self) -> None:
        pass
