"""BDE2VID — the flagship bidirectional sequence model (counterpart of
``bde2vid_tpu/models/bde2vid.py``; reference model/BDE2VID/bde2vid.py:12-50
and bde2vid_cross_scale_propogation_V5.py:17-241). Trains and evaluates: in
training mode the attention blocks apply DropPath (``drop_path_rate``,
per-block ``linspace(0, rate, depth)``) with masks from a ``torch.Generator``
passed to ``forward``; evaluation runs the model under ``torch.no_grad`` in
the eval driver.

Per level L: a forward and a separate backward ConvLSTM encoder sweep the
sequence and their outputs are summed; if depths[L] > 0, DFrameAttention
over a buffer of ``t + buffer_index`` neighbour frames (zeros out of range)
is residual-added frame by frame, in place, so frame t attends to
already-updated past frames and original future frames. A last level with
depth 0 uses norm-free residual blocks instead. The decoder runs with T
folded into the batch; the last level's skip is the post-attention feature
twice (the reference's aliased-list quirk, V5:149-150).

Tensors are NCHW; sequences are (T, N, C, H, W).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from bde2vid_tpu_torch.models.api import register_model
from bde2vid_tpu_torch.nn.layers import ConvLayer, ResidualBlockNoBN, UpsampleConvLayer, get_activation
from bde2vid_tpu_torch.nn.recurrent import ConvLSTMCell, recurrent_initial_state
from bde2vid_tpu_torch.nn.window_attention import DFrameAttention


class RecurrentConv(nn.Module):
    """Strided ConvLayer + ConvLSTM cell (reference RecurrentConv,
    model/BDE2VID/submodules.py:173-195): keys ``conv.conv2d.*`` and
    ``recurrent_block.Gates.*``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 activation: str, use_recurrent: bool = True):
        super().__init__()
        self.conv = ConvLayer(in_channels, out_channels, kernel_size, stride=2,
                              padding=kernel_size // 2, activation=activation)
        self.recurrent_block = ConvLSTMCell(out_channels, out_channels, 3) if use_recurrent else None

    def sweep(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        """(T, N, C, H, W) -> (T, N, C', H', W'). The strided conv has no
        state, so it runs on all T frames at once; the cell then steps
        through time (backwards when ``reverse``)."""
        t, n = x.shape[:2]
        y = self.conv(x.reshape(t * n, *x.shape[2:]))
        y = y.reshape(t, n, *y.shape[1:])
        if self.recurrent_block is None:
            return y
        state = recurrent_initial_state("convlstm", n, y.shape[3], y.shape[4], y.shape[2],
                                        dtype=y.dtype, device=y.device)
        out = torch.empty_like(y)
        # writing out[i] in place is safe under autograd: no op saves ``out``
        for i in (reversed(range(t)) if reverse else range(t)):
            out[i], state = self.recurrent_block(y[i], state)
        return out


class _TakeFirst(nn.Module):
    """The reference ParseLayer slot (parameterless); picking the buffer
    frame happens in ``BDE2VIDGenerator._res_fallback``."""

    def forward(self, x):
        return x


def res_fallback(features: int, num_res_blocks: int) -> nn.Sequential:
    """Last-level stand-in when its depth is 0 (reference V5:82-85): buffer
    frame ``buffer_index[0]`` through norm-free resblocks, residual-added.
    Keys ``feat_attns.L.{1..n}.conv{1,2}.*`` like the reference Sequential."""
    return nn.Sequential(_TakeFirst(), *[ResidualBlockNoBN(features) for _ in range(num_res_blocks)])


class BDE2VIDGenerator(nn.Module):
    """BDE2VIDCrossscalePropogationV5. Input voxels (T, N, B, H, W) ->
    images (T, N, num_output_channels, H, W)."""

    def __init__(self, num_bins: int = 5, basechannels: int = 32, num_encoders: int = 3, ks: int = 5,
                 num_res_blocks: int = 2, useRC: bool = True, out_activation: str = "sigmoid",
                 num_output_channels: int = 1, act_net: str = "default",
                 buffer_index: Sequence[int] = (-3, -2, -1, 0, 1, 2, 3), q_idx: Optional[int] = None,
                 window_size: Tuple[int, int] = (7, 7), depths: Sequence[int] = (4, 0, 6),
                 num_heads: int = 16, act_attn: str = "default", use_kernel: bool = False,
                 drop_path_rate: float = 0.2):
        super().__init__()
        act = "relu" if act_net == "default" else act_net
        act_attn = "gelu" if act_attn == "default" else act_attn
        self.num_encoders = num_encoders
        self.buffer_index = tuple(int(i) for i in buffer_index)
        self.out_activation = get_activation(out_activation)
        ins = [basechannels * 2**i for i in range(num_encoders)]
        outs = [basechannels * 2 ** (i + 1) for i in range(num_encoders)]

        self.head = ConvLayer(num_bins, basechannels, ks, 1, ks // 2, activation=act)
        self.forward_encoder = nn.ModuleList(
            RecurrentConv(i, o, ks, act, useRC) for i, o in zip(ins, outs))
        self.backward_encoder = nn.ModuleList(
            RecurrentConv(i, o, ks, act, useRC) for i, o in zip(ins, outs))
        # constructed but never called by the reference forward (V5:55-60);
        # kept so reference checkpoints load without a converter
        self.fusion_layers = nn.ModuleList(nn.Conv2d(2 * o, o, 1) for o in outs)
        wsz = (len(self.buffer_index), *window_size)
        attns = []
        for lvl, ch in enumerate(outs):
            depth = depths[lvl] if lvl < len(depths) else 0
            if depth > 0:
                dpr = tuple(np.linspace(0, drop_path_rate, depth).tolist())
                attns.append(DFrameAttention(ch, depth, num_heads, wsz, q_ind=q_idx,
                                             activation=act_attn, use_kernel=use_kernel,
                                             drop_path=dpr))
            elif lvl == num_encoders - 1:
                attns.append(res_fallback(ch, num_res_blocks))
            else:
                attns.append(None)
        self.feat_attns = nn.ModuleList(attns)
        self.decoders = nn.ModuleList(
            nn.Sequential(nn.Identity(), UpsampleConvLayer(ci, co, ks, ks // 2, activation="relu6"))
            for ci, co in zip(outs[::-1], ins[::-1])
        )
        self.predI = nn.Sequential(nn.Identity(), nn.Conv2d(basechannels, num_output_channels, 1))

    def _neighbours(self, merged, t: int) -> torch.Tensor:
        """(D, ...) buffer of frames t + buffer_index, zeros out of range."""
        T = len(merged)
        zero = None
        frames = []
        for off in self.buffer_index:
            i = t + off
            if 0 <= i < T:
                frames.append(merged[i])
            else:
                zero = torch.zeros_like(merged[0]) if zero is None else zero
                frames.append(zero)
        return torch.stack(frames)

    def _attend(self, attn: DFrameAttention, merged: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """Sequential attention over t (reference V5:151-169): frame t
        attends to already-updated past frames and original future frames.
        The frames live in a list, not in one tensor written in place:
        autograd refuses an in-place write to a tensor it saved."""
        seq = list(merged.permute(0, 1, 3, 4, 2).unbind(0))  # T x (N, H, W, C) tokens
        for t in range(len(seq)):
            seq[t] = attn(self._neighbours(seq, t), generator) + seq[t]
        return torch.stack(seq).permute(0, 1, 4, 2, 3)

    def _res_fallback(self, res: nn.Sequential, merged: torch.Tensor) -> torch.Tensor:
        # a list of frames, as in _attend: the convs save the frames they read
        seq = list(merged.unbind(0))
        off = self.buffer_index[0]
        for t in range(len(seq)):
            i = t + off
            x = seq[i] if 0 <= i < len(seq) else torch.zeros_like(seq[t])
            seq[t] = res[1:](x) + seq[t]
        return torch.stack(seq)

    def forward(self, voxels: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        T, N = voxels.shape[:2]
        head = self.head(voxels.reshape(T * N, *voxels.shape[2:]))
        target = head.reshape(T, N, *head.shape[1:])
        feats = []
        for lvl in range(self.num_encoders):
            merged = (self.forward_encoder[lvl].sweep(target)
                      + self.backward_encoder[lvl].sweep(target, reverse=True))
            block = self.feat_attns[lvl]
            if isinstance(block, DFrameAttention):
                merged = self._attend(block, merged, generator)
            elif block is not None:
                merged = self._res_fallback(block, merged)
            target = merged
            if lvl == self.num_encoders - 1:
                feats.append(merged)  # aliased-list quirk: the last level twice
            feats.append(merged)

        fold = [f.reshape(T * N, *f.shape[2:]) for f in feats]
        x = fold[-1]
        for i, dec in enumerate(self.decoders):
            x = dec(fold[-2 - i] + x)
        img = self.out_activation(self.predI(x + head))
        return img.reshape(T, N, *img.shape[1:])


_UNPORTED_TRUE = ("parallel_attention", "remat")


@register_model("BDE2VID")
class BDE2VID(nn.Module):
    """mmengine-registered wrapper (reference bde2vid.py:12-50): takes the
    checkpoint's model config, holds ``generator``, and maps voxels
    (T, N, B, H, W) to ``{"image": (T, N, 1, H, W)}``. Recurrent state lives
    inside one call, as in the reference (state resets every forward).
    ``forward`` runs with whatever grad mode the caller set; in training
    mode (``.train()``) a ``torch.Generator`` draws the DropPath masks."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = dict(config)
        gcfg = dict(self.config.get("generator", self.config))
        gcfg.pop("type", None)
        act = gcfg.pop("activation", None)
        out_act = "sigmoid"
        if isinstance(act, dict):
            out_act = {"Sigmoid": "sigmoid", "Identity": "identity", "LReLU": "lrelu"}[
                act.get("type", "Sigmoid")
            ]

        def flag(key, default=False):
            return bool(self.config.get(key, gcfg.get(key, default)))

        skip_type = gcfg.get("skip_type", "sum")
        if skip_type not in ("sum", "concat"):
            raise ValueError(f"unsupported skip_type {skip_type!r}")
        if skip_type == "concat":
            raise NotImplementedError("skip_type='concat' is not ported yet")
        for key in _UNPORTED_TRUE:
            if flag(key):
                raise NotImplementedError(f"{key}=True is not ported yet")
        if gcfg.get("norm") is not None:
            raise NotImplementedError(f"norm={gcfg['norm']!r} is not ported yet (norm=None only)")
        if gcfg.get("nwindow_size"):
            raise NotImplementedError("nwindow_size (KV token reduction) is not ported yet")
        if gcfg.get("recurrent_block_type", "convlstm") != "convlstm":
            raise NotImplementedError("only recurrent_block_type='convlstm' is ported")
        # scan_unroll and pallas_f32_exact tune the TPU program only: the
        # port's f32 kernel always computes exact f32 products
        self.generator = BDE2VIDGenerator(
            num_bins=gcfg.get("num_bins", 5),
            basechannels=gcfg.get("basechannels", 32),
            num_encoders=gcfg.get("num_encoders", 3),
            ks=gcfg.get("ks", 5),
            num_res_blocks=gcfg.get("num_res_blocks", 2),
            useRC=gcfg.get("useRC", True),
            out_activation=out_act,
            num_output_channels=gcfg.get("num_output_channels", 1),
            act_net=gcfg.get("act_net", "default"),
            buffer_index=tuple(gcfg.get("buffer_index", (-3, -2, -1, 0, 1, 2, 3))),
            q_idx=gcfg.get("q_idx", None),
            window_size=tuple(gcfg.get("window_size", (7, 7))),
            depths=tuple(gcfg.get("depths", (4, 0, 6))),
            num_heads=gcfg.get("num_heads", 16),
            act_attn=gcfg.get("act_attn", "default"),
            use_kernel=flag("use_pallas_attention"),
            drop_path_rate=float(gcfg.get("drop_path_rate", 0.2)),
        )

    def forward(self, voxels: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        return {"image": self.generator(voxels, generator)}
