"""BDE2VID — the flagship bidirectional sequence model (counterpart of
``bde2vid_tpu/models/bde2vid.py``; reference model/BDE2VID/bde2vid.py:12-50
and bde2vid_cross_scale_propogation_V5.py:17-241). Trains and evaluates: in
training mode the attention blocks apply DropPath (``drop_path_rate``,
per-block ``linspace(0, rate, depth)``) with masks from a ``torch.Generator``
passed to ``forward``; evaluation runs the model under ``torch.no_grad`` in
the eval driver.

The config surface is the JAX package's: ``skip_type`` sum or concat (a 1x1
conv after each concatenation), ``norm`` None, BN or IN in every ConvLayer
and after each decoder conv, ``recurrent_block_type`` convlstm or convgru,
and ``remat``: in training, each time step of the encoder sweeps, of the
sequential attention and of the depth-0 fallback is rematerialised
(``nn.remat.checkpoint_step``); at eval it is ignored, as in JAX. A
train-mode norm moves its running statistics once per call: the encoder
convs then run step by step in each sweep's order (as the JAX scans carry
them), the head and the decoder once over all T frames folded into the
batch. The compute type is the input's: bf16 voxels run the model in bf16
over f32 weights (bf16 training).

Per level L: a forward and a separate backward ConvLSTM encoder sweep the
sequence and their outputs are summed; if depths[L] > 0, DFrameAttention
over a buffer of ``t + buffer_index`` neighbour frames (zeros out of range)
is residual-added frame by frame, in place, so frame t attends to
already-updated past frames and original future frames; with
``parallel_attention`` every frame's buffer reads the original features
instead and all T frames go through the blocks as one batch (the JAX
package's ``_AttnParallel``, not the reference's semantics). A last level with
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
from bde2vid_tpu_torch.nn.layers import (
    Conv2d,
    ConvLayer,
    ResidualBlockNoBN,
    UpsampleConvLayer,
    get_activation,
)
from bde2vid_tpu_torch.nn.recurrent import make_recurrent_cell, recurrent_initial_state
from bde2vid_tpu_torch.nn.remat import checkpoint_step
from bde2vid_tpu_torch.nn.window_attention import DFrameAttention
from bde2vid_tpu_torch.parallel import spatial

# frames per batch of the parallel attention (JAX ``_AttnParallel``'s slab)
_PARALLEL_SLAB = 128


class RecurrentConv(nn.Module):
    """Strided ConvLayer + ConvLSTM or ConvGRU cell (reference RecurrentConv,
    model/BDE2VID/submodules.py:173-195): keys ``conv.conv2d.*``,
    ``conv.norm_layer.*`` and ``recurrent_block.Gates.*`` (LSTM) or
    ``recurrent_block.{update,reset,out}_gate.*`` (GRU)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 activation: str, use_recurrent: bool = True, norm: Optional[str] = None,
                 recurrent_block_type: str = "convlstm"):
        super().__init__()
        self.conv = ConvLayer(in_channels, out_channels, kernel_size, stride=2,
                              padding=kernel_size // 2, activation=activation, norm=norm)
        self.block_type = recurrent_block_type
        self.recurrent_block = (make_recurrent_cell(recurrent_block_type, out_channels, out_channels, 3)
                                if use_recurrent else None)

    def _cell(self, y: torch.Tensor, *state: torch.Tensor):
        """One step of the cell: (output, *new state), the state flat ((h, c)
        for the LSTM, (h,) for the GRU)."""
        out, new = self.recurrent_block(y, state if len(state) == 2 else state[0])
        return (out, *new) if isinstance(new, tuple) else (out, new)

    def _step(self, x: torch.Tensor, *state: torch.Tensor):
        return self._cell(self.conv(x), *state)

    def sweep(self, x: torch.Tensor, reverse: bool = False, remat: bool = False) -> torch.Tensor:
        """(T, N, C, H, W) -> (T, N, C', H', W'), the cell stepping through
        time (backwards when ``reverse``). Without a norm the strided conv has
        no state and runs on all T frames at once, before the cell's steps;
        with one it runs in each step, so a train-mode norm moves its
        statistics once per step in the sweep's order. ``remat``: each step
        (the cell, with the conv where it runs per step) is rematerialised
        in the backward."""
        t, n = x.shape[:2]
        order = reversed(range(t)) if reverse else range(t)
        if self.conv.norm_layer is None:
            y = self.conv(x.reshape(t * n, *x.shape[2:]))
            y = y.reshape(t, n, *y.shape[1:])
            if self.recurrent_block is None:
                return y
            step, inputs, (c, h, w) = self._cell, y, y.shape[2:]
        elif self.recurrent_block is None:
            outs = [None] * t
            for i in order:
                outs[i] = checkpoint_step(self.conv, x[i]) if remat else self.conv(x[i])
            return torch.stack(outs)
        else:
            conv = self.conv.conv2d
            (k, kw), (s, sw), (p, pw) = conv.kernel_size, conv.stride, conv.padding
            # row-sharded, the state is at this rank's band of the output
            h, w = spatial.output_rows(x.shape[3], k, s, p), (x.shape[4] + 2 * pw - kw) // sw + 1
            step, inputs, c = self._step, x, conv.out_channels
        state = recurrent_initial_state(self.block_type, n, h, w, c, dtype=x.dtype, device=x.device)
        state = state if isinstance(state, tuple) else (state,)
        outs = [None] * t
        for i in order:
            res = checkpoint_step(step, inputs[i], *state) if remat else step(inputs[i], *state)
            outs[i], state = res[0], res[1:]
        return torch.stack(outs)


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
                 num_res_blocks: int = 2, norm: Optional[str] = None,
                 recurrent_block_type: str = "convlstm", useRC: bool = True,
                 skip_type: str = "sum", out_activation: str = "sigmoid",
                 num_output_channels: int = 1, act_net: str = "default",
                 buffer_index: Sequence[int] = (-3, -2, -1, 0, 1, 2, 3), q_idx: Optional[int] = None,
                 window_size: Tuple[int, int] = (7, 7), depths: Sequence[int] = (4, 0, 6),
                 num_heads: int = 16, act_attn: str = "default", use_kernel: bool = False,
                 drop_path_rate: float = 0.2, parallel_attention: bool = False,
                 nwindow_size: Optional[Tuple[int, int]] = None, remat: bool = False):
        super().__init__()
        act = "relu" if act_net == "default" else act_net
        act_attn = "gelu" if act_attn == "default" else act_attn
        self.num_encoders = num_encoders
        self.buffer_index = tuple(int(i) for i in buffer_index)
        self.parallel_attention = parallel_attention
        self.concat = skip_type == "concat"
        self.remat = remat
        self.out_activation = get_activation(out_activation)
        ins = [basechannels * 2**i for i in range(num_encoders)]
        outs = [basechannels * 2 ** (i + 1) for i in range(num_encoders)]

        self.head = ConvLayer(num_bins, basechannels, ks, 1, ks // 2, activation=act, norm=norm)
        self.forward_encoder = nn.ModuleList(
            RecurrentConv(i, o, ks, act, useRC, norm, recurrent_block_type) for i, o in zip(ins, outs))
        self.backward_encoder = nn.ModuleList(
            RecurrentConv(i, o, ks, act, useRC, norm, recurrent_block_type) for i, o in zip(ins, outs))
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
                                             drop_path=dpr, nwindow_size=nwindow_size))
            elif lvl == num_encoders - 1:
                attns.append(res_fallback(ch, num_res_blocks))
            else:
                attns.append(None)
        self.feat_attns = nn.ModuleList(attns)
        # with concat skips, slot 0 of each decoder and of predI is a 1x1 conv
        # over the concatenation (JAX decoder{i}0, predI0); with sums it is empty
        self.decoders = nn.ModuleList(
            nn.Sequential(Conv2d(2 * ci, ci, 1) if self.concat else nn.Identity(),
                          UpsampleConvLayer(ci, co, ks, ks // 2, activation="relu6", norm=norm))
            for ci, co in zip(outs[::-1], ins[::-1])
        )
        self.predI = nn.Sequential(
            Conv2d(2 * basechannels, basechannels, 1) if self.concat else nn.Identity(),
            Conv2d(basechannels, num_output_channels, 1))

    def _neighbours(self, merged, t: int) -> list:
        """The D frames t + buffer_index, zeros out of range."""
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
        return frames

    def _remat(self) -> bool:
        return self.remat and self.training and torch.is_grad_enabled()

    def _attend(self, attn: DFrameAttention, merged: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """Sequential attention over t (reference V5:151-169): frame t
        attends to already-updated past frames and original future frames.
        The frames live in a list, not in one tensor written in place:
        autograd refuses an in-place write to a tensor it saved. With remat
        each step is rematerialised, its DropPath masks drawn again from
        ``generator``'s state at the step."""

        def step(*frames):
            return attn(torch.stack(frames[:-1]), generator) + frames[-1]

        seq = list(merged.permute(0, 1, 3, 4, 2).unbind(0))  # T x (N, H, W, C) tokens
        for t in range(len(seq)):
            args = (*self._neighbours(seq, t), seq[t])
            seq[t] = checkpoint_step(step, *args, generator=generator) if self._remat() else step(*args)
        return torch.stack(seq).permute(0, 1, 4, 2, 3)

    def _attend_parallel(self, attn: DFrameAttention, merged: torch.Tensor,
                         generator: Optional[torch.Generator]) -> torch.Tensor:
        """Every frame's buffer reads the original features, so up to
        ``_PARALLEL_SLAB`` frames go through the blocks as one batch, sample-major
        (JAX ``_AttnParallel``); DropPath draws one mask per (sample, frame)
        row. Residual-added to ``merged``."""
        T, N, C, H, W = merged.shape
        tok = merged.permute(0, 1, 3, 4, 2)
        # row 0 is the zero frame out-of-range neighbours read
        padded = torch.cat([torch.zeros_like(tok[:1]), tok])
        outs = []
        for s0 in range(0, T, _PARALLEL_SLAB):
            s1 = min(s0 + _PARALLEL_SLAB, T)
            offs = np.arange(s0, s1)[:, None] + np.asarray(self.buffer_index)[None]  # (S, D)
            rows = np.where((offs >= 0) & (offs < T), offs + 1, 0)
            buf = padded[torch.as_tensor(rows, device=merged.device)]  # (S, D, N, H, W, C)
            x = buf.permute(1, 2, 0, 3, 4, 5).reshape(len(self.buffer_index), N * (s1 - s0), H, W, C)
            outs.append(attn(x, generator).reshape(N, s1 - s0, H, W, C).transpose(0, 1))
        return merged + torch.cat(outs).permute(0, 1, 4, 2, 3)

    def _res_fallback(self, res: nn.Sequential, merged: torch.Tensor) -> torch.Tensor:
        # a list of frames, as in _attend: the convs save the frames they read

        def step(x, cur):
            return res[1:](x) + cur

        seq = list(merged.unbind(0))
        off = self.buffer_index[0]
        for t in range(len(seq)):
            i = t + off
            x = seq[i] if 0 <= i < len(seq) else torch.zeros_like(seq[t])
            seq[t] = checkpoint_step(step, x, seq[t]) if self._remat() else step(x, seq[t])
        return torch.stack(seq)

    def forward(self, voxels: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        T, N = voxels.shape[:2]
        head = self.head(voxels.reshape(T * N, *voxels.shape[2:]))
        target = head.reshape(T, N, *head.shape[1:])
        feats = []
        remat = self._remat()
        for lvl in range(self.num_encoders):
            merged = (self.forward_encoder[lvl].sweep(target, remat=remat)
                      + self.backward_encoder[lvl].sweep(target, reverse=True, remat=remat))
            block = self.feat_attns[lvl]
            if isinstance(block, DFrameAttention) and self.parallel_attention:
                merged = self._attend_parallel(block, merged, generator)
            elif isinstance(block, DFrameAttention):
                merged = self._attend(block, merged, generator)
            elif block is not None:
                merged = self._res_fallback(block, merged)
            target = merged
            if lvl == self.num_encoders - 1:
                feats.append(merged)  # aliased-list quirk: the last level twice
            feats.append(merged)

        fold = [f.reshape(T * N, *f.shape[2:]) for f in feats]
        x = fold[-1]
        for i, (fuse, up) in enumerate(self.decoders):
            prev = fold[-2 - i]
            x = up(fuse(torch.cat([prev, x], 1)) if self.concat else prev + x)
        fuse, pred = self.predI
        img = self.out_activation(pred(fuse(torch.cat([x, head], 1)) if self.concat else x + head))
        return img.reshape(T, N, *img.shape[1:])


@register_model("BDE2VID")
class BDE2VID(nn.Module):
    """mmengine-registered wrapper (reference bde2vid.py:12-50): takes the
    checkpoint's model config, holds ``generator``, and maps voxels
    (T, N, B, H, W) to ``{"image": (T, N, 1, H, W)}``. Recurrent state lives
    inside one call, as in the reference (state resets every forward).
    ``forward`` runs with whatever grad mode the caller set; in training
    mode (``.train()``) a ``torch.Generator`` draws the DropPath masks. The
    output is in the voxels' type."""

    is_sequence_model = True

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
            # the reference's no_skip calls its Identity with two arguments
            # (a TypeError upstream), so no checkpoint uses it; JAX refuses it too
            raise ValueError(f"unsupported skip_type {skip_type!r}")
        # scan_unroll and pallas_f32_exact tune the TPU program only: the
        # port's f32 kernel always computes exact f32 products
        self.generator = BDE2VIDGenerator(
            num_bins=gcfg.get("num_bins", 5),
            basechannels=gcfg.get("basechannels", 32),
            num_encoders=gcfg.get("num_encoders", 3),
            ks=gcfg.get("ks", 5),
            num_res_blocks=gcfg.get("num_res_blocks", 2),
            norm=gcfg.get("norm", None),
            recurrent_block_type=gcfg.get("recurrent_block_type", "convlstm"),
            useRC=gcfg.get("useRC", True),
            skip_type=skip_type,
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
            parallel_attention=flag("parallel_attention"),
            nwindow_size=tuple(gcfg["nwindow_size"]) if gcfg.get("nwindow_size") else None,
            remat=flag("remat"),
        )

    def forward(self, voxels: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        return {"image": self.generator(voxels, generator)}
