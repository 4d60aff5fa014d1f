"""The UNet backbones of the E2VID family (counterpart of
``bde2vid_tpu/models/unet.py``; reference model/e2vid/unet.py).

- ``UNet``: head, stride-2 encoders, residual blocks, decoders, 1x1 pred;
- ``UNetRecurrent``: a ConvLSTM or ConvGRU cell after every encoder;
- ``UNetFire``: a recurrent head and residual blocks (some of them
  recurrent) at full resolution, a 1x1 pred with no norm and no activation;
- ``UNetFlow``: ``UNetRecurrent`` with 3 output channels and no activation,
  its head and encoders of the configurable ``kernel_size``.

NCHW tensors and the reference state-dict names (``head``, ``encoders.N``,
``resblocks.N``, ``decoders.N``, ``pred``). The state is explicit: a tuple
with one entry per recurrent unit, made by ``initial_state``. With
``skip_type`` concat a decoder takes twice the channels of its sum-skip
input and ``pred`` twice the base.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from bde2vid_tpu_torch.nn.layers import (
    ConvLayer,
    ResidualBlock,
    TransposedConvLayer,
    UpsampleConvLayer,
    get_activation,
    skip_concat,
    skip_sum,
)
from bde2vid_tpu_torch.nn.recurrent import RecurrentConvLayer, RecurrentResidualLayer


def _skip(skip_type: Optional[str]) -> Tuple[Callable, int]:
    """(skip function, channel factor of its output)."""
    if skip_type == "sum":
        return skip_sum, 1
    if skip_type == "concat":
        return skip_concat, 2
    if skip_type in (None, "no_skip"):
        return (lambda x1, x2: x1), 1
    raise KeyError(f"unknown skip_type {skip_type!r}")


class _UNetBase(nn.Module):
    """What the encoder-decoder UNets share (reference BaseUNet): the
    residual blocks at the widest level, the decoders (kernel 5, each
    halving the channels) and ``pred``."""

    def __init__(self, num_bins: int = 5, num_output_channels: int = 1, skip_type: str = "sum",
                 activation: Optional[str] = "sigmoid", num_encoders: int = 4,
                 base_num_channels: int = 32, num_residual_blocks: int = 2,
                 norm: Optional[str] = None, use_upsample_conv: bool = True):
        super().__init__()
        self.num_bins, self.base_num_channels, self.norm = num_bins, base_num_channels, norm
        self.num_encoders = num_encoders
        self.apply_skip, factor = _skip(skip_type)
        self.activation = get_activation(activation)
        base = base_num_channels
        self.encoder_input_sizes = [base * 2**i for i in range(num_encoders)]
        self.encoder_output_sizes = [base * 2 ** (i + 1) for i in range(num_encoders)]
        top = base * 2**num_encoders
        self.resblocks = nn.ModuleList(ResidualBlock(top, top, norm=norm)
                                       for _ in range(num_residual_blocks))
        up = UpsampleConvLayer if use_upsample_conv else TransposedConvLayer
        self.decoders = nn.ModuleList(up(factor * s, s // 2, 5, padding=2, norm=norm)
                                      for s in reversed(self.encoder_output_sizes))
        self.pred = ConvLayer(factor * base, num_output_channels, 1, activation=None, norm=norm)

    def _decode(self, x: torch.Tensor, head: torch.Tensor, blocks: Sequence[torch.Tensor]):
        for rb in self.resblocks:
            x = rb(x)
        for i, dec in enumerate(self.decoders):
            x = dec(self.apply_skip(x, blocks[self.num_encoders - i - 1]))
        return self.activation(self.pred(self.apply_skip(x, head)))


class UNet(_UNetBase):
    """The non-recurrent UNet; head and encoders of kernel 5."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.head = ConvLayer(self.num_bins, self.base_num_channels, 5, padding=2)
        self.encoders = nn.ModuleList(
            ConvLayer(i, o, 5, stride=2, padding=2, norm=self.norm)
            for i, o in zip(self.encoder_input_sizes, self.encoder_output_sizes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = head = self.head(x)
        blocks = []
        for enc in self.encoders:
            x = enc(x)
            blocks.append(x)
        return self._decode(x, head, blocks)


class UNetRecurrent(_UNetBase):
    """A recurrent cell after every encoder. The head and encoders take
    kernel ``enc_kernel``: 5 here, as the reference hard-codes it."""

    def __init__(self, recurrent_block_type: str = "convlstm", enc_kernel: int = 5, **kw):
        super().__init__(**kw)
        k = enc_kernel
        self.head = ConvLayer(self.num_bins, self.base_num_channels, k, padding=k // 2)
        self.encoders = nn.ModuleList(
            RecurrentConvLayer(i, o, k, stride=2, padding=k // 2,
                               recurrent_block_type=recurrent_block_type, norm=self.norm)
            for i, o in zip(self.encoder_input_sizes, self.encoder_output_sizes))

    def forward(self, x: torch.Tensor, states: Sequence) -> Tuple[torch.Tensor, Tuple]:
        x = head = self.head(x)
        blocks, new_states = [], []
        for enc, st in zip(self.encoders, states):
            x, st = enc(x, st)
            blocks.append(x)
            new_states.append(st)
        return self._decode(x, head, blocks), tuple(new_states)

    def initial_state(self, batch: int, height: int, width: int, dtype=torch.float32,
                      device=None) -> Tuple:
        states: List = []
        for enc in self.encoders:
            states.append(enc.initial_state(batch, height, width, dtype, device))
            height, width = enc.out_size(height, width)
        return tuple(states)


class UNetFlow(UNetRecurrent):
    """UNetRecurrent with 3 output channels and no activation: channel 0 is
    the image, channels 1-2 the flow. Head and encoders take the
    configurable ``kernel_size``."""

    def __init__(self, kernel_size: int = 5, **kw):
        kw.setdefault("num_output_channels", 3)
        kw.setdefault("activation", None)
        super().__init__(enc_kernel=kernel_size, **kw)


class UNetFire(nn.Module):
    """FireNetOrg's backbone (reference UNetFire): a recurrent ``head``,
    ``num_residual_blocks`` residual blocks of which those listed in
    ``recurrent_blocks`` carry a cell (-1 means all), and a 1x1 ``pred``
    with no norm and no activation; no up- or downsampling."""

    def __init__(self, num_bins: int = 5, num_output_channels: int = 1,
                 recurrent_block_type: str = "convgru", base_num_channels: int = 16,
                 num_residual_blocks: int = 2, norm: Optional[str] = None,
                 kernel_size: int = 3, recurrent_blocks: Sequence[int] = (0,)):
        super().__init__()
        c, k = base_num_channels, kernel_size
        self.head = RecurrentConvLayer(num_bins, c, k, padding=k // 2,
                                       recurrent_block_type=recurrent_block_type, norm=norm)
        rec = set(recurrent_blocks)
        self.resblocks = nn.ModuleList(
            RecurrentResidualLayer(c, recurrent_block_type, norm) if i in rec or -1 in rec
            else ResidualBlock(c, c, norm=norm)
            for i in range(num_residual_blocks))
        self.pred = ConvLayer(c, num_output_channels, 1, activation=None)

    def _units(self):
        return [self.head] + [rb for rb in self.resblocks if isinstance(rb, RecurrentResidualLayer)]

    def forward(self, x: torch.Tensor, states: Sequence) -> Tuple[torch.Tensor, Tuple]:
        x, st = self.head(x, states[0])
        new_states, sidx = [st], 1
        for rb in self.resblocks:
            if isinstance(rb, RecurrentResidualLayer):
                x, st = rb(x, states[sidx])
                new_states.append(st)
                sidx += 1
            else:
                x = rb(x)
        return self.pred(x), tuple(new_states)

    def initial_state(self, batch: int, height: int, width: int, dtype=torch.float32,
                      device=None) -> Tuple:
        return tuple(u.initial_state(batch, height, width, dtype, device) for u in self._units())
