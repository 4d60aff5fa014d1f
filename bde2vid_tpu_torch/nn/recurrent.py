"""Convolutional LSTM and GRU cells and the recurrent layers built on them
(counterpart of ``bde2vid_tpu/nn/recurrent.py``; reference
model/e2vid/submodules.py ConvLSTM :250-307, ConvGRU :309-348,
RecurrentConvLayer :110-129, RecurrentResidualLayer :350-373).

State is explicit: ``recurrent_initial_state`` (or a layer's
``initial_state``) makes it and the caller threads it through time;
``make_recurrent_cell`` picks the cell by the config's
``recurrent_block_type``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from bde2vid_tpu_torch.nn.layers import Conv2d, ConvLayer, ResidualBlock

LstmState = Tuple[torch.Tensor, torch.Tensor]
State = Union[LstmState, torch.Tensor]


class ConvLSTMCell(nn.Module):
    """One conv over concat(x, h) -> 4*hidden channels, split in torch
    channel order (i, f, o, g); the conv is named ``Gates`` like the
    reference (model/e2vid/submodules.py ConvLSTM)."""

    def __init__(self, input_size: int, hidden_size: int, kernel_size: int = 3):
        super().__init__()
        self.hidden_size = hidden_size
        self.Gates = Conv2d(input_size + hidden_size, 4 * hidden_size, kernel_size,
                            padding=kernel_size // 2)

    def forward(self, x: torch.Tensor, state: LstmState) -> Tuple[torch.Tensor, LstmState]:
        prev_h, prev_c = state
        gates = self.Gates(torch.cat([x, prev_h.to(x.dtype)], dim=1))
        i, f, o, g = gates.chunk(4, dim=1)
        c = torch.sigmoid(f) * prev_c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


class ConvGRUCell(nn.Module):
    """Three convs ``update_gate``, ``reset_gate`` and ``out_gate``
    (orthogonal weights, zero biases, as the reference initialises them):
    new = prev (1 - z) + tanh(out_gate([x, prev r])) z, with z and r the
    sigmoids of the update and reset gates over [x, prev]. The state is the
    hidden map itself."""

    def __init__(self, input_size: int, hidden_size: int, kernel_size: int = 3):
        super().__init__()
        self.hidden_size = hidden_size
        for name in ("update_gate", "reset_gate", "out_gate"):
            conv = Conv2d(input_size + hidden_size, hidden_size, kernel_size,
                          padding=kernel_size // 2)
            nn.init.orthogonal_(conv.weight)
            nn.init.zeros_(conv.bias)
            setattr(self, name, conv)

    def forward(self, x: torch.Tensor, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        prev = state.to(x.dtype)
        xin = torch.cat([x, prev], dim=1)
        update = torch.sigmoid(self.update_gate(xin))
        reset = torch.sigmoid(self.reset_gate(xin))
        cand = torch.tanh(self.out_gate(torch.cat([x, prev * reset], dim=1)))
        new = prev * (1.0 - update) + cand * update
        return new, new


def make_recurrent_cell(block_type: str, input_size: int, hidden_size: int,
                        kernel_size: int = 3) -> nn.Module:
    if block_type == "convlstm":
        return ConvLSTMCell(input_size, hidden_size, kernel_size)
    if block_type == "convgru":
        return ConvGRUCell(input_size, hidden_size, kernel_size)
    raise ValueError(f"unknown recurrent_block_type {block_type!r} (convlstm|convgru)")


def lstm_initial_state(batch: int, h: int, w: int, hidden: int, dtype=torch.float32,
                       device=None) -> LstmState:
    """Zero (h, c) of shape (batch, hidden, h, w)."""
    return recurrent_initial_state("convlstm", batch, h, w, hidden, dtype, device)


def gru_initial_state(batch: int, h: int, w: int, hidden: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """Zero hidden map of shape (batch, hidden, h, w)."""
    return recurrent_initial_state("convgru", batch, h, w, hidden, dtype, device)


def recurrent_initial_state(block_type: str, batch: int, h: int, w: int, hidden: int,
                            dtype=torch.float32, device=None) -> State:
    """Zero state of shape (batch, hidden, h, w): (h, c) for convlstm, the
    hidden map for convgru."""
    z = torch.zeros((batch, hidden, h, w), dtype=dtype, device=device)
    if block_type == "convlstm":
        return z, z
    if block_type == "convgru":
        return z
    raise ValueError(f"unknown recurrent_block_type {block_type!r} (convlstm|convgru)")


class RecurrentConvLayer(nn.Module):
    """``conv`` (a ConvLayer, strided) then a ``recurrent_block`` cell whose
    kernel is 3 whatever the conv's (reference RecurrentConvLayer)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, recurrent_block_type: str = "convlstm",
                 activation: Optional[str] = "relu", norm: Optional[str] = None):
        super().__init__()
        self.conv = ConvLayer(in_channels, out_channels, kernel_size, stride, padding,
                              activation=activation, norm=norm)
        self.recurrent_block = make_recurrent_cell(recurrent_block_type, out_channels,
                                                   out_channels, 3)
        self.block_type = recurrent_block_type
        self.geometry = (kernel_size, stride, padding)

    def forward(self, x: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
        return self.recurrent_block(self.conv(x), state)

    def out_size(self, height: int, width: int) -> Tuple[int, int]:
        """The conv's output size, (h + 2p - k) // stride + 1."""
        k, stride, p = self.geometry
        return (height + 2 * p - k) // stride + 1, (width + 2 * p - k) // stride + 1

    def initial_state(self, batch: int, height: int, width: int, dtype=torch.float32,
                      device=None) -> State:
        """Zero state at the conv's output size."""
        return recurrent_initial_state(self.block_type, batch, *self.out_size(height, width),
                                       self.recurrent_block.hidden_size, dtype, device)


class RecurrentResidualLayer(nn.Module):
    """``conv`` (a ResidualBlock) then a ``recurrent_block`` cell of kernel 3
    (reference RecurrentResidualLayer, FireNetOrg's recurrent resblocks)."""

    def __init__(self, channels: int, recurrent_block_type: str = "convgru",
                 norm: Optional[str] = None):
        super().__init__()
        self.conv = ResidualBlock(channels, channels, norm=norm)
        self.recurrent_block = make_recurrent_cell(recurrent_block_type, channels, channels, 3)
        self.block_type = recurrent_block_type

    def forward(self, x: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
        return self.recurrent_block(self.conv(x), state)

    def initial_state(self, batch: int, height: int, width: int, dtype=torch.float32,
                      device=None) -> State:
        return recurrent_initial_state(self.block_type, batch, height, width,
                                       self.recurrent_block.hidden_size, dtype, device)
