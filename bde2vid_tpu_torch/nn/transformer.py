"""Transformer blocks for EITR (counterpart of ``bde2vid_tpu/nn/transformer.py``;
reference model/eitr/transformer_encoder.py:7-91, transformer_decoder.py:7-97,
position_encoding.py:7-36, transformer.py:8-139).

Tokens are (N, S, C), batch first. Attention keeps torch
``nn.MultiheadAttention``'s parameters (a packed ``in_proj_weight`` /
``in_proj_bias`` and ``out_proj``) and computes in the input's type, as
the JAX package does: the projections, then softmax(q k^T / sqrt(hd)) v
with ``torch.matmul``. Dropout is off (evaluation). The pre-norm stacks
that EITR runs nest their layers one level down (``encoder.layers.J``,
``decoder.layers.J``), as the reference's wrappers do; positions are added
once, at the encoder's input.

Under ``parallel.spatial.row_sharded`` the pre-norm layers' tokens are a
band of the map: the queries stay the band's, the keys and values are the
whole map's (``spatial.all_tokens``); norms and FFNs act per token.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bde2vid_tpu_torch.nn.layers import LayerNorm, Linear
from bde2vid_tpu_torch.parallel import spatial


class MultiheadAttention(nn.Module):
    """torch-compatible multi-head attention over (N, S, C) tokens."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = Linear(d_model, d_model)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        wq, wk, wv = self.in_proj_weight.to(q.dtype).chunk(3)
        bq, bk, bv = self.in_proj_bias.to(q.dtype).chunk(3)
        n, s, d = q.shape
        hd = d // self.nhead

        def heads(x, w, b):
            return F.linear(x, w, b).reshape(n, -1, self.nhead, hd).transpose(1, 2)

        qh, kh, vh = heads(q, wq, bq), heads(k, wk, bk), heads(v, wv, bv)
        attn = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        out = torch.matmul(attn, vh).transpose(1, 2).reshape(n, s, d)
        return self.out_proj(out)


class _FeedForward(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int):
        super().__init__()
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(torch.relu(self.linear1(x)))


class TransformerEncoderLayer(_FeedForward):
    """Pre-norm: norm1 -> self-attention -> + residual; norm2 -> FFN -> + residual."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048):
        super().__init__(d_model, dim_feedforward)
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, src: torch.Tensor) -> torch.Tensor:
        q = self.norm1(src)
        kv = spatial.all_tokens(q)
        src = src + self.self_attn(q, kv, kv)
        return src + self.ffn(self.norm2(src))


class TransformerDecoderLayer(_FeedForward):
    """Pre-norm self-attention, then cross-attention with ``norm21`` on the
    query and ``norm22`` on the memory, then the FFN after ``norm3``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048):
        super().__init__(d_model, dim_feedforward)
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.cross_attn = MultiheadAttention(d_model, nhead)
        for name in ("norm1", "norm21", "norm22", "norm3"):
            setattr(self, name, LayerNorm(d_model, eps=1e-5))

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        q = self.norm1(tgt)
        kv = spatial.all_tokens(q)
        tgt = tgt + self.self_attn(q, kv, kv)
        kv = spatial.all_tokens(self.norm22(memory))
        tgt = tgt + self.cross_attn(self.norm21(tgt), kv, kv)
        return tgt + self.ffn(self.norm3(tgt))


def _stack(layers) -> nn.Module:
    """The reference wrappers' inner module, which holds ``layers``."""
    inner = nn.Module()
    inner.layers = nn.ModuleList(layers)
    return inner


class TransformerEncoder(nn.Module):
    """``num_layers`` pre-norm encoder layers; ``pos`` is added once, to
    the input (reference :36-45)."""

    def __init__(self, d_model: int = 256, nhead: int = 8, num_layers: int = 3,
                 dim_feedforward: int = 1024):
        super().__init__()
        self.encoder = _stack(TransformerEncoderLayer(d_model, nhead, dim_feedforward)
                              for _ in range(num_layers))

    def forward(self, src: torch.Tensor, pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = src if pos is None else src + pos
        for layer in self.encoder.layers:
            out = layer(out)
        return out


class TransformerDecoder(nn.Module):
    """``num_layers`` pre-norm decoder layers over one memory."""

    def __init__(self, d_model: int = 256, nhead: int = 8, num_layers: int = 2,
                 dim_feedforward: int = 1024):
        super().__init__()
        self.decoder = _stack(TransformerDecoderLayer(d_model, nhead, dim_feedforward)
                              for _ in range(num_layers))

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        out = tgt
        for layer in self.decoder.layers:
            out = layer(out, memory)
        return out


def sine_position_table(n_position: int, d_model: int) -> np.ndarray:
    """(n_position, d_model) f32 table, sin at even and cos at odd columns of
    pos / 10000^(2 (j // 2) / d), computed in f64 (reference
    position_encoding.py:15-24); bit-equal to JAX's."""
    pos = np.arange(n_position)[:, None]
    j = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, 2 * (j // 2) / d_model)
    table = np.zeros((n_position, d_model), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class GenericTransformerEncoderLayer(_FeedForward):
    """POST-norm encoder layer with ``pos`` added to the query and key of
    every layer (the reference's generic eitr/transformer.py:65-96, which
    no model uses)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048):
        super().__init__(d_model, dim_feedforward)
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, src: torch.Tensor, pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = src if pos is None else src + pos
        src = self.norm1(src + self.self_attn(q, q, src))
        return self.norm2(src + self.ffn(src))


class GenericTransformerDecoderLayer(_FeedForward):
    """POST-norm decoder layer; ``task_embed`` joins the queries of both
    attentions (reference eitr/transformer.py:98-139)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048):
        super().__init__(d_model, dim_feedforward)
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.cross_attn = MultiheadAttention(d_model, nhead)
        for name in ("norm1", "norm2", "norm3"):
            setattr(self, name, LayerNorm(d_model, eps=1e-5))

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                task_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = (lambda x: x) if task_embed is None else (lambda x: x + task_embed)
        q = emb(tgt)
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        tgt = self.norm2(tgt + self.cross_attn(emb(tgt), memory, memory))
        return self.norm3(tgt + self.ffn(tgt))


class Transformer(nn.Module):
    """The reference's generic encoder-decoder (eitr/transformer.py:8-34):
    the encoder's output is both the decoder's input and its memory;
    ``pos`` feeds every encoder layer, ``task_embed`` every decoder layer."""

    def __init__(self, d_model: int = 256, nhead: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 2048):
        super().__init__()
        self.encoder_layers = nn.ModuleList(
            GenericTransformerEncoderLayer(d_model, nhead, dim_feedforward)
            for _ in range(num_encoder_layers))
        self.decoder_layers = nn.ModuleList(
            GenericTransformerDecoderLayer(d_model, nhead, dim_feedforward)
            for _ in range(num_decoder_layers))

    def forward(self, src: torch.Tensor, pos: Optional[torch.Tensor] = None,
                task_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = src
        for layer in self.encoder_layers:
            out = layer(out, pos)
        memory = out
        for layer in self.decoder_layers:
            out = layer(out, memory, task_embed)
        return out
