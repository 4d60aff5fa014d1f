"""EITR (counterpart of ``bde2vid_tpu/models/eitr.py``; reference
model/eitr/{eitr.py:9-34, u_trans.py:14-206}).

A head conv and three recurrent strided encoders; the three scales become
``d_model``-wide token streams at H/8 (the last encoder's map itself, a
k2s2 conv of the second's, a k4s4 conv of the first's), each through a
3-layer pre-norm transformer encoder with one shared sine position table;
three 2-layer decoders attend across scales (hs0 -> hs0, hs1 -> hs0,
hs2 -> hs1) and the six streams are averaged (``use_trans_decoder:
false``: the three encoder streams). The mean goes back to the H/8 grid
and up through skip-sum upsample convs to a 1x1 ``pred`` and a sigmoid.
The input is padded to /8 inside the model and the image cropped back, so
the state lives at the padded size.

Tokens are the (h, w) grid in row-major order; ``d_model`` must equal
``channels[3]``. Row-sharded (``parallel.spatial``), a rank's queries are
its band's tokens and every attention reads the whole map's keys and values
(``spatial.all_tokens``); the position table is sliced at the band's first
token. Module names are the reference's (``head``,
``DownsampleConv.N``, ``split1``, ``split2``,
``trans_encoderN.encoder.layers.J``, ``trans_decoderN.decoder.layers.J``,
``UpsampleConv.N``, ``pred``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn
from torch.utils._python_dispatch import _disable_current_modes

from bde2vid_tpu_torch.models.api import register_model
from bde2vid_tpu_torch.nn.layers import Conv2d, ConvLayer, UpsampleConvLayer
from bde2vid_tpu_torch.nn.recurrent import RecurrentConvLayer
from bde2vid_tpu_torch.nn.transformer import (
    TransformerDecoder,
    TransformerEncoder,
    sine_position_table,
)
from bde2vid_tpu_torch.parallel import spatial
from bde2vid_tpu_torch.utils.padding import CropParameters


@register_model("EITR")
class EITR(nn.Module):
    row_levels = 3  # stride-2 levels (DownsampleConv), read by parallel.spatial.model_levels

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = dict(config)
        norm = config.get("norm", None)
        chans = tuple(config.get("channels", (32, 64, 128, 256)))
        d = int(config.get("d_model", 256))
        ff = int(config.get("dim_feedforward", d * 4))
        nhead = int(config.get("nhead", 8))
        if d != chans[3]:
            raise ValueError(f"d_model ({d}) must equal channels[3] ({chans[3]})")
        self.d_model = d
        self.use_trans_decoder = bool(config.get("use_trans_decoder", True))
        self.head = ConvLayer(int(config.get("num_bins", 5)), chans[0], 5, padding=2, norm=norm)
        self.DownsampleConv = nn.ModuleList(
            RecurrentConvLayer(chans[i], chans[i + 1], 5, stride=2, padding=2, norm=norm)
            for i in range(3))
        self.split1 = Conv2d(chans[2], d, 2, stride=2)
        self.split2 = Conv2d(chans[1], d, 4, stride=4)
        for i in range(3):
            setattr(self, f"trans_encoder{i}", TransformerEncoder(d, nhead, 3, ff))
            if self.use_trans_decoder:
                setattr(self, f"trans_decoder{i}", TransformerDecoder(d, nhead, 2, ff))
        self.UpsampleConv = nn.ModuleList(
            UpsampleConvLayer(ci, co, 5, padding=2, norm=norm)
            for ci, co in ((chans[3], chans[2]), (chans[2], chans[1]), (chans[1], chans[0])))
        self.pred = ConvLayer(chans[0], 1, 1, activation=None, norm=norm)
        self._pos = {}  # (tokens, device, dtype) -> (1, tokens, d) position table

    def _position_table(self, n: int, like: torch.Tensor) -> torch.Tensor:
        key = (n, like.device, like.dtype)
        if key not in self._pos:
            # made outside every dispatch mode: under torch.export's fake
            # tensors the table would be a fake one, which later eager calls
            # would read from the cache (the C15 fault of the attention's
            # index maps); a real one is a constant of the exported program
            with _disable_current_modes():
                table = torch.from_numpy(sine_position_table(n, self.d_model))
                self._pos[key] = table.to(device=like.device, dtype=like.dtype)[None]
        return self._pos[key]

    def forward(self, voxel: torch.Tensor, state) -> Tuple[Dict[str, torch.Tensor], Tuple]:
        # row-sharded, the band's rows are a multiple of 8 (the plan's bands
        # at 3 levels), so the pad and the crop leave the rows alone and act
        # on the width only, as on the whole map
        crop = CropParameters(voxel.shape[-1], voxel.shape[-2], 3)
        x = self.head(crop.pad(voxel))
        head = x
        blocks, new_states = [], []
        for layer, st in zip(self.DownsampleConv, state):
            x, st = layer(x, st)
            blocks.append(x)
            new_states.append(st)

        nb, _, h8, w8 = blocks[2].shape
        tokens = lambda t: t.flatten(2).transpose(1, 2)  # (N, h8 w8, d), row-major (h, w)
        # split1 (k2s2) and split2 (k4s4) map band onto band with no exchange
        words = (tokens(blocks[2]), tokens(self.split1(blocks[1])), tokens(self.split2(blocks[0])))
        rows = spatial.current()
        if rows is None:
            pos = self._position_table(h8 * w8, words[0])
        else:  # the band's tokens are the whole map's from row lo on
            _, height, lo, hi = rows.geometry(h8)
            pos = self._position_table(height * w8, words[0])[:, lo * w8:hi * w8]
        hs0, hs1, hs2 = (getattr(self, f"trans_encoder{i}")(w, pos) for i, w in enumerate(words))
        if self.use_trans_decoder:
            hc0 = self.trans_decoder0(hs0, hs0)
            hc1 = self.trans_decoder1(hs1, hs0)
            hc2 = self.trans_decoder2(hs2, hs1)
            hs = (hs0 + hs1 + hs2 + hc0 + hc1 + hc2) / 6.0
        else:  # the reference's mls_tpa_wo_transde (u_trans.py:118-206)
            hs = (hs0 + hs1 + hs2) / 3.0
        hs = hs.transpose(1, 2).reshape(nb, self.d_model, h8, w8)
        for i, up in enumerate(self.UpsampleConv):
            hs = up(hs + blocks[2 - i])
        img = torch.sigmoid(self.pred(hs + head))
        return {"image": crop.crop(img)}, tuple(new_states)

    def initial_state(self, batch: int, height: int, width: int) -> Tuple:
        """Zero ConvLSTM states at the padded (/8) size, in the parameters'
        type and on their device."""
        p = next(self.parameters())
        crop = CropParameters(width, height, 3)
        h, w = crop.height_crop_size, crop.width_crop_size
        states = []
        for layer in self.DownsampleConv:
            states.append(layer.initial_state(batch, h, w, dtype=p.dtype, device=p.device))
            h, w = layer.out_size(h, w)
        return tuple(states)
