"""The spiking reconstruction models EVSNN and PA-EVSNN (counterpart of
``bde2vid_tpu/models/evsnn.py``; reference model/EVSNN/model/snn_network.py,
EVSNN_LIF_final :359-408 and PAEVSNN_LIF_AMPLIF_final :257-356, and the
RecSNN runner rec_snn_forward.py:7-56).

A step model with its state explicit:

    out, new_state = model(voxel, state)    # voxel (N, num_bins, H, W)
    state = model.initial_state(N, H, W)    # {"lif": {...}, "mp": ...}

One call normalises the voxel per sample (torch's ``tensor.std()`` on the
nonzero entries, the unbiased estimator, unlike the dataset's LegacyNorm),
unless the config says ``normalize_input: false``, and then feeds its bins
one at a time through the network. ``out["image"]`` (N, 1, H, W) is the
last bin's output membrane; the eval driver robust-normalises it. Every
firing LIF membrane persists across bins and calls; the residual block
fires ONE membrane twice a bin. Downsampled sizes are ``(h + 1) // 2``.

Row-sharded (``parallel.spatial``), the input norm and the adaptive leaks
take the whole map's statistics over the group, and the state lives at the
band's rows: the plan's bands halve exactly, so ``(h + 1) // 2`` is the
band at the next level.

The module names are the reference's (``static_conv.0``, ``down1.conv.conv2d``,
``residualBlock.0.bn1``, ``up1.norm_layer``, ``skip0.conv.get_theta.fc3``,
``aggregation1``, ``temporalflat``, ``final.0``), so a reference state dict
loads as it is, once the pooled-MLP tensors its forward never uses are
dropped (``eval/checkpoint.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from bde2vid_tpu_torch.models.api import register_model
from bde2vid_tpu_torch.nn.layers import BatchNorm2d, Conv2d, Linear, resize_bilinear_2x
from bde2vid_tpu_torch.nn.spiking import lif_step, mp_ada_lif_step, mp_lif_step
from bde2vid_tpu_torch.parallel import spatial
from bde2vid_tpu_torch.utils.norm import legacy_norm

TAU = 2.0
V_THRESHOLD = 1.0
V_RESET = None  # soft reset
# the firing LIF membranes of the shared trunk: (name, channels, downsamplings)
LIF_LAYERS = (("static_conv", 32, 0), ("down1", 64, 1), ("down2", 128, 2), ("down3", 256, 3),
              ("resblock", 256, 3), ("up1", 128, 2), ("up2", 64, 1), ("up3", 32, 0))
# PA-EVSNN's eight membrane paths: skip0-3, up1mp-up3mp, temporalflat
MP_LEVELS = (0, 1, 2, 3, 3, 2, 1, 0)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, stride, k // 2, bias=False)


def _lif(v: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return lif_step(v, x, TAU, V_THRESHOLD, V_RESET)


def _downsampled(h: int, w: int, times: int) -> Tuple[int, int]:
    for _ in range(times):
        h, w = (h + 1) // 2, (w + 1) // 2
    return h, w


class SpikingConvLayer(nn.Module):
    """conv (no bias) -> BN -> LIF (reference ConvLayer :39-57)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5, stride: int = 1):
        super().__init__()
        self.conv2d = _conv(cin, cout, kernel_size, stride)
        self.norm_layer = BatchNorm2d(cout)

    def forward(self, x, v):
        return _lif(v, self.norm_layer(self.conv2d(x)))


class SpikeRecurrentConv(nn.Module):
    """Spike_recurrentConvLayer_nolstm (reference :60-71): a strided
    SpikingConvLayer under ``conv``."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5, stride: int = 2):
        super().__init__()
        self.conv = SpikingConvLayer(cin, cout, kernel_size, stride)

    def forward(self, x, v):
        return self.conv(x, v)


class SpikingResidualBlock(nn.Module):
    """conv-BN-LIF-conv-BN, plus the input, then the SAME LIF again
    (reference :361-374): one membrane, fired twice."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = _conv(features, features, 3)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm2d(features)

    def forward(self, x, v):
        s1, v = _lif(v, self.bn1(self.conv1(x)))
        return _lif(v, self.bn2(self.conv2(s1)) + x)


class SpikeUpsampleLayer(nn.Module):
    """bilinear x2 -> conv (no bias) -> BN -> LIF (reference :377-397)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5):
        super().__init__()
        self.conv2d = _conv(cin, cout, kernel_size)
        self.norm_layer = BatchNorm2d(cout)

    def forward(self, x, v):
        return _lif(v, self.norm_layer(self.conv2d(resize_bilinear_2x(x))))


class MPUpsampleLayer(nn.Module):
    """bilinear x2 -> conv (no bias) -> BN, no neuron (reference :153-166)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5):
        super().__init__()
        self.conv2d = _conv(cin, cout, kernel_size)
        self.norm_layer = BatchNorm2d(cout)

    def forward(self, x):
        return self.norm_layer(self.conv2d(resize_bilinear_2x(x)))


class GetThetaSimMP(nn.Module):
    """The per-sample leak of the 'global' + 'mix' flavour (reference
    :118-151): ``fc2(relu(fc3(cat[maxpool(out), avgpool(x)])))``, (N, 1).
    The reference's ``fc1`` is never used, and is not built."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.fc3 = Linear(cin + cout, cout // 4)
        self.fc2 = Linear(cout // 4, 1)

    def forward(self, x, out):
        # the whole map's max and mean (over the "spatial" group when row-sharded)
        theta = torch.cat([spatial.group_max(out, (2, 3)), spatial.group_mean(x, (2, 3))], 1)
        return self.fc2(torch.relu(self.fc3(theta)))


class ConvLayerAdaSimMP(nn.Module):
    """conv (no bias) -> BN -> Mp_AdaLIF with the pooled-MLP leak (reference
    ConvLayer_ada_simmp :83-116, without its unused conv2d_pool/fc1/fc2)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1):
        super().__init__()
        self.conv2d = _conv(cin, cout, kernel_size)
        self.norm_layer = BatchNorm2d(cout)
        self.get_theta = GetThetaSimMP(cin, cout)

    def forward(self, x, last_mem):
        out = self.norm_layer(self.conv2d(x))
        w = self.get_theta(x, out)
        return mp_ada_lif_step(last_mem, out, w[:, :, None, None])


class SpikeSkipLayer(nn.Module):
    """Spike_skip_layer (reference :73-80): ConvLayerAdaSimMP under ``conv``."""

    def __init__(self, cin: int, cout: int = 32, kernel_size: int = 1):
        super().__init__()
        self.conv = ConvLayerAdaSimMP(cin, cout, kernel_size)

    def forward(self, x, last_mem):
        return self.conv(x, last_mem)


class TemporalFlatLayerConcat(nn.Module):
    """1x1 conv 64 -> 1 (no bias) -> BN -> MpLIF (reference :240-255)."""

    def __init__(self):
        super().__init__()
        self.conv2d = _conv(64, 1, 1)
        self.norm_layer = BatchNorm2d(1)

    def forward(self, x, last_mem):
        return mp_lif_step(last_mem, self.norm_layer(self.conv2d(x)), TAU)


class TemporalFlatLayerAdaSimMPConcat(nn.Module):
    """1x1 conv 64 -> 32 (no bias) -> BN -> Mp_AdaLIF (reference :400-433)."""

    def __init__(self):
        super().__init__()
        self.conv2d = _conv(64, 32, 1)
        self.norm_layer = BatchNorm2d(32)
        self.get_theta = GetThetaSimMP(64, 32)

    def forward(self, x, last_mem):
        out = self.norm_layer(self.conv2d(x))
        w = self.get_theta(x, out)
        return mp_ada_lif_step(last_mem, out, w[:, :, None, None])


class _SNNBase(nn.Module):
    """The shared spiking UNet trunk and the bin fold."""

    row_levels = 3  # stride-2 levels (down1..3), read by parallel.spatial.model_levels

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = dict(config or {})
        self.normalize_input = bool(self.config.get("normalize_input", True))
        self.static_conv = nn.Sequential(_conv(1, 32, 5), BatchNorm2d(32))
        self.down1 = SpikeRecurrentConv(32, 64)
        self.down2 = SpikeRecurrentConv(64, 128)
        self.down3 = SpikeRecurrentConv(128, 256)
        self.residualBlock = nn.Sequential(SpikingResidualBlock(256))
        self.up1 = SpikeUpsampleLayer(512, 128)
        self.up2 = SpikeUpsampleLayer(256, 64)
        self.up3 = SpikeUpsampleLayer(128, 32)

    def _trunk(self, x, lif):
        new = {}
        x_in, new["static_conv"] = _lif(lif["static_conv"], self.static_conv(x))
        x1, new["down1"] = self.down1(x_in, lif["down1"])
        x2, new["down2"] = self.down2(x1, lif["down2"])
        x3, new["down3"] = self.down3(x2, lif["down3"])
        r1, new["resblock"] = self.residualBlock[0](x3, lif["resblock"])
        u1, new["up1"] = self.up1(torch.cat([r1, x3], 1), lif["up1"])
        u2, new["up2"] = self.up2(torch.cat([u1, x2], 1), lif["up2"])
        u3, new["up3"] = self.up3(torch.cat([u2, x1], 1), lif["up3"])
        return (x_in, x1, x2, x3, r1, u1, u2, u3), new

    def forward(self, voxel: torch.Tensor, state) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        if self.normalize_input:
            # per sample: one batch-wide mean and std would let one sample's
            # event density shift another's input
            voxel = legacy_norm(voxel, unbiased=True, batched=True)
        img = None
        for j in range(voxel.shape[1]):
            img, state = self._one_bin(voxel[:, j:j + 1], state)
        return {"image": img}, state

    def _lif_state(self, batch: int, height: int, width: int) -> Dict[str, torch.Tensor]:
        p = next(self.parameters())
        return {name: torch.zeros((batch, c, *_downsampled(height, width, d)),
                                  dtype=p.dtype, device=p.device)
                for name, c, d in LIF_LAYERS}


@register_model("EVSNN")
class EVSNN(_SNNBase):
    """EVSNN_LIF_final: the spiking UNet, read out by a 1-channel
    temporal-flat membrane."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.temporalflat = TemporalFlatLayerConcat()

    def _one_bin(self, x, state):
        (x_in, *_, u3), lif = self._trunk(x, state["lif"])
        mem = self.temporalflat(torch.cat([u3, x_in], 1), state["mp"])
        return mem, {"lif": lif, "mp": mem}

    def initial_state(self, batch: int, height: int, width: int) -> Dict[str, Any]:
        """Zero membranes in the parameters' type and on their device."""
        p = next(self.parameters())
        return {"lif": self._lif_state(batch, height, width),
                "mp": torch.zeros((batch, 1, height, width), dtype=p.dtype, device=p.device)}


@register_model("PAEVSNN")
class PAEVSNN(_SNNBase):
    """PAEVSNN_LIF_AMPLIF_final: adds eight membrane skip and aggregation
    paths with per-sample adaptive leaks."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        for name, cin in (("skip0", 32), ("skip1", 64), ("skip2", 128), ("skip3", 256),
                          ("up1mp", 256), ("up2mp", 128), ("up3mp", 64)):
            setattr(self, name, SpikeSkipLayer(cin))
        for i in (1, 2, 3):
            setattr(self, f"aggregation{i}", MPUpsampleLayer(32, 32))
        self.temporalflat = TemporalFlatLayerAdaSimMPConcat()
        self.final = nn.Sequential(_conv(32, 1, 1))

    def _one_bin(self, x, state):
        (x_in, x1, x2, x3, r1, u1, u2, u3), lif = self._trunk(x, state["lif"])
        mp = state["mp"]
        s0 = self.skip0(x_in, mp[0])
        s1 = self.skip1(x1, mp[1])
        s2 = self.skip2(x2, mp[2])
        s3 = self.skip3(x3, mp[3])
        up1mp = self.up1mp(r1, mp[4])
        up2mp = self.up2mp(u1, mp[5])
        up3mp = self.up3mp(u2, mp[6])
        a1 = self.aggregation1(s3 + up1mp)
        a2 = self.aggregation2(a1 + (s2 + up2mp))
        a3 = self.aggregation3(a2 + (s1 + up3mp))
        mem = self.temporalflat(torch.cat([u3, x_in], 1), mp[7])
        img = self.final(mem + a3 + s0)
        return img, {"lif": lif, "mp": (s0, s1, s2, s3, up1mp, up2mp, up3mp, mem)}

    def initial_state(self, batch: int, height: int, width: int) -> Dict[str, Any]:
        """Zero membranes in the parameters' type and on their device: the
        trunk's LIFs and the eight 32-channel membrane paths."""
        p = next(self.parameters())
        mp = tuple(torch.zeros((batch, 32, *_downsampled(height, width, d)),
                               dtype=p.dtype, device=p.device) for d in MP_LEVELS)
        return {"lif": self._lif_state(batch, height, width), "mp": mp}
