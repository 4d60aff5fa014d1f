"""SPADE-E2VID (counterpart of ``bde2vid_tpu/models/spade_e2vid.py``;
reference model/spade_e2vid/spade_e2v.py:7-293).

``Unet6``: a head conv 5 -> 32; three conv-BN-relu-ConvLSTM encoders
(strides 1/2/2); two BN residual blocks; two pixel-shuffle up blocks whose
SPADE norm is conditioned on the previous prediction; one recurrent up
layer; a 1x1 conv -> BN -> sigmoid to BGR. The ``SPADEE2VID`` wrapper
turns BGR into gray and feeds the prediction back as the next step's
segmap; the first one is bootstrapped from the first three voxel channels.

A step model, one (sub-)voxel per call, with the state explicit:

    out, new_state = model(voxel, state)    # voxel (N, num_bins, H, W)
    state = model.initial_state(N, H, W)    # {"states", "pred", "initialized"}

``out`` is ``{"image": gray (N, 1, H, W), "image_bgr": (N, 3, H, W)}``. The
module names are the reference's (``generator.fc``, ``rec0``, ``res0``,
``up0.norm.mlp_shared.0``, ``conv_img``, ``bn_img``, ...), so a reference
bare state dict loads into ``model.generator`` as it is.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from bde2vid_tpu_torch.models.api import register_model
from bde2vid_tpu_torch.nn.layers import BatchNorm2d, Conv2d, pixel_shuffle, resize_nearest_torch
from bde2vid_tpu_torch.nn.recurrent import ConvLSTMCell, LstmState, recurrent_initial_state
from bde2vid_tpu_torch.parallel import spatial


class SPADE(nn.Module):
    """Spatially-adaptive normalisation (reference :144-175): an affine-free
    BN on x, then ``bn(x) * (1 + gamma) + beta`` with gamma and beta from
    the segmap, nearest-resized to x's size with torch's floor rule."""

    def __init__(self, norm_nc: int, label_nc: int = 3, nhidden: int = 64):
        super().__init__()
        self.param_free_norm = BatchNorm2d(norm_nc, affine=False)
        self.mlp_shared = nn.Sequential(Conv2d(label_nc, nhidden, 3, padding=1), nn.ReLU())
        self.mlp_gamma = Conv2d(nhidden, norm_nc, 3, padding=1)
        self.mlp_beta = Conv2d(nhidden, norm_nc, 3, padding=1)

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        normalized = self.param_free_norm(x)
        actv = self.mlp_shared(resize_nearest_torch(segmap, *x.shape[-2:]))
        return normalized * (1.0 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class SpadeRecurrentConvLayer(nn.Module):
    """conv (no bias) -> BN -> relu -> ConvLSTM of kernel 3 (reference
    :105-122)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5,
                 stride: int = 2):
        super().__init__()
        self.conv0 = Conv2d(in_channels, out_channels, kernel_size, stride, kernel_size // 2,
                            bias=False)
        self.bn = BatchNorm2d(out_channels)
        self.recurrent_block = ConvLSTMCell(out_channels, out_channels, 3)

    def forward(self, x: torch.Tensor, state: LstmState) -> Tuple[torch.Tensor, LstmState]:
        return self.recurrent_block(torch.relu(self.bn(self.conv0(x))), state)


class SpadeResidualBlock(nn.Module):
    """conv-BN-relu-conv-BN plus the input, then relu; no-bias convs
    (reference :125-141)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + x)


def icnr_init(weight: torch.Tensor, scale: int = 2, init=nn.init.kaiming_normal_) -> torch.Tensor:
    """ICNR (reference icnr :202-209): the ``scale**2`` output channels that
    pixel-shuffle into one get the same kernel, so the shuffle starts as a
    nearest-neighbour upsample. Fills the (C r^2, in, kh, kw) ``weight`` in
    place; only training from scratch needs it."""
    out_c, *rest = weight.shape
    sub = init(torch.empty(out_c // scale**2, *rest, dtype=weight.dtype))
    with torch.no_grad():
        return weight.copy_(sub.repeat_interleave(scale**2, dim=0))


class SpadeUpConvLayer(nn.Module):
    """conv (kernel 3, no bias, ICNR) -> pixel shuffle -> SPADE on the
    previous prediction -> relu (reference UpConvLayer3 :211-245)."""

    def __init__(self, in_channels: int, out_channels: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.conv0 = Conv2d(in_channels, out_channels * scale**2, 3, padding=1, bias=False)
        icnr_init(self.conv0.weight, scale)
        self.norm = SPADE(out_channels)

    def forward(self, x: torch.Tensor, x_org: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.norm(pixel_shuffle(self.conv0(x), self.scale), x_org))


class Unet6(nn.Module):
    """The SPADE generator (reference :237-293) at its fixed widths."""

    def __init__(self, num_bins: int = 5):
        super().__init__()
        self.fc = Conv2d(num_bins, 32, 5, padding=2)
        self.rec0 = SpadeRecurrentConvLayer(32, 64, stride=1)
        self.rec1 = SpadeRecurrentConvLayer(64, 128, stride=2)
        self.rec2 = SpadeRecurrentConvLayer(128, 256, stride=2)
        self.res0 = SpadeResidualBlock(256)
        self.res1 = SpadeResidualBlock(256)
        self.up0 = SpadeUpConvLayer(256, 128)
        self.up1 = SpadeUpConvLayer(128, 64)
        self.up2 = SpadeRecurrentConvLayer(64, 32, stride=1)
        self.conv_img = Conv2d(32, 3, 1)
        self.bn_img = BatchNorm2d(3)

    def forward(self, x: torch.Tensor, states, pred: torch.Tensor):
        head = torch.relu(self.fc(x))
        x0, s0 = self.rec0(head, states[0])
        x1, s1 = self.rec1(x0, states[1])
        x2, s2 = self.rec2(x1, states[2])
        y = self.res1(self.res0(x2))
        y = self.up0(y + x2, pred)
        y = self.up1(y + x1, pred)
        y, s3 = self.up2(y + x0, states[3])
        img = self.bn_img(self.conv_img(torch.relu(y + head)))
        return torch.sigmoid(img), (s0, s1, s2, s3)


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) BGR -> (N, 1, H, W) gray, the reference's
    rgb_to_grayscale of the channels reversed (spade_e2v.py:21-23)."""
    return 0.299 * bgr[:, 2:3] + 0.587 * bgr[:, 1:2] + 0.114 * bgr[:, 0:1]


@register_model("SPADEE2VID")
class SPADEE2VID(nn.Module):
    """The wrapper (reference :25-37): the previous prediction conditions
    SPADE; the first step bootstraps it from the first three voxel channels.
    The gate is on their RAW max over the whole tensor, batch included: a
    max of exactly 0 keeps the raw channels; otherwise they are shifted by
    their min and divided by the max after the shift.

    Row-sharded (``parallel.spatial``) those extremes are the group's, and
    the two stride-2 levels map band onto band: the previous prediction's
    nearest resize to a level-1 band reads rows 2i of the level-0 band
    (ratio exactly 2), the pixel shuffles double a band's rows."""

    row_levels = 2  # stride-2 levels (rec1, rec2), read by parallel.spatial.model_levels

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = dict(config)
        self.generator = Unet6(int(config.get("num_bins", 5)))

    def forward(self, voxel: torch.Tensor, state) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        # the whole tensor's extremes (over the "spatial" group when row-sharded)
        first3 = voxel[:, :3]
        shifted = first3 - spatial.group_min(first3)
        mx = spatial.group_max(shifted)
        boot = torch.where(spatial.group_max(first3) != 0,
                           shifted / torch.where(mx == 0, torch.ones_like(mx), mx), first3)
        pred = torch.where(state["initialized"], state["pred"].to(voxel.dtype), boot)
        out, new_states = self.generator(voxel, state["states"], pred)
        new_state = {"states": new_states, "pred": out.float(),
                     "initialized": torch.ones((), dtype=torch.bool, device=voxel.device)}
        return {"image": bgr_to_gray(out), "image_bgr": out}, new_state

    def initial_state(self, batch: int, height: int, width: int) -> Dict[str, Any]:
        """Zero LSTM states (in the parameters' type) at full, 1/2 and 1/4
        size and full size again, a zero f32 ``pred``, ``initialized`` False."""
        p = next(self.parameters())
        like = {"dtype": p.dtype, "device": p.device}
        h2, w2 = (height + 1) // 2, (width + 1) // 2
        h4, w4 = (h2 + 1) // 2, (w2 + 1) // 2
        sizes = ((height, width, 64), (h2, w2, 128), (h4, w4, 256), (height, width, 32))
        return {
            "states": tuple(recurrent_initial_state("convlstm", batch, h, w, c, **like)
                            for h, w, c in sizes),
            "pred": torch.zeros((batch, 3, height, width), dtype=torch.float32, device=p.device),
            "initialized": torch.zeros((), dtype=torch.bool, device=p.device),
        }
