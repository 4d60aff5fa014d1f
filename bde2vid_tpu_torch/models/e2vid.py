"""The E2VID model family (counterpart of ``bde2vid_tpu/models/e2vid.py``;
reference model/e2vid/model.py): E2VID, E2VIDRecurrent, FireNet, FireNetOrg
and FlowNet, each registered by name.

Step models, one frame per call, with the state explicit:

    out, new_state = model(voxel, state)    # voxel (N, num_bins, H, W)
    state = model.initial_state(N, H, W)

``out["image"]`` is (N, 1, H, W): a sigmoid for E2VID and E2VIDRecurrent,
the raw 1x1 output for FireNet and FireNetOrg, channel 0 for FlowNet (whose
``out["flow"]`` holds channels 1-2). The attribute names are the
reference's (``unet``, ``unetrecurrent``, ``unetflow``, ``net``;
``head``/``G1``/``R1``/``G2``/``R2``/``pred`` for FireNet), so a reference
state dict loads as it is. The state is made in the parameters' type and on
their device.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from bde2vid_tpu_torch.models.api import register_model
from bde2vid_tpu_torch.models.unet import UNet, UNetFire, UNetFlow, UNetRecurrent
from bde2vid_tpu_torch.nn.layers import ConvLayer, ResidualBlock
from bde2vid_tpu_torch.nn.recurrent import ConvGRUCell, recurrent_initial_state


def _unet_common(config: Dict[str, Any]) -> Dict[str, Any]:
    """The UNet keys of a config with the reference defaults; no
    ``kernel_size``, which UNet and UNetRecurrent fix at 5."""
    return dict(
        num_bins=int(config["num_bins"]),
        skip_type=str(config.get("skip_type", "sum")),
        num_encoders=int(config.get("num_encoders", 4)),
        base_num_channels=int(config.get("base_num_channels", 32)),
        num_residual_blocks=int(config.get("num_residual_blocks", 2)),
        norm=config.get("norm", None),
        use_upsample_conv=bool(config.get("use_upsample_conv", True)),
    )


class _StepModel(nn.Module):
    def _like_params(self) -> Dict[str, Any]:
        p = next(self.parameters())
        return {"dtype": p.dtype, "device": p.device}


@register_model("E2VID")
class E2VID(_StepModel):
    """The non-recurrent E2VID; its state is ()."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = dict(config)
        self.unet = UNet(num_output_channels=1, activation="sigmoid", **_unet_common(config))

    def forward(self, voxel: torch.Tensor, state=()) -> Tuple[Dict[str, torch.Tensor], Tuple]:
        return {"image": self.unet(voxel)}, ()

    def initial_state(self, batch: int, height: int, width: int) -> Tuple:
        return ()


@register_model("E2VIDRecurrent")
class E2VIDRecurrent(_StepModel):
    """E2VID with a recurrent cell after every encoder."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = dict(config)
        self.unetrecurrent = UNetRecurrent(
            num_output_channels=1, activation="sigmoid",
            recurrent_block_type=str(config.get("recurrent_block_type", "convlstm")),
            **_unet_common(config))

    def forward(self, voxel: torch.Tensor, state) -> Tuple[Dict[str, torch.Tensor], Tuple]:
        img, new_state = self.unetrecurrent(voxel, state)
        return {"image": img}, new_state

    def initial_state(self, batch: int, height: int, width: int) -> Tuple:
        return self.unetrecurrent.initial_state(batch, height, width, **self._like_params())


@register_model("FireNet")
class FireNet(_StepModel):
    """The light FireNet: head conv -> GRU -> resblock -> GRU -> resblock ->
    1x1 pred with no activation, all at full resolution."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = dict(config)
        c = int(config.get("base_num_channels", 16))
        k = int(config.get("kernel_size", 3))
        self.head = ConvLayer(int(config["num_bins"]), c, k, padding=k // 2)
        self.G1 = ConvGRUCell(c, c, k)
        self.R1 = ResidualBlock(c, c)
        self.G2 = ConvGRUCell(c, c, k)
        self.R2 = ResidualBlock(c, c)
        self.pred = ConvLayer(c, 1, 1, activation=None)

    def forward(self, voxel: torch.Tensor, state) -> Tuple[Dict[str, torch.Tensor], Tuple]:
        x, s0 = self.G1(self.head(voxel), state[0])
        x, s1 = self.G2(self.R1(x), state[1])
        return {"image": self.pred(self.R2(x))}, (s0, s1)

    def initial_state(self, batch: int, height: int, width: int) -> Tuple:
        return tuple(recurrent_initial_state("convgru", batch, height, width, self.G1.hidden_size,
                                             **self._like_params()) for _ in range(2))


@register_model("FireNetOrg")
class FireNetOrg(_StepModel):
    """The original FireNet over ``UNetFire``, held as ``net``."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = dict(config)
        rec_blocks = config.get("recurrent_blocks", {"resblock": [0]})
        self.net = UNetFire(
            num_bins=int(config["num_bins"]), num_output_channels=1,
            recurrent_block_type=str(config.get("recurrent_block_type", "convgru")),
            base_num_channels=int(config.get("base_num_channels", 16)),
            num_residual_blocks=int(config.get("num_residual_blocks", 2)),
            norm=config.get("norm", None), kernel_size=int(config.get("kernel_size", 3)),
            recurrent_blocks=tuple(rec_blocks.get("resblock", [])))

    def forward(self, voxel: torch.Tensor, state) -> Tuple[Dict[str, torch.Tensor], Tuple]:
        img, new_state = self.net(voxel, state)
        return {"image": img}, new_state

    def initial_state(self, batch: int, height: int, width: int) -> Tuple:
        return self.net.initial_state(batch, height, width, **self._like_params())


@register_model("FlowNet")
class FlowNet(_StepModel):
    """UNetFlow: ``image`` is channel 0 and ``flow`` channels 1-2."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = dict(config)
        self.unetflow = UNetFlow(
            recurrent_block_type=str(config.get("recurrent_block_type", "convlstm")),
            kernel_size=int(config.get("kernel_size", 5)), **_unet_common(config))

    def forward(self, voxel: torch.Tensor, state) -> Tuple[Dict[str, torch.Tensor], Tuple]:
        out, new_state = self.unetflow(voxel, state)
        return {"image": out[:, 0:1], "flow": out[:, 1:3]}, new_state

    def initial_state(self, batch: int, height: int, width: int) -> Tuple:
        return self.unetflow.initial_state(batch, height, width, **self._like_params())
