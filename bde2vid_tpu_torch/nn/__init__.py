"""Neural-network building blocks (counterpart of ``bde2vid_tpu/nn``)."""

from bde2vid_tpu_torch.nn.layers import (
    ConvLayer,
    PixelShufflePack,
    ResidualBlock,
    TransposedConvLayer,
    UpsampleConvLayer,
    get_activation,
    skip_concat,
    skip_sum,
)
from bde2vid_tpu_torch.nn.recurrent import (
    ConvGRUCell,
    ConvLSTMCell,
    RecurrentConvLayer,
    RecurrentResidualLayer,
)

__all__ = [
    "ConvLayer",
    "TransposedConvLayer",
    "UpsampleConvLayer",
    "PixelShufflePack",
    "ResidualBlock",
    "get_activation",
    "skip_sum",
    "skip_concat",
    "ConvLSTMCell",
    "ConvGRUCell",
    "RecurrentConvLayer",
    "RecurrentResidualLayer",
]
