"""Training losses (counterpart of ``bde2vid_tpu/losses``; reference
model/losses/losses.py)."""

from bde2vid_tpu_torch.losses.losses import (
    LOSS_REGISTRY,
    L1Loss,
    PerceptualLoss,
    TemporalConsistencyLoss,
    VIPLoss,
    build_loss,
    temporal_consistency_loss,
)

__all__ = [
    "LOSS_REGISTRY",
    "L1Loss",
    "PerceptualLoss",
    "VIPLoss",
    "TemporalConsistencyLoss",
    "build_loss",
    "temporal_consistency_loss",
]
