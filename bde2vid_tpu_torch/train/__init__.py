"""Training path of the port (counterpart of ``bde2vid_tpu/train``): the
sequence loss, the train step, checkpoints and the optimizer factory."""

from bde2vid_tpu_torch.train.optim import build_optimizer, build_schedule
from bde2vid_tpu_torch.train.trainer import SequenceLossComputer, save_checkpoint, train_step

__all__ = ["build_optimizer", "build_schedule", "SequenceLossComputer", "save_checkpoint", "train_step"]
