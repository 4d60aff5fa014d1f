"""Training path of the port (counterpart of ``bde2vid_tpu/train``): the
sequence loss, the train step, checkpoints and full train states, and the
optimizer factory."""

from bde2vid_tpu_torch.train.optim import build_optimizer, build_schedule
from bde2vid_tpu_torch.train.trainer import (SequenceLossComputer, is_train_state,
                                             restore_train_state, save_checkpoint,
                                             save_train_state, sequence_forward, train_step)

__all__ = ["build_optimizer", "build_schedule", "SequenceLossComputer", "is_train_state",
           "restore_train_state", "save_checkpoint", "save_train_state", "sequence_forward",
           "train_step"]
