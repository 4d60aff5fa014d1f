"""Event windowing, sequence assembly and prefetch (counterpart of
``bde2vid_tpu/data``)."""

from bde2vid_tpu_torch.data.pipeline import EventSequence, SequenceItem, load_sequence
from bde2vid_tpu_torch.data.prefetch import prefetch_to_device
from bde2vid_tpu_torch.data.windowing import (
    between_frames_windows,
    k_events_windows,
    t_seconds_windows,
)

__all__ = [
    "between_frames_windows",
    "k_events_windows",
    "t_seconds_windows",
    "EventSequence",
    "SequenceItem",
    "load_sequence",
    "prefetch_to_device",
]
