"""Event IO and voxelization (counterpart of ``bde2vid_tpu/events``; the
rest of its ``voxel.py``, the event images, warps and padding helpers, is
still to port: ROADMAP A11)."""

from bde2vid_tpu_torch.events.h5_io import H5EventReader, H5EventWriter
from bde2vid_tpu_torch.events.voxel import events_to_neg_pos_voxel, events_to_voxel, hot_event_mask

__all__ = [
    "events_to_voxel",
    "events_to_neg_pos_voxel",
    "hot_event_mask",
    "H5EventReader",
    "H5EventWriter",
]
