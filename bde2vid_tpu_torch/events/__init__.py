"""Event IO and rasterization (counterpart of ``bde2vid_tpu/events``;
reference events_contrast_maximization/utils/event_utils.py and
tools/event_packagers.py)."""

from bde2vid_tpu_torch.events.h5_io import H5EventReader, H5EventWriter
from bde2vid_tpu_torch.events.voxel import (
    events_to_image,
    events_to_image_bilinear,
    events_to_image_drv,
    events_to_neg_pos_voxel,
    events_to_timestamp_image,
    events_to_voxel,
    events_to_voxel_accumulate,
    events_to_voxel_timesync,
    events_to_zhu_timestamp_image,
    hot_event_mask,
    pad_events,
    unpack_batched_events,
    warp_events_by_flow,
)

__all__ = [
    "events_to_image",
    "events_to_image_bilinear",
    "events_to_voxel",
    "events_to_voxel_accumulate",
    "events_to_voxel_timesync",
    "events_to_neg_pos_voxel",
    "events_to_timestamp_image",
    "events_to_zhu_timestamp_image",
    "events_to_image_drv",
    "hot_event_mask",
    "pad_events",
    "unpack_batched_events",
    "H5EventReader",
    "H5EventWriter",
    "warp_events_by_flow",
]
