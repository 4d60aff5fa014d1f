"""Host-side native code of the port: the event window packer."""

from bde2vid_tpu_torch.native.evpack import pack_counts, pack_windows, voxelize_batch

__all__ = ["pack_counts", "pack_windows", "voxelize_batch"]
