"""Device ms a frame under the ``voxels`` range: event packing's copies and
the voxel scatter (``data/pipeline.py``, ``native/evpack``, ``events/voxel.py``)."""


def read(t):
    ms = t["device_ms"].get("bench.voxels")
    return None if ms is None else ms / t["frames"]
