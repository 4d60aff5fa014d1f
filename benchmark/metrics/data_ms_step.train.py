"""Host ms a step spent drawing and augmenting the batch (the window
sampler, voxels, pauses, rotation and crop, noise and hot pixels:
``train/__main__.py``, ``data/pipeline.py``, ``data/transforms.py``), with
one sync at the end of the range."""


def read(t):
    return t["data_ms"] / t["steps"]
