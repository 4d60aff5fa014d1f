"""Serving: ahead-of-time exported model bundles (``torch.export``);
counterpart of ``bde2vid_tpu/serving``.

One :class:`ServingBundle` (a zip file) holds the exported programs
(``forward`` and its tails for sequence models; ``step`` + ``init_state``
for streaming recurrent models), the weights they take, stored once, and
JSON metadata (model name and config, input shapes, platform, torch
version). A server runs it with torch and the port's ``ops`` package: no
model source, no checkpoint parsing.
"""

from bde2vid_tpu_torch.serving.export import (
    ServingBundle,
    export_forward,
    export_spec_bundle,
    load_bundle,
    run_voxels,
    save_bundle,
)

__all__ = [
    "ServingBundle",
    "export_forward",
    "export_spec_bundle",
    "load_bundle",
    "run_voxels",
    "save_bundle",
]
