"""Model families; importing this package registers them."""

from bde2vid_tpu_torch.models import bde2vid  # noqa: F401  (registers BDE2VID)
from bde2vid_tpu_torch.models import e2vid  # noqa: F401  (registers the E2VID family)
from bde2vid_tpu_torch.models import eitr  # noqa: F401  (registers EITR)
from bde2vid_tpu_torch.models import evsnn  # noqa: F401  (registers EVSNN, PAEVSNN)
from bde2vid_tpu_torch.models import spade_e2vid  # noqa: F401  (registers SPADEE2VID)
from bde2vid_tpu_torch.models.api import (
    MODEL_REGISTRY,
    ModelSpec,
    build_model,
    register_model,
    run_sequence,
    run_sequence_chunked,
)

__all__ = ["MODEL_REGISTRY", "ModelSpec", "build_model", "register_model", "run_sequence",
           "run_sequence_chunked"]
