"""Framework utilities: padding, normalisation, timers, json io, flow
visualisation and the model cost summary (counterpart of
``bde2vid_tpu/utils``; its ``enable_compilation_cache`` is the TPU
compiler's and has no counterpart here)."""

from bde2vid_tpu_torch.utils.config import Config, read_json, write_json
from bde2vid_tpu_torch.utils.flow_viz import flow2rgb
from bde2vid_tpu_torch.utils.norm import abs_norm, legacy_norm, quick_norm, robust_1_99, robust_norm
from bde2vid_tpu_torch.utils.padding import CropParameters, optimal_crop_size
from bde2vid_tpu_torch.utils.profiling import model_cost_summary
from bde2vid_tpu_torch.utils.timers import CudaTimer, Timer, timer_summary

__all__ = [
    "optimal_crop_size",
    "CropParameters",
    "legacy_norm",
    "robust_norm",
    "quick_norm",
    "abs_norm",
    "robust_1_99",
    "Timer",
    "CudaTimer",
    "timer_summary",
    "Config",
    "read_json",
    "write_json",
    "flow2rgb",
    "model_cost_summary",
]
