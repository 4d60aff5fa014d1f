"""Model cost reporting: parameters, operations and bytes per frame
(counterpart of ``bde2vid_tpu/utils/profiling.py``, which reads XLA's
compiled-cost analysis; reference e2vid/base_model.py:28-35).

Counted from one forward on the model's device: ``FlopCounterMode`` for the
products (with the formulas ``ops/window_attn_cuda.py`` registers for the
kernel operators, so the kernel path counts its blocks' products), and a
dispatch mode that adds up the bytes each operator reads and writes.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# allocations that write nothing
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
               torch.ops.aten.empty_strided.default}


class _OperatorBytes(TorchDispatchMode):
    """Bytes each operator reads (its tensor inputs) and writes (its tensor
    outputs), at the tensors' logical sizes, views excepted; and the storage
    of every tensor an operator took."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.read = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        self.read.update(t.data_ptr() for t in inputs)
        if not func.is_view and func not in _NO_TRAFFIC:
            outputs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.nbytes for t in inputs + outputs)
        return out


def model_cost_summary(spec, height: int = 184, width: int = 240, t: int = 2) -> Dict:
    """One forward of ``spec`` on zero voxels (``t`` frames for a sequence
    model, one step for a step model) on its device, per frame:

    - ``params``: the parameters the forward reads (the reference layout
      keeps some that no forward calls, BDE2VID's ``fusion_layers``; the JAX
      package's flax tree holds none of them);
    - ``gflops_per_frame``: ``FlopCounterMode``'s count, the products
      (matmuls, convolutions, the kernel operators' registered formulas);
      elementwise work is not counted. Where B1's windows overhang the
      frame (padding, dilated windows), the kernel path counts the MLP it
      runs on the overhanging tokens too, which the unfused body skips;
    - ``hbm_gb_per_frame``: the bytes each operator reads and writes, an
      unfused count (every intermediate goes to memory and back), where the
      JAX package reports XLA's count after fusion. A kernel operator counts
      its inputs and outputs only.

    The input is padded to a multiple of 2^num_encoders like the eval
    driver's CropParameters."""
    from bde2vid_tpu_torch.utils.padding import optimal_crop_size

    ne = int(getattr(spec, "num_encoders", 0) or 0)
    if ne > 0:
        height = optimal_crop_size(height, ne)
        width = optimal_crop_size(width, ne)
    module, dev, dt = spec.module, spec.device, spec.dtype
    if spec.is_sequence_model:
        args = (torch.zeros((t, 1, spec.num_bins, height, width), device=dev, dtype=dt),)
        frames = t
    else:
        state = module.initial_state(1, height, width)
        args = (torch.zeros((1, spec.num_bins, height, width), device=dev, dtype=dt), state)
        frames = 1
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as flops, _OperatorBytes() as io:
            module(*args)
    finally:
        module.train(was_training)
    params = sum(p.numel() for p in module.parameters() if p.data_ptr() in io.read)
    return {
        "name": spec.name,
        "params": params,
        "gflops_per_frame": flops.get_total_flops() / frames / 1e9,
        "hbm_gb_per_frame": io.bytes / frames / 1e9,
    }
