"""Hand-written CUDA kernels and their plain PyTorch twins."""

from bde2vid_tpu_torch.ops.window_attn_cuda import fused_window_attention

__all__ = ["fused_window_attention"]
