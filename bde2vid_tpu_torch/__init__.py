"""bde2vid_tpu_torch — the PyTorch/CUDA port of bde2vid_tpu for NVIDIA Hopper.

Imports ``torch`` and never ``jax`` or ``bde2vid_tpu``. Entry points run on
CUDA unless the caller passes ``device="cpu"``; the four hand-written
kernels (``ops/csrc/swin_block.cu``, ``window_block.cu``,
``window_attention.cu`` and ``attn_core_bwd.cu``) are built with ``nvcc``
at first use.
"""
