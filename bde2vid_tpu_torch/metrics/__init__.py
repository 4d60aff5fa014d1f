"""Image-quality metrics (counterpart of ``bde2vid_tpu/metrics``).

Reference protocol (evaluate/metrics.py): per step ``mse = F.mse_loss``,
``ssim = skimage.structural_similarity`` per batch element (mean over the
batch), ``p_loss = LPIPS net-lin/alex v0.1`` on inputs scaled to [-1, 1]
with gray replicated to 3 channels.
"""

from bde2vid_tpu_torch.metrics.basic import mse, structural_similarity
from bde2vid_tpu_torch.metrics.lpips import (
    LPIPS,
    load_lpips_state,
    lpips_distance,
    score_2afc,
    score_2afc_dataset,
    score_jnd,
    score_jnd_dataset,
    voc_ap,
)
from bde2vid_tpu_torch.metrics.lpips_util import (
    bootstrap,
    im2tensor,
    lab2rgb,
    montage,
    psnr as psnr255,
    rgb2lab,
    tensor2im,
)

__all__ = [
    "bootstrap",
    "im2tensor",
    "lab2rgb",
    "montage",
    "psnr255",
    "rgb2lab",
    "tensor2im",
    "mse",
    "structural_similarity",
    "LPIPS",
    "load_lpips_state",
    "lpips_distance",
    "score_2afc",
    "score_2afc_dataset",
    "score_jnd",
    "score_jnd_dataset",
    "voc_ap",
]
