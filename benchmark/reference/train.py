"""Plain reference of the flagship's training step as the train CLI takes
it, from the raw recordings and the seeded weights.

Batch: step k of a run of seed s draws from numpy ``default_rng([s, k])``,
for each of its rows in turn (the published SequenceDataset's order, as
the train CLI replays it): a rotation angle uniform in +-degrees and the
horizontal and vertical flips; 20 random sequence indices, then a
permutation of all, the first long enough taken; the window's first item;
the pause chain (step 0 never pauses; a paused step repeats the previous
item with zeroed events); the crop's top and left. The window's voxel
grids (``events.voxel_grid``) and its frames are rotated and flipped over
the whole sensor by bilinear affine sampling (``F.affine_grid``,
``F.grid_sample``, zero padding), then cropped.

Augmentation draws from the augment generator, over the whole batch:
normal and uniform draws of the voxels' shape (noise of ``noise_std`` on
the entries whose uniform draw is below ``noise_fraction``), then for each
row a hot-pixel set: a fraction uniform below ``max_hot_pixel_fraction``,
that many of ``max(int(max fraction H W), 1)`` drawn pixels (x, y, value
normal times ``hot_pixel_std``) added at every step.

Step: the BDE2VID forward in training mode (``bde2vid.forward`` with the
DropPath multipliers of ``bde2vid.drop_path_masks`` from the DropPath
generator), the loss (per frame: L1, and LPIPS of (prediction, target),
each averaged over the frames and summed), its gradient by autograd,
clipped to a global norm, and Adam (torch's defaults: bias-corrected
moments, eps added to the corrected root). Rows are taken in blocks whose
gradients add up to the batch's: both terms are means over equal rows.
Imports nothing of the program under test.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import bde2vid, events, scores

# batch rows of one forward and backward, so that the unfused attention's saved scores fit
ROW_BLOCK = 4
# the leaf whose gradient the "grad_altered" fault doubles
ALTERED_LEAF = "generator.head.conv2d.weight"


def draw_rows(lengths: List[int], sensor: Tuple[int, int], seed: int, step: int, batch: int,
              seq_len: int, crop: Tuple[int, int], data: Dict) -> List[Dict]:
    """The random choices of each row of step ``step``'s batch."""
    rng = np.random.default_rng([int(seed), step])
    rot = data["transforms"]["RandomRotationFlip"]
    rows = []
    for _ in range(batch):
        angle = rng.uniform(-rot["degrees"], rot["degrees"])
        hflip = rng.random() < rot["p_hflip"]
        vflip = rng.random() < rot["p_vflip"]
        cands = [int(rng.integers(len(lengths))) for _ in range(20)]
        cands += [int(i) for i in rng.permutation(len(lengths))]
        seq = next(c for c in cands if lengths[c] >= seq_len)
        start = int(rng.integers(0, lengths[seq] - seq_len + 1))
        idx, paused = np.zeros(seq_len, np.int64), np.zeros(seq_len, bool)
        k, is_paused = 0, False
        for t in range(1, seq_len):
            p = data["proba_pause_when_paused"] if is_paused else data["proba_pause_when_running"]
            is_paused = rng.random() < p
            k += 0 if is_paused else 1
            idx[t], paused[t] = k, is_paused
        y0 = int(rng.integers(0, sensor[0] - crop[0] + 1))
        x0 = int(rng.integers(0, sensor[1] - crop[1] + 1))
        rows.append(dict(seq=seq, start=start, idx=idx, paused=paused, angle=angle, hflip=hflip,
                         vflip=vflip, y0=y0, x0=x0))
    return rows


def _theta(row: Dict, device) -> torch.Tensor:
    a = np.deg2rad(row["angle"])
    m = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0]])
    if row["hflip"]:
        m[:, 0] *= -1
    if row["vflip"]:
        m[:, 1] *= -1
    return torch.tensor(m, dtype=torch.float32, device=device)[None]


class Recordings:
    """The training set's raw arrays: ``seq0``, ``seq1``, ... of ``root``."""

    def __init__(self, root: str):
        names = sorted(d for d in os.listdir(root) if os.path.isfile(os.path.join(root, d, "t.npy")))
        self.seqs = []
        for d in names:
            path = os.path.join(root, d)
            self.seqs.append({k: np.load(os.path.join(path, f"{k}.npy"), mmap_mode="r")
                              for k in ("t", "xy", "p", "images")}
                             | {"frame_ts": np.load(os.path.join(path, "timestamps.npy"))})
        self.lengths = [len(s["frame_ts"]) - 1 for s in self.seqs]

    def window(self, row: Dict, seq_len: int, bins: int, crop, device):
        """(voxels (L, bins, ch, cw), frames (L, 1, ch, cw)) of one row."""
        s = self.seqs[row["seq"]]
        h, w = s["images"].shape[1:3]
        vox = []
        for i in range(row["start"], row["start"] + seq_len):
            i0, i1 = events.item_bounds(s["t"], s["frame_ts"], i)
            vox.append(events.voxel_grid(np.asarray(s["xy"][i0:i1]), np.asarray(s["t"][i0:i1]),
                                         np.asarray(s["p"][i0:i1]), bins, (h, w), device))
        idx = torch.as_tensor(row["idx"], device=device)
        v = torch.stack(vox)[idx] * torch.as_tensor(~row["paused"], device=device).float()[:, None, None, None]
        f = torch.as_tensor(np.array(s["images"][row["start"]:row["start"] + seq_len, ..., 0]),
                            device=device).float()[idx] / 255.0
        grid = F.affine_grid(_theta(row, device), (1, 1, h, w), align_corners=False)

        def rotate(x):
            return F.grid_sample(x.reshape(-1, 1, h, w), grid.expand(x.numel() // (h * w), h, w, 2),
                                 mode="bilinear", padding_mode="zeros", align_corners=False)

        y0, x0 = row["y0"], row["x0"]
        v = rotate(v).view(seq_len, bins, h, w)[..., y0:y0 + crop[0], x0:x0 + crop[1]]
        f = rotate(f).view(seq_len, 1, h, w)[..., y0:y0 + crop[0], x0:x0 + crop[1]]
        return v, f


def augment(voxels: torch.Tensor, generator: torch.Generator, data: Dict) -> torch.Tensor:
    """Noise, then each row's hot pixels: voxels (L, N, bins, H, W)."""
    kw = dict(generator=generator, device=voxels.device)
    normal = torch.randn(voxels.shape, dtype=voxels.dtype, **kw)
    uniform = torch.rand(voxels.shape, **kw)
    voxels = voxels + torch.where(uniform < data["noise_fraction"], data["noise_std"] * normal, 0.0)
    h, w = voxels.shape[-2:]
    most = max(int(data["max_hot_pixel_fraction"] * h * w), 1)
    rows = []
    for n in range(voxels.shape[1]):
        fraction = torch.rand((), **kw) * data["max_hot_pixel_fraction"]
        xs = torch.randint(0, w, (most,), **kw)
        ys = torch.randint(0, h, (most,), **kw)
        vals = torch.randn((most,), **kw) * data["hot_pixel_std"]
        active = (torch.arange(most, device=voxels.device) < (fraction * (h * w)).to(torch.int32)).float()
        img = torch.zeros(h * w, device=voxels.device).index_add_(0, ys * w + xs, vals * active)
        rows.append(voxels[:, n] + img.view(h, w))
    return torch.stack(rows, 1)


def loss_terms(lpips: Dict[str, torch.Tensor], preds: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """L1 + LPIPS, each the mean over frames of its mean over the rows:
    preds, frames (L, N, 1, H, W)."""
    l1 = torch.stack([(p - f).abs().mean() for p, f in zip(preds, frames)]).mean()
    perc = torch.stack([scores.p_loss(lpips, p[:, 0], f[:, 0]).mean() for p, f in zip(preds, frames)]).mean()
    return l1 + perc


class Trainer:
    """The reference's model weights and Adam state, stepped on batches."""

    def __init__(self, state: Dict[str, torch.Tensor], cfg: Dict, lpips: Dict[str, torch.Tensor],
                 optimizer: Dict):
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in state.items()}
        self.cfg, self.lpips = cfg, lpips
        args = optimizer["args"]
        self.lr, self.clip = float(args["lr"]), float(args["grad_clip"])
        self.b1, self.b2 = args.get("betas", (0.9, 0.999))
        self.eps = float(args.get("eps", 1e-8))
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.steps = 0

    def gradients(self, voxels: torch.Tensor, frames: torch.Tensor, masks: Dict,
                  variant: str = "") -> Tuple[float, Dict[str, torch.Tensor]]:
        """(loss, gradients) of the batch. ``variant`` plants a fault:
        "half_batch" takes the loss over the first half of the rows alone,
        "grad_altered" doubles the head conv's gradient where it is made."""
        for p in self.params.values():
            p.grad = None
        n = voxels.shape[1]
        idx = list(range(n // 2 if variant == "half_batch" else n))
        total = 0.0
        for b in range(0, len(idx), ROW_BLOCK):
            sel = idx[b:b + ROW_BLOCK]
            block = {key: tuple(m[sel] for m in pair) for key, pair in masks.items()}
            preds = bde2vid.forward(self.params, self.cfg, voxels[:, sel], block, recompute=True)
            loss = loss_terms(self.lpips, preds, frames[:, sel]) * (len(sel) / len(idx))
            loss.backward()
            total += float(loss.detach())
        grads = {k: p.grad for k, p in self.params.items() if p.grad is not None}
        if variant == "grad_altered":
            grads[ALTERED_LEAF] = 2 * grads[ALTERED_LEAF]
        return total, grads

    def apply(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Clip to the global norm, then one Adam step; the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        coef = min(1.0, self.clip / (float(norm) + 1e-6))
        self.steps += 1
        c1, c2 = 1 - self.b1 ** self.steps, 1 - self.b2 ** self.steps
        out = {}
        with torch.no_grad():
            for k, g in grads.items():
                g = g * coef
                out[k] = g
                m = self.m[k] = self.b1 * self.m.get(k, torch.zeros_like(g)) + (1 - self.b1) * g
                v = self.v[k] = self.b2 * self.v.get(k, torch.zeros_like(g)) + (1 - self.b2) * g * g
                self.params[k] -= self.lr / c1 * m / (torch.sqrt(v) / c2 ** 0.5 + self.eps)
        return out
