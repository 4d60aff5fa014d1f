"""Data-parallel evaluation over the ranks of a process group (counterpart of
``bde2vid_tpu/parallel/sharded_eval.py``).

The eval protocol resets recurrent state at every ``subseq_L`` chunk
(reference bde2vid.py:31 with eval_models_seq.py:216-219), so chunks are
independent: the natural data-parallel unit. The chunks are split into one
contiguous block a rank, as ``P("data")`` splits them, each rank runs its
own chunks one after another, and an ``all_gather`` gives every rank all T
images.

- Step models: T counts as padded with zero chunks to a multiple of the
  ranks, as in JAX. A forward-only model's outputs do not depend on later
  frames, so a partial chunk runs at its own length and a chunk wholly in
  the padding is not run: its rows are zeros, cut off after the gather.
- Sequence models (BDE2VID): a ragged tail is never zero-padded (the
  backward sweep and the temporal attention would see the synthetic
  frames); it runs as its own unsharded forward, on the last rank, and is
  broadcast from there.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from bde2vid_tpu_torch.models.api import ModelSpec, run_sequence
from bde2vid_tpu_torch.parallel.mesh import data_group


class ChunkPlan:
    """Which items of a T-item sequence each of ``ranks`` ranks runs, in
    chunks of ``chunk``. The sharded items are [0, t_full); the chunk count
    is padded up to a multiple of the ranks, each rank takes ``rows``
    consecutive items (some of them padding); a sequence model's ragged
    tail [t_full, t) runs on ``tail_rank``."""

    def __init__(self, t: int, chunk: int, ranks: int, sequence_model: bool):
        self.t, self.chunk, self.ranks = t, chunk, ranks
        self.t_full = (t // chunk) * chunk if sequence_model else t
        n_chunks = -(-self.t_full // chunk)
        self.rows = -(-n_chunks // ranks) * chunk
        self.tail_rank = ranks - 1

    def block(self, index: int) -> Tuple[int, int]:
        """[lo, hi) of the real items in rank ``index``'s block."""
        lo = min(index * self.rows, self.t_full)
        return lo, min(lo + self.rows, self.t_full)

    def chunks(self, index: int) -> List[Tuple[int, int]]:
        lo, hi = self.block(index)
        return [(a, min(a + self.chunk, hi)) for a in range(lo, hi, self.chunk)]

    @property
    def tail(self) -> Optional[Tuple[int, int]]:
        return (self.t_full, self.t) if self.t_full < self.t else None


def gather_blocks(plan: ChunkPlan, local: Optional[torch.Tensor], frame_shape: Sequence[int],
                  group=None, tail: Optional[torch.Tensor] = None,
                  dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """(t, *frame_shape) on every rank from each rank's ``local`` rows (its
    block's real items; None for none) and the ``tail`` rows that
    ``plan.tail_rank`` holds. One ``all_gather`` of equal blocks and, where
    there is a tail, one ``broadcast``: collectives that gloo runs on CUDA
    tensors too."""
    if local is not None:
        dtype, device = local.dtype, local.device
    elif tail is not None:
        dtype, device = tail.dtype, tail.device
    shape = tuple(frame_shape)
    index = dist.get_rank(group) if plan.ranks > 1 else 0
    parts = []
    if plan.rows:
        buf = torch.zeros((plan.rows, *shape), dtype=dtype, device=device)
        if local is not None:
            buf[:len(local)] = local
        if plan.ranks > 1:
            gathered = [torch.empty_like(buf) for _ in range(plan.ranks)]
            dist.all_gather(gathered, buf, group=group)
        else:
            gathered = [buf]
        parts.append(torch.cat(gathered)[:plan.t_full])
    if plan.tail is not None:
        if plan.ranks > 1:
            if index != plan.tail_rank:
                tail = torch.empty((plan.t - plan.t_full, *shape), dtype=dtype, device=device)
            src = plan.tail_rank if group is None else dist.get_global_rank(group, plan.tail_rank)
            dist.broadcast(tail, src=src, group=group)
        parts.append(tail)
    return torch.cat(parts)


def run_chunks_sharded(spec: ModelSpec, voxels_of: Callable[[int, int], torch.Tensor], t: int,
                       chunk: int, hw: Tuple[int, int], mesh=None) -> torch.Tensor:
    """The per-chunk forward with chunks sharded over the "data" ranks.

    ``voxels_of(a, b)`` gives the model input of items [a, b) of [0, t),
    (b - a, 1, B, H, W) padded to ``hw`` and in the model's type; each rank
    asks only for its own chunks (and the tail rank for the tail). Every
    chunk starts from fresh state. Returns the (t, 1, 1, H, W) f32 images
    on every rank."""
    group, ranks, index = data_group(mesh)
    plan = ChunkPlan(t, chunk, ranks, spec.is_sequence_model)
    h, w = hw

    def run(a: int, b: int) -> torch.Tensor:
        x = voxels_of(a, b)
        with torch.no_grad():
            if spec.is_sequence_model:
                images = spec.module(x)["image"]
            else:
                images = run_sequence(spec.module, x, spec.initial_state(1, h, w))[0]
        return images.float()

    own = [run(a, b) for a, b in plan.chunks(index)]
    tail = run(*plan.tail) if plan.tail is not None and index == plan.tail_rank else None
    return gather_blocks(plan, torch.cat(own) if own else None, (1, 1, h, w), group, tail,
                         device=spec.device)


def eval_chunks_sharded(spec: ModelSpec, voxels: torch.Tensor, chunk: int,
                        mesh=None) -> torch.Tensor:
    """Run the per-chunk forward over ``voxels`` (T, 1, B, H, W), already
    padded to the model's stride, with the chunks sharded across the ranks
    of ``mesh``'s "data" axis (the default group without a mesh; one
    process without a group). Semantics identical to the sequential
    driver's chunk resets. Returns the (T, 1, 1, H, W) f32 images on every
    rank."""
    return run_chunks_sharded(spec, lambda a, b: voxels[a:b].to(spec.dtype), voxels.shape[0],
                              chunk, tuple(voxels.shape[-2:]), mesh)
