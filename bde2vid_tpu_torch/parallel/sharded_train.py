"""Data-parallel training over the ranks of a process group (counterpart of
``bde2vid_tpu/parallel/sharded_train.py``).

Each rank runs the forward and backward of ``train/trainer.py``'s step on
its own rows of the batch; the gradients and the loss dict are averaged
over the ranks (JAX's ``pmean``: one ``all_reduce`` of one flat buffer
each), then come the global-norm clip and the optimizer step, identical on
every rank, so the weights stay equal everywhere. With equal shards the
mean of the ranks' mean losses is the mean over the whole batch, so the
step is the one-process step on the concatenated batch up to the order of
the sums. The running statistics of BatchNorm / InstanceNorm layers, which
each rank moves with its own rows, are averaged after the step, as JAX
averages its mutated ``batch_stats`` (DDP's ``broadcast_buffers`` would
copy rank 0's instead).

DropPath draws from the generator the caller passes; it must differ
between ranks (``rank_seed``), as JAX folds the axis index into its key.

On a mesh with a "spatial" axis of S > 1 ranks the step is also row-sharded
(``parallel.spatial``, the JAX package's ``spatial_sharding``): each rank
runs the forward on its band of the rows, the images are gathered (each
rank keeps the gradient of its own rows) and every rank of the spatial
group takes the loss of the whole frame, so every loss works. The
parameter gradients are summed over "spatial", each output row counted on
the one rank that computed it, then averaged over "data". The norms'
statistics are the whole map's, so the running statistics agree within a
spatial group. The ranks of one spatial group must draw the same DropPath
masks: seed their generators alike (``rank_seed`` of the "data" index).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from bde2vid_tpu_torch.parallel import spatial
from bde2vid_tpu_torch.parallel.mesh import data_group
from bde2vid_tpu_torch.train.trainer import SequenceLossComputer, train_step


def rank_seed(seed: int, index: int, ranks: int) -> int:
    """The seed of rank ``index``'s DropPath generator: ``seed`` itself in
    a world of one (the one-process run's draws), else a seed derived from
    (seed, index), JAX's ``fold_in`` of the axis index."""
    if ranks == 1:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint32)[0])


def _all_mean(tensors, group, ranks: int, divide: bool = True) -> None:
    """Average ``tensors`` in place over the ranks (sum them, without
    ``divide``): one all_reduce of their concatenation."""
    if ranks == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    if divide:
        flat /= ranks
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def running_statistics(model: torch.nn.Module):
    """The running mean and variance tensors of the model's BatchNorm and
    InstanceNorm layers (those that track them)."""
    out = []
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._NormBase) and m.track_running_stats:
            out += [m.running_mean, m.running_var]
    return out


def broadcast_state(model: torch.nn.Module, mesh=None, src: int = 0) -> None:
    """Copy rank ``src``'s parameters and buffers to every rank (the start
    of a data-parallel run, as DDP does at construction)."""
    group, ranks, _ = data_group(mesh)
    if ranks == 1:
        return
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=src, group=group)


class RankMean:
    """What a data-parallel step adds to ``trainer.train_step``: the
    gradients and the loss dict averaged over the "data" ranks after the
    backward (the gradients first summed over ``spatial_group`` in a
    row-sharded step), and the running statistics after the optimizer step."""

    def __init__(self, model: torch.nn.Module, group, ranks: int, spatial_group=None):
        self.group, self.ranks, self.spatial_group = group, ranks, spatial_group
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.stats = running_statistics(model)

    def _reached(self, group) -> None:
        # a parameter that the loss reaches on some rank but not on this one
        # has a zero gradient here; one that no rank reaches keeps None,
        # which the optimizer skips, as in the one-process step
        reached = torch.tensor([p.grad is not None for p in self.params], dtype=torch.float32,
                               device=self.params[0].device)
        dist.all_reduce(reached, group=group)
        for p, r in zip(self.params, reached.tolist()):
            if p.grad is None and r > 0:
                p.grad = torch.zeros_like(p)

    def mean_gradients(self, losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.spatial_group is not None:
            self._reached(self.spatial_group)
            _all_mean([p.grad for p in self.params if p.grad is not None], self.spatial_group,
                      dist.get_world_size(self.spatial_group), divide=False)
        if self.ranks == 1:
            return losses
        self._reached(self.group)
        _all_mean([p.grad for p in self.params if p.grad is not None], self.group, self.ranks)
        stacked = torch.stack([v.float() for v in losses.values()])
        _all_mean([stacked], self.group, self.ranks)
        return dict(zip(losses, stacked))

    def mean_statistics(self) -> None:
        with torch.no_grad():
            _all_mean(self.stats, self.group, self.ranks)


def make_dp_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                       loss_computer: SequenceLossComputer, mesh=None,
                       grad_clip: Optional[float] = None, scheduler=None,
                       dtype: torch.dtype = torch.float32,
                       remat: bool = False) -> Callable[..., Dict[str, torch.Tensor]]:
    """A data-parallel train step over ``mesh``'s "data" axis (the default
    process group without a mesh), row-sharded over its "spatial" axis
    where that has more than one rank: ``trainer.train_step`` with a
    ``RankMean``, and ``train_step`` itself in a world of one.

    ``step(voxels, frames, flows=None, generator=None) -> loss dict``, with
    the arguments of ``trainer.train_step``; voxels (T, n, B, H, W), frames
    (T, n, 1, H, W) and flows (T, n, 2, H, W) are THIS "data" rank's n rows
    of the batch (``shard_batch``), equal on every rank, with all H rows.
    Returns the detached loss dict averaged over the ranks."""
    group, ranks, _ = data_group(mesh)
    sgroup, sranks, sindex = spatial.spatial_group(mesh) if mesh is not None else (None, 1, 0)
    mean = (RankMean(model, group, ranks, sgroup if sranks > 1 else None)
            if ranks * sranks > 1 else None)
    levels = spatial.model_levels(model)

    def rows(forward, voxels):
        plan = spatial.RowPlan(voxels.shape[-2], levels, sranks)
        with spatial.row_sharded(plan, sgroup):
            local = forward(spatial.shard_rows(voxels, plan, sindex))
        return spatial.gather_rows(local, plan, sgroup)

    def step(voxels: torch.Tensor, frames: torch.Tensor, flows: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        return train_step(model, optimizer, loss_computer, voxels, frames, flows, generator,
                          grad_clip, scheduler, dtype, remat, ranks=mean,
                          rows=rows if sranks > 1 else None)

    return step
