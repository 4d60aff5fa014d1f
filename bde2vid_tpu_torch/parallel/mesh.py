"""Process group, device mesh and placement helpers (counterpart of
``bde2vid_tpu/parallel/mesh.py``).

The JAX package runs one controller over every device and lets XLA insert
the collectives. The port runs one process per card, the PyTorch idiom:
``torchrun --nproc_per_node N -m bde2vid_tpu_torch.{train,eval,serving}``
starts N ranks, each on its own card with a host thread of its own, and
the collectives are ``torch.distributed``'s (NCCL on CUDA, gloo on the
CPU). :func:`init_distributed` joins that group from the ``torchrun``
environment; without it (world size 1) nothing changes.

- ``data`` axis: independent sequences (eval chunks, serving batches) or
  the training batch; each rank holds its contiguous block of rows.
- ``spatial`` axis: the sensor rows. Its placements are here; the
  row-sharded forward and train step, with their halo exchanges, are in
  ``parallel/spatial.py`` and ``parallel/sharded_train.py``.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "spatial")

# How long a rank waits at a collective for the others. Rank 0 alone
# validates, scores the sequences that do not shard and writes the files
# while the other ranks wait, on a real dataset for longer than the
# backends' defaults (10 min on NCCL, whose watchdog then aborts the run).
DEFAULT_TIMEOUT_S = 24 * 3600


def dist_timeout() -> timedelta:
    """The process group's collective timeout: ``$BDE2VID_DIST_TIMEOUT``
    seconds, else ``DEFAULT_TIMEOUT_S``."""
    return timedelta(seconds=float(os.environ.get("BDE2VID_DIST_TIMEOUT", DEFAULT_TIMEOUT_S)))


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if is_distributed() else 0


def init_distributed(device=None) -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (``WORLD_SIZE`` above 1, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``) and return True when this call created
    it; do nothing (False) when a group exists already or the world size is
    1. ``device`` is the entry point's device argument: on CUDA (the
    default) the rank's card, ``cuda:{LOCAL_RANK}``, becomes the current
    device before anything is allocated, and the backend is NCCL; a rank
    with no card of its own raises, it never falls back to the CPU. On the
    CPU the backend is gloo. Collectives wait ``dist_timeout()``."""
    if is_distributed() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= cards:
            raise RuntimeError(f"rank with LOCAL_RANK {local} has no card of its own "
                               f"({cards} visible): start at most one rank per card")
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device("cuda", local),
                                timeout=dist_timeout())
    else:
        dist.init_process_group("gloo", timeout=dist_timeout())
    return True


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1):
    """A ``DeviceMesh`` with dims ("data", "spatial") over the first
    ``n_data * n_spatial`` ranks of the process group (``n_data`` defaults
    to all of them over ``n_spatial``), of "cuda" devices on NCCL and "cpu"
    on gloo. Raises ValueError when there are too few ranks. Every rank of
    the group must call it."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = world_size()
    if n_data is None:
        if n_spatial < 1 or ranks % n_spatial:
            raise ValueError(f"{ranks} ranks do not divide into rows of n_spatial={n_spatial}: "
                             "give n_data, or start a multiple of n_spatial ranks")
        n_data = ranks // n_spatial
    need = n_data * n_spatial
    if need <= 0 or ranks < need:
        raise ValueError(f"make_mesh needs {n_data}x{n_spatial}={need} ranks, found {ranks}: "
                         "start the program with torchrun --nproc_per_node N (a CPU group "
                         "takes --device cpu)")
    if not is_distributed():
        raise ValueError("make_mesh needs an initialized process group (init_distributed)")
    return DeviceMesh(mesh_device_type(), torch.arange(need).reshape(n_data, n_spatial),
                      mesh_dim_names=AXES)


def mesh_device_type() -> str:
    """The device type of a mesh over the default group: "cuda" on NCCL,
    "cpu" on gloo (whose collectives take CUDA tensors too)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def data_sharding(mesh, ndim: int, batch_axis: int = 0) -> Tuple:
    """DTensor placements that shard axis ``batch_axis`` over "data" and
    replicate over "spatial"."""
    from torch.distributed.tensor import Replicate, Shard

    _check_axis(ndim, batch_axis)
    return (Shard(batch_axis), Replicate())


def spatial_sharding(mesh, ndim: int, batch_axis: int = 0, h_axis: int = 2) -> Tuple:
    """Placements that shard the batch over "data" and axis ``h_axis`` over
    "spatial"."""
    from torch.distributed.tensor import Shard

    _check_axis(ndim, batch_axis)
    _check_axis(ndim, h_axis)
    return (Shard(batch_axis), Shard(h_axis))


def replicate(mesh) -> Tuple:
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def _check_axis(ndim: int, axis: int) -> None:
    if not 0 <= axis < ndim:
        raise ValueError(f"axis {axis} out of range for {ndim} dims")


def data_group(mesh=None):
    """(group, ranks, index) of the "data" axis: the mesh's, else the
    default group's; (None, 1, 0) without a process group."""
    if mesh is not None:
        group = mesh.get_group("data")
        return group, dist.get_world_size(group), dist.get_rank(group)
    if is_distributed():
        return None, dist.get_world_size(), dist.get_rank()
    return None, 1, 0


def row_block(n: int, ranks: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of rank ``index``'s contiguous block of ``n`` rows, the
    block ``P("data")`` gives; ``n`` must divide over ``ranks``."""
    if n % ranks:
        raise ValueError(f"{n} rows do not divide over {ranks} ranks")
    per = n // ranks
    return index * per, (index + 1) * per


def shard_batch(mesh, tree, batch_axis: int = 0):
    """This rank's rows (its block along ``batch_axis``) of every tensor
    leaf of ``tree``; the batch must divide over the "data" axis."""
    _, ranks, index = data_group(mesh)

    def one(x):
        if not torch.is_tensor(x):
            return x
        lo, hi = row_block(x.shape[batch_axis], ranks, index)
        return x.narrow(batch_axis, lo, hi - lo)

    return torch.utils._pytree.tree_map(one, tree)
