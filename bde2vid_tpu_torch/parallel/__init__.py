"""Scale-out over ``torch.distributed`` (counterpart of ``bde2vid_tpu/parallel``).

One process per card (``torchrun --nproc_per_node N``): a process group,
a ("data", "spatial") ``DeviceMesh`` with DTensor placements for its
axes, chunk-sharded evaluation (``sharded_eval``), data-parallel training
(``sharded_train``), and the row-sharded forward and train step over the
"spatial" axis (``spatial``: bands of sensor rows with halo exchanges);
``serving.serving_mesh`` serves a batch in shards.
"""

from bde2vid_tpu_torch.parallel.mesh import (
    data_sharding,
    make_mesh,
    replicate,
    shard_batch,
    spatial_sharding,
)
from bde2vid_tpu_torch.parallel.spatial import (
    RowPlan,
    gather_rows,
    group_sum,
    halo_rows,
    row_sharded,
    shard_rows,
    spatial_forward,
)

# the JAX package's public names; the row-sharded forward's names are
# importable from here too, as the JAX package's ``spatial_sharding`` is
__all__ = [
    "make_mesh",
    "data_sharding",
    "replicate",
    "shard_batch",
    "make_dp_train_step",
]


def __getattr__(name):  # lazy, as in the JAX package: sharded_train pulls in the trainer
    if name == "make_dp_train_step":
        from bde2vid_tpu_torch.parallel.sharded_train import make_dp_train_step

        return make_dp_train_step
    raise AttributeError(name)
