"""Scale-out over ``torch.distributed`` (counterpart of ``bde2vid_tpu/parallel``).

One process per card (``torchrun --nproc_per_node N``): a process group,
a ("data", "spatial") ``DeviceMesh`` with DTensor placements for its
axes, chunk-sharded evaluation (``sharded_eval``) and data-parallel
training (``sharded_train``); ``serving.serving_mesh`` serves a batch in
shards. The spatially sharded forward is not ported (ROADMAP A16).
"""

from bde2vid_tpu_torch.parallel.mesh import (
    data_sharding,
    make_mesh,
    replicate,
    shard_batch,
    spatial_sharding,
)

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
