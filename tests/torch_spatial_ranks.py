"""The rank side of ``tests/test_torch_spatial.py``: the row-sharded forward
and train step (``bde2vid_tpu_torch/parallel/spatial.py``) in one gloo group
of four CPU ranks.

``start_group`` starts the group (``torch.multiprocessing`` with a
``FileStore``) and returns at once, so that the test module computes the JAX
references while the ranks run; ``wait`` joins it. The group runs every case
in order: a case reads what the test module wrote under ``work/<case>`` and
writes what each rank got there (``rank<r>.pt``). A spawned child re-imports
this module, so it imports neither JAX nor the JAX package. Each child runs
torch on one intra-op thread.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from pathlib import Path

import torch

RANKS = 4
CASES = ("halo", "forward", "refusals", "train")


def start_group(work: Path, ranks: int = RANKS):
    import torch.multiprocessing as mp

    return mp.spawn(_rank_main, args=(ranks, str(work)), nprocs=ranks, join=False)


def wait(group, timeout: float = 300.0) -> None:
    """Join the group; raises if a rank failed (the others are terminated)
    or if it is not done within ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not group.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in group.processes:
                proc.terminate()
            raise TimeoutError(f"the spatial group ran past {timeout} s")


def _rank_main(index: int, ranks: int, work: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(work, "store"), ranks)
    dist.init_process_group("gloo", store=store, rank=index, world_size=ranks,
                            timeout=datetime.timedelta(seconds=300))
    try:
        for name in CASES:
            globals()[f"case_{name}"](Path(work) / name, index, ranks)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def _save(folder: Path, index: int, obj) -> None:
    torch.save(obj, folder / f"rank{index}.pt")


def _model(folder: Path, key: str, train: bool = False):
    from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked
    from bde2vid_tpu_torch.models import build_model

    meta = json.loads((folder / f"{key}.json").read_text())
    torch.manual_seed(0)  # what the state dict leaves (BDE2VID's unused fusion_layers)
    model = build_model(meta["name"], meta["config"], device="cpu", train=train)
    load_state_dict_checked(model, torch.load(folder / f"{key}.pt"))
    return model, meta


def case_halo(folder: Path, index: int, ranks: int) -> None:
    """halo_rows on a group of the first three ranks: a (2, rows, 3) band
    per rank at level 1 of a plan of 24 rows over 3 (bands of 4 at level 1),
    each rank reading different counts past its band; the forward and the
    gradient of sum(w * out) for a seeded w."""
    import torch.distributed as dist

    from bde2vid_tpu_torch.parallel.spatial import RowPlan, exchange_counts, halo_rows, row_sharded

    spec = json.loads((folder / "spec.json").read_text())
    sub = dist.new_group(list(range(spec["ranks"])))
    if index >= spec["ranks"]:
        return
    plan = RowPlan(spec["height"], spec["levels"], spec["ranks"])
    whole = torch.load(folder / "whole.pt")
    lo, hi = plan.band(index, spec["level"])
    x = whole[:, lo:hi].clone().requires_grad_()
    exchange_counts.clear()
    with row_sharded(plan, sub):
        out = halo_rows(x, spec["above"], spec["below"], dim=1)
    weight = torch.load(folder / f"weight{index}.pt")
    (out * weight).sum().backward()
    _save(folder, index, {"out": out.detach(), "grad": x.grad, **exchange_counts})


def _band_shapes(model):
    """Forward pre-hooks that record the (D, N, rows, W, C) buffer each
    attention level's blocks receive."""
    shapes = []
    for attn in model.generator.feat_attns:
        if attn is not None and hasattr(attn, "blocks"):
            attn.register_forward_pre_hook(lambda m, args: shapes.append(tuple(args[0].shape)))
    return shapes


def case_forward(folder: Path, index: int, ranks: int) -> None:
    """spatial_forward of every model the test module wrote, on the (data,
    spatial) mesh it names, with the attention levels' band shapes of a
    BDE2VID."""
    from bde2vid_tpu_torch.parallel import make_mesh, spatial_forward

    out = {}
    for key, meta in json.loads((folder / "keys.json").read_text()).items():
        n_data, n_spatial = meta["mesh"]
        mesh = make_mesh(n_data, n_spatial)
        model, _ = _model(folder, key)
        shapes = _band_shapes(model) if meta["name"] == "BDE2VID" else None
        voxels = torch.load(folder / f"{key}_voxels.pt")
        if index < n_data * n_spatial:
            with torch.no_grad():
                out[key] = {"images": spatial_forward(model, voxels, mesh),
                            "band_shapes": sorted(set(shapes or ()))}
    _save(folder, index, out)


def case_refusals(folder: Path, index: int, ranks: int) -> None:
    """The families the row-sharded path does not take, under the context."""
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.parallel.spatial import RowPlan, row_sharded

    out = {}
    for key, meta in json.loads((folder / "keys.json").read_text()).items():
        model = build_model(meta["name"], meta["config"], device="cpu")
        voxel = torch.zeros(1, meta["bins"], *meta["hw"])
        plan = RowPlan(meta["hw"][0], 0, ranks)
        state = model.initial_state(1, plan.rows(0)[index], meta["hw"][1])
        with row_sharded(plan):
            try:
                model(voxel[..., :plan.rows(0)[index], :], state)
                out[key] = None
            except ValueError as err:
                out[key] = str(err)
    _save(folder, index, out)


def case_train(folder: Path, index: int, ranks: int) -> None:
    """One make_dp_train_step step on a (2, 2) mesh of each model: this
    "data" rank's rows of the batch, its rows sharded over "spatial"; the
    loss, the reduced gradients and the weights after the step."""
    from bde2vid_tpu_torch.parallel import make_dp_train_step, make_mesh, shard_batch
    from bde2vid_tpu_torch.train import SequenceLossComputer

    mesh = make_mesh(2, 2)
    out = {}
    for key, meta in json.loads((folder / "keys.json").read_text()).items():
        model, _ = _model(folder, key, train=True)
        params = model.parameters()
        opt = (torch.optim.Adam(params, lr=1e-3) if meta["optimizer"] == "adam"
               else torch.optim.SGD(params, lr=1e-2))
        step = make_dp_train_step(model, opt, SequenceLossComputer([{"type": "L1Loss"}]), mesh)
        batch = torch.load(folder / f"{key}_batch.pt")
        voxels, frames = shard_batch(mesh, (batch["voxels"], batch["frames"]), batch_axis=1)
        loss = step(voxels, frames)
        out[key] = {"loss": float(loss["loss"]),
                    "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                              if p.grad is not None},
                    "state": {k: v.clone() for k, v in model.state_dict().items()}}
    _save(folder, index, out)
