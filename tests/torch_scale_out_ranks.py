"""The rank side of the scale-out tests (``tests/test_torch_scale_out*.py``).

``spawn_group`` starts one gloo group of CPU ranks (``torch.multiprocessing``
with a ``FileStore``) that runs every named case in order. A case reads the
inputs that the test module wrote under ``work/<case>`` and writes what each
rank got there (``rank<r>.pt``). A spawned child re-imports the module of its
target, so this module imports neither JAX nor the JAX package: the children
run the port alone. Each child runs torch on one intra-op thread.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from pathlib import Path

import torch

RANKS = 4


def spawn_group(work: Path, cases, ranks: int = RANKS, timeout: float = 600.0) -> None:
    """Run ``cases`` (names of the ``case_*`` functions below) in one group
    of ``ranks`` CPU ranks; raises if any rank fails (the others are
    terminated) or if the group is not done within ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(_rank_main, args=(ranks, str(work), list(cases)), nprocs=ranks, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.terminate()
            raise TimeoutError(f"the group of {ranks} ranks ran past {timeout} s: {cases}")


def _rank_main(index: int, ranks: int, work: str, cases) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(work, "store"), ranks)
    dist.init_process_group("gloo", store=store, rank=index, world_size=ranks,
                            timeout=datetime.timedelta(seconds=300))
    try:
        for name in cases:
            globals()[f"case_{name}"](Path(work) / name, index, ranks)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def _save(folder: Path, index: int, obj) -> None:
    torch.save(obj, folder / f"rank{index}.pt")


def _model(folder: Path, key: str, device="cpu"):
    from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked
    from bde2vid_tpu_torch.models import build_model

    meta = json.loads((folder / f"{key}.json").read_text())
    model = build_model(meta["name"], meta["config"], device=device, train=meta.get("train", False))
    load_state_dict_checked(model, torch.load(folder / f"{key}.pt"))
    return model, meta


# ------------------------------------------------------------------ library


def case_mesh(folder: Path, index: int, ranks: int) -> None:
    """make_mesh, its placements and shard_batch inside the group."""
    from bde2vid_tpu_torch.parallel import (data_sharding, make_mesh, replicate, shard_batch,
                                            spatial_sharding)

    mesh = make_mesh(ranks, 1)
    try:
        make_mesh(2 * ranks, 1)
        too_many = None
    except ValueError as err:
        too_many = str(err)
    x = torch.arange(ranks * 2 * 3).reshape(ranks * 2, 3)
    tree = {"a": x, "b": (2 * x,), "n": 7}
    rows = shard_batch(mesh, tree)
    cols = shard_batch(None, x.T.contiguous(), batch_axis=1)
    _save(folder, index, {
        "shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
        "coordinate": mesh.get_coordinate(), "too_many": too_many,
        "rows": rows["a"], "rows_b": rows["b"][0], "n": rows["n"], "cols": cols,
        "placements": [repr(p) for p in (data_sharding(mesh, 5, 1) + replicate(mesh)
                                         + spatial_sharding(mesh, 5, 1, 2))],
    })


def case_eval(folder: Path, index: int, ranks: int) -> None:
    """eval_chunks_sharded of every model the test module wrote."""
    from bde2vid_tpu_torch.models import ModelSpec
    from bde2vid_tpu_torch.parallel.sharded_eval import eval_chunks_sharded

    out = {}
    for key in json.loads((folder / "keys.json").read_text()):
        model, meta = _model(folder, key)
        model.eval()
        spec = ModelSpec(name=meta["name"], module=model, num_bins=5,
                         num_encoders=meta["num_encoders"],
                         is_sequence_model=meta["is_sequence_model"])
        voxels = torch.load(folder / f"{key}_voxels.pt")
        out[key] = eval_chunks_sharded(spec, voxels, meta["chunk"])
    _save(folder, index, out)


def case_dp_step(folder: Path, index: int, ranks: int) -> None:
    """One make_dp_train_step step of each model on this rank's rows."""
    from bde2vid_tpu_torch.parallel import make_dp_train_step, shard_batch
    from bde2vid_tpu_torch.train import SequenceLossComputer

    out = {}
    for key in json.loads((folder / "keys.json").read_text()):
        model, meta = _model(folder, key)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=meta["eps"])
        step = make_dp_train_step(model, opt, SequenceLossComputer([{"type": "L1Loss"}]))
        batch = torch.load(folder / f"{key}_batch.pt")
        voxels, frames = shard_batch(None, (batch["voxels"], batch["frames"]), batch_axis=1)
        loss = step(voxels, frames)
        names = {p: n for n, p in model.named_parameters()}
        out[key] = {
            "loss": {k: float(v) for k, v in loss.items()},
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "exp_avg": {names[p]: s["exp_avg"] for p, s in opt.state.items()},
            "exp_avg_sq": {names[p]: s["exp_avg_sq"] for p, s in opt.state.items()},
        }
    _save(folder, index, out)


def case_serving(folder: Path, index: int, ranks: int) -> None:
    """Each data-parallel bundle over the whole batch, and the rank checks."""
    from bde2vid_tpu_torch.serving import load_bundle, run_voxels, serving_mesh

    out = {}
    for key in json.loads((folder / "keys.json").read_text()):
        bundle = load_bundle(str(folder / f"{key}.zip"))
        out[key] = torch.from_numpy(run_voxels(bundle, torch.load(folder / f"{key}_voxels.pt")))
    mesh = serving_mesh(ranks)
    out["mesh"] = (tuple(mesh.shape), mesh.mesh_dim_names)
    try:
        serving_mesh(2 * ranks)
        out["too_few"] = None
    except ValueError as err:
        out["too_few"] = str(err)
    _save(folder, index, out)


# ---------------------------------------------------------------------- CLIs


def case_train_cli(folder: Path, index: int, ranks: int) -> None:
    """The train CLI data-parallel for two steps (with its .state files),
    then resumed from the first step's .state."""
    from bde2vid_tpu_torch.train.__main__ import main

    args = json.loads((folder / "args.json").read_text())
    common = ["--config", args["config"], "--data_dir", args["data_dir"], "--device", "cpu",
              "--batch", str(args["batch"]), "--save_state"]
    assert main(common + ["--out_dir", str(folder / "dp")]) == 0
    assert main(common + ["--out_dir", str(folder / "resumed"),
                          "--resume", str(folder / "dp" / "epoch_1.state")]) == 0
    try:  # a batch that does not divide over the ranks
        main(common[:-3] + ["--batch", str(ranks + 2), "--out_dir", str(folder / "refused")])
        refused = None
    except SystemExit as err:
        refused = str(err)
    gathered = [None] * ranks
    torch.distributed.all_gather_object(gathered, refused)
    if index == 0:
        (folder / "refused.json").write_text(json.dumps(gathered))


def case_eval_cli(folder: Path, index: int, ranks: int) -> None:
    """The eval CLI with --shard_data."""
    from bde2vid_tpu_torch.eval.__main__ import main

    args = json.loads((folder / "args.json").read_text())
    assert main(args + ["--output_dir", str(folder / "sharded"), "--shard_data"]) == 0


# ------------------------------------------------- the card (gloo on cuda:0)


def case_cuda_dp_step(folder: Path, index: int, ranks: int) -> None:
    """The data-parallel step on the card through the kernels, every rank on
    cuda:0 (gloo runs its collectives on CUDA tensors)."""
    from bde2vid_tpu_torch.ops.window_attn_cuda import launch_counts
    from bde2vid_tpu_torch.parallel import make_dp_train_step, shard_batch
    from bde2vid_tpu_torch.train import SequenceLossComputer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, _ = _model(folder, "model", device="cuda")
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = make_dp_train_step(model, opt, SequenceLossComputer([{"type": "L1Loss"}]))
    batch = torch.load(folder / "batch.pt")
    voxels, frames = (t.cuda() for t in shard_batch(None, (batch["voxels"], batch["frames"]),
                                                     batch_axis=1))
    launch_counts.clear()
    loss = step(voxels, frames)
    torch.cuda.synchronize()
    _save(folder, index, {"loss": float(loss["loss"]), "launches": dict(launch_counts),
                          "state": {k: v.cpu() for k, v in model.state_dict().items()},
                          "moments": {k: opt.state[p]["exp_avg"].cpu()
                                      for k, p in model.named_parameters() if p in opt.state}})


def case_cuda_serving(folder: Path, index: int, ranks: int) -> None:
    """A data-parallel kernel-path bundle on the card, every rank on cuda:0."""
    from bde2vid_tpu_torch.ops.window_attn_cuda import launch_counts
    from bde2vid_tpu_torch.serving import load_bundle, run_voxels

    bundle = load_bundle(str(folder / "bundle.zip"))
    launch_counts.clear()
    images = run_voxels(bundle, torch.load(folder / "voxels.pt").cuda())
    torch.cuda.synchronize()
    _save(folder, index, {"images": torch.from_numpy(images), "launches": dict(launch_counts)})
