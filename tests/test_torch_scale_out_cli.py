"""The port's CLIs on one gloo group of four CPU ranks: the train CLI
data-parallel (``--batch 4`` split over the ranks) and the eval CLI with
``--shard_data``, each held to the same CLI in one process.

The group (``tests/torch_scale_out_ranks.py``) trains a small BDE2VID for two
steps with noise, hot pixels, pauses, rotations and a temporal-consistency
loss (``--save_state``), resumes that run from its first ``.state``, and
scores a small BDE2VID checkpoint on an 11-item sequence at ``--subseq_L
2`` (five full chunks over four ranks and a one-item tail) with
``--saveim``. DropPath is off in the trained model, so that the ranks' own
DropPath streams do not enter the comparison with one process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bde2vid_tpu_torch.train.__main__ as ttm
from bde2vid_tpu_torch.eval.__main__ import main as eval_main
from bde2vid_tpu_torch.events.h5_io import H5EventWriter
from bde2vid_tpu_torch.models import build_model
from bde2vid_tpu_torch.train.trainer import save_checkpoint
from tests.conftest import make_events
from tests.torch_scale_out_ranks import RANKS, spawn_group
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread, as in the ranks)

SMALL = {"num_bins": 5, "basechannels": 8, "num_encoders": 2, "ks": 3, "num_res_blocks": 1,
         "buffer_index": [-1, 0, 1], "depths": [2, 0], "num_heads": 4, "window_size": [7, 7],
         "drop_path_rate": 0.0}
TRAIN_CONFIG = {
    "name": "dp",
    "model": {"type": "BDE2VID", "args": {"generator": SMALL}},
    "losses": [{"type": "L1Loss"}, {"type": "TemporalConsistencyLoss", "L0": 0}],
    "optimizer": {"type": "Adam", "args": {"lr": 1e-3, "grad_clip": 1.0}},
    "lr_scheduler": {"type": "StepLR", "args": {"step_size": 1, "gamma": 0.5}},
    "data": {"sequence_length": 3, "num_bins": 5, "proba_pause_when_running": 0.3,
             "proba_pause_when_paused": 0.7, "noise_std": 0.1, "noise_fraction": 0.1,
             "hot_pixel_std": 2.0, "max_hot_pixel_fraction": 0.01,
             "transforms": {"RandomRotationFlip": {"degrees": 10}}},
    "train": {"steps": 2, "ckpt_every": 1},
}
EVAL_ARGS = ["--datasets", "SYN", "--metrics", "mse", "ssim", "--subseq_L", "2", "--device",
             "cpu"]


def _write_h5_seq(path, rng, n_frames, sensor=(20, 24)):
    xs, ys, ts, ps = make_events(rng, n=6000, sensor_size=sensor, t1=1.0)
    with H5EventWriter(str(path), sensor_size=sensor) as w:
        w.append_events(xs, ys, ts, ps > 0)
        for i in range(n_frames):
            t = (i + 0.5) / n_frames
            w.add_image(rng.integers(0, 255, sensor).astype(np.uint8), t)
            w.add_flow(rng.normal(0, 0.5, (2, *sensor)).astype(np.float32), t)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process runs and the group's, in one folder."""
    work = tmp_path_factory.mktemp("scale_out_cli")
    rng = np.random.default_rng(24)
    data = work / "data"
    os.makedirs(data / "h5" / "SYN")
    for name, n in (("a", 8), ("b", 12)):
        _write_h5_seq(data / "h5" / "SYN" / f"{name}.h5", rng, n)
    cfg = work / "cfg.json"
    cfg.write_text(json.dumps(TRAIN_CONFIG))
    weights = work / "weights"
    weights.mkdir()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        model = build_model("BDE2VID", {"generator": SMALL}, device="cpu")
    save_checkpoint(str(weights / "epoch_1.pth"), model, "BDE2VID", {"generator": SMALL})

    (work / "train_cli").mkdir()
    (work / "train_cli" / "args.json").write_text(json.dumps(
        {"config": str(cfg), "data_dir": str(data), "batch": RANKS}))
    eval_args = ["--weights_dir", str(weights), "--data_dir", str(data), *EVAL_ARGS]
    (work / "eval_cli").mkdir()
    (work / "eval_cli" / "args.json").write_text(json.dumps(
        eval_args + ["--saveim", str(work / "eval_cli" / "png_sharded")]))
    spawn_group(work, ["train_cli", "eval_cli"])

    assert ttm.main(["--config", str(cfg), "--data_dir", str(data), "--device", "cpu",
                     "--batch", str(RANKS), "--out_dir", str(work / "one"), "--save_state"]) == 0
    assert eval_main(eval_args + ["--output_dir", str(work / "eval_one"),
                                  "--saveim", str(work / "png_one")]) == 0
    return work


def _state_dict(path):
    return torch.load(path, map_location="cpu", weights_only=True)["state_dict"]


def test_dp_train_cli_matches_the_one_process_batch(runs):
    got = _state_dict(runs / "train_cli" / "dp" / "epoch_2.pth")
    want = _state_dict(runs / "one" / "epoch_2.pth")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
    logs = [[json.loads(line) for line in (runs / d / "train_log.jsonl").read_text().splitlines()]
            for d in ("train_cli/dp", "one")]
    assert [r["step"] for r in logs[0]] == [0, 1]
    for a, b in zip(*logs):
        assert abs(a["loss"] - b["loss"]) <= 1e-6 and abs(a["L_TCL"] - b["L_TCL"]) <= 1e-6


def test_dp_train_cli_resumes_bit_for_bit_from_its_state(runs):
    got = _state_dict(runs / "train_cli" / "resumed" / "epoch_2.pth")
    want = _state_dict(runs / "train_cli" / "dp" / "epoch_2.pth")
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_dp_state_holds_every_rank_s_draws(runs):
    state = torch.load(runs / "train_cli" / "dp" / "epoch_1.state", weights_only=True)
    ranks = state["rank_generators"]
    assert len(ranks) == RANKS and torch.equal(state["generators"]["droppath"],
                                               ranks[0]["droppath"])
    # the augmentation draws over the whole batch on every rank, DropPath
    # draws a stream of each rank's own
    assert all(torch.equal(r["augment"], ranks[0]["augment"]) for r in ranks)
    drops = [r["droppath"] for r in ranks]
    assert all(not torch.equal(drops[i], drops[j]) for i in range(RANKS) for j in range(i))
    one = torch.load(runs / "one" / "epoch_1.state", weights_only=True)
    assert "rank_generators" not in one
    draws = []
    for r in drops:
        g = torch.Generator().manual_seed(0)
        g.set_state(r)
        draws.append(torch.rand(8, generator=g))
    assert len({tuple(d.tolist()) for d in draws}) == RANKS


def test_a_state_resumes_only_at_its_world_size(runs, tmp_path):
    with pytest.raises(ValueError, match="saved by 4 rank"):
        ttm.main(["--config", str(runs / "cfg.json"), "--data_dir", str(runs / "data"),
                  "--device", "cpu", "--batch", str(RANKS), "--out_dir", str(tmp_path),
                  "--resume", str(runs / "train_cli" / "dp" / "epoch_1.state")])


def test_dp_train_cli_refuses_a_batch_that_does_not_divide(runs):
    refused = json.loads((runs / "train_cli" / "refused.json").read_text())
    assert len(refused) == RANKS
    assert all("--batch 6 over 4 ranks" in msg and "divides over the ranks" in msg
               for msg in refused)


def test_shard_data_eval_cli_matches_the_one_process_cli(runs):
    for name in ("epoch_1_L2_org.txt", "epoch_1_L2_org_detail.txt"):
        got = json.loads((runs / "eval_cli" / "sharded" / name).read_text())["SYN"]
        want = json.loads((runs / "eval_one" / name).read_text())["SYN"]
        assert got.keys() == want.keys() == {"a", "b"}
        for seq in want:
            for metric, vals in want[seq].items():
                np.testing.assert_allclose(got[seq][metric], vals, atol=1e-6, rtol=0)
    assert (runs / "eval_cli" / "sharded" / "epoch_1_L2_org_table.txt").exists()
    pngs = sorted(os.listdir(runs / "png_one"))
    assert len(pngs) == 11 and pngs == sorted(os.listdir(runs / "eval_cli" / "png_sharded"))
    for name in pngs:
        assert (runs / "png_one" / name).read_bytes() == \
            (runs / "eval_cli" / "png_sharded" / name).read_bytes()


def test_torchrun_runs_the_sharded_eval_cli_on_a_cpu_gloo_group(runs, tmp_path):
    """The documented launch: ``torchrun`` (``torch.distributed.run``) starts
    two ranks of the eval CLI, which join their gloo group from the
    environment (``parallel.init_distributed``); rank 0's files match the
    one-process CLI's."""
    args = json.loads((runs / "eval_cli" / "args.json").read_text())[:-2]  # no --saveim
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m", "bde2vid_tpu_torch.eval", *args, "--shard_data", "--output_dir", str(tmp_path)]
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    for name in ("epoch_1_L2_org.txt", "epoch_1_L2_org_detail.txt"):
        got = json.loads((tmp_path / name).read_text())["SYN"]
        want = json.loads((runs / "eval_one" / name).read_text())["SYN"]
        for seq in want:
            for metric, vals in want[seq].items():
                np.testing.assert_allclose(got[seq][metric], vals, atol=1e-6, rtol=0)


def test_a_rank_without_a_card_of_its_own_raises(monkeypatch):
    """Under torchrun a rank whose LOCAL_RANK names no card raises; it never
    runs on the CPU instead. A world of one joins no group."""
    from bde2vid_tpu_torch.parallel.mesh import init_distributed

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no card of its own"):
        init_distributed("cuda")
    monkeypatch.setenv("WORLD_SIZE", "1")  # one process: no group, nothing touched
    assert init_distributed("cuda") is False


# two ranks that start together (a file each, so that importing torch puts
# no skew into the rendezvous); rank 0 then works alone for argv[2] seconds
# while rank 1 waits at a barrier, as the CLIs' ranks wait for rank 0's
# validation, unsharded sequences and files
_SLOW_RANK_0 = r"""
import os, sys, time
import torch.distributed as dist
from bde2vid_tpu_torch.parallel.mesh import init_distributed
ready = sys.argv[1]
open(ready + os.environ["RANK"], "w").close()
while not all(os.path.exists(ready + r) for r in "01"):
    time.sleep(0.02)
init_distributed("cpu")
if dist.get_rank() == 0:
    time.sleep(float(sys.argv[2]))
dist.barrier()
print("waited", flush=True)
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_ranks_wait_for_a_slow_rank_0_up_to_the_group_timeout(tmp_path):
    """Rank 0 works alone for 7 s. With ``$BDE2VID_DIST_TIMEOUT`` at 3 s the
    waiting rank's barrier times out, so the group takes its timeout from
    ``dist_timeout()``; without it (24 h) both ranks get through."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = {}
    for case, timeout in (("default", None), ("short", "3")):
        port = str(_free_port())
        for r in (0, 1):
            env = {**os.environ, "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r),
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port, "OMP_NUM_THREADS": "1"}
            env.pop("BDE2VID_DIST_TIMEOUT", None)
            if timeout is not None:
                env["BDE2VID_DIST_TIMEOUT"] = timeout
            procs[case, r] = subprocess.Popen(
                [sys.executable, "-c", _SLOW_RANK_0, str(tmp_path / f"{case}_ready"), "7"],
                cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {k: (*p.communicate(timeout=120), p.returncode) for k, p in procs.items()}
    for r in (0, 1):
        stdout, stderr, rc = out["default", r]
        assert rc == 0 and "waited" in stdout, stderr[-3000:]
    stdout, stderr, rc = out["short", 1]
    assert rc != 0 and "waited" not in stdout
    assert "timed out" in stderr.lower(), stderr[-3000:]


def test_the_group_timeout_defaults_to_a_day(monkeypatch):
    from datetime import timedelta

    from bde2vid_tpu_torch.parallel.mesh import dist_timeout

    monkeypatch.delenv("BDE2VID_DIST_TIMEOUT", raising=False)
    assert dist_timeout() == timedelta(hours=24)
    monkeypatch.setenv("BDE2VID_DIST_TIMEOUT", "90")
    assert dist_timeout() == timedelta(seconds=90)
