"""The port's eval CLI over the other backends (ENPY, NPY, H5VOX) and over a
``.msgpack`` checkpoint, and the train CLI resumed from a ``.msgpack``, on
the CPU with tiny models:

- one recording as an H5 file (with its voxel cache inside), the raw-NPY
  layout (ENPY) and the pre-voxelized tree (NPY): each backend's result
  file within 1e-4 of the H5 run's (the bar of tests/test_torch_eval.py);
- ``epoch_3.pth`` beside ``epoch_3.msgpack`` of the same weights: one CLI
  call scores both into their own result files, equal bit for bit;
  checkpoints sort by epoch number;
- ``--resume`` of the JAX package's ``.msgpack`` (E2VIDRecurrent with
  BatchNorm): the losses of ``--resume`` of the same weights as a ``.pth``,
  bit for bit; an orbax directory is refused by name.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.train.trainer import save_checkpoint as jax_save_checkpoint
import bde2vid_tpu_torch.train.__main__ as ttm
from bde2vid_tpu_torch.eval.__main__ import main as port_main
from bde2vid_tpu_torch.eval.__main__ import read_checkpoints, read_datafiles, result_names
from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked, state_dict_from_jax
from bde2vid_tpu_torch.eval.msgpack_checkpoint import save_msgpack_checkpoint
from bde2vid_tpu_torch.events.h5_io import H5EventReader, H5EventWriter
from bde2vid_tpu_torch.events.tools import h5_precompute_voxels, h5_to_prevoxelized_npy
from bde2vid_tpu_torch.models import build_model
from bde2vid_tpu_torch.train.trainer import save_checkpoint
from tests.conftest import make_events
from tests.test_torch_data_backends import write_enpy
from tests.test_torch_e2vid import seeded_tree

SENSOR = (36, 44)
BDE2VID_CFG = {"generator": {"num_bins": 5, "basechannels": 4, "num_encoders": 2, "ks": 3,
                             "num_res_blocks": 1, "buffer_index": [-1, 0, 1], "depths": [1, 1],
                             "num_heads": 2, "window_size": [4, 4]}}
E2VID_BN = {"num_bins": 5, "num_encoders": 2, "base_num_channels": 8, "num_residual_blocks": 1,
            "norm": "BN"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """data/h5/SYN/s1.h5 (its voxel cache inside), data/npy/SYN/raw_s1 (the
    same events and the frames the H5 items pair with, one window a frame)
    and data/npy/SYN/vox_s1 (the pre-voxelized tree); weights/epoch_3.pth
    and epoch_3.msgpack of one small BDE2VID."""
    root = tmp_path_factory.mktemp("backends")
    rng = np.random.default_rng(13)
    xs, ys, ts, ps = make_events(rng, n=9000, sensor_size=SENSOR, t1=1.0)
    ts = ts.astype(np.float64) + 10.0
    h5 = root / "data" / "h5" / "SYN" / "s1.h5"
    os.makedirs(h5.parent)
    with H5EventWriter(str(h5), sensor_size=SENSOR) as w:
        w.append_events(xs, ys, ts, ps > 0)
        for i in range(6):
            w.add_image(rng.integers(0, 256, SENSOR).astype(np.uint8), 10.0 + (i + 0.5) / 6)
    with H5EventReader(str(h5)) as r:
        ends = r.frame_event_indices[:-1]
        frames = np.stack([r.frame_raw(i) for i in range(r.num_frames - 1)])
        frame_ts = r.frame_timestamps[:-1] + r.t0
    write_enpy(str(root / "data" / "npy" / "SYN" / "raw_s1"), xs.astype(np.int16),
               ys.astype(np.int16), ts, (ps > 0).astype(np.uint8), frames, frame_ts,
               np.stack([np.concatenate([[0], ends[:-1]]), ends], 1))
    h5_to_prevoxelized_npy(str(h5), str(root / "data" / "npy" / "SYN" / "vox_s1"))
    h5_precompute_voxels(str(h5))
    torch.manual_seed(14)
    model = build_model("BDE2VID", BDE2VID_CFG, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.3)
    os.makedirs(root / "weights")
    save_checkpoint(str(root / "weights" / "epoch_3.pth"), model, "BDE2VID", BDE2VID_CFG)
    save_msgpack_checkpoint(str(root / "weights" / "epoch_3.msgpack"), model, "BDE2VID",
                            BDE2VID_CFG)
    return root


def _eval(tree, ltype, out, datasets=("SYN",)):
    assert port_main(["--weights_dir", str(tree / "weights"), "--data_dir", str(tree / "data"),
                      "--datasets", *datasets, "--metrics", "mse", "ssim", "--subseq_L", "3",
                      "--loader_type", ltype, "--output_dir", str(out), "--device", "cpu"]) == 0
    return {f: json.load(open(out / f)) for f in os.listdir(out) if not f.endswith("table.txt")}


@pytest.fixture(scope="module")
def h5_run(tree, tmp_path_factory):
    return _eval(tree, "H5", tmp_path_factory.mktemp("h5_run"))


def _numbers(results):
    """{(file, metric or step): value} of result and detail files, keyed
    without the sequence's name."""
    out = {}
    for f, res in results.items():
        for seq in res["SYN"].values():
            for metric, v in seq.items():
                for i, x in enumerate(np.atleast_1d(v)):
                    out[(f, metric, i)] = float(x)
    return out


def test_msgpack_and_pth_score_bit_equal(h5_run):
    assert sorted(h5_run) == ["epoch_3_msgpack_L3_org.txt", "epoch_3_msgpack_L3_org_detail.txt",
                              "epoch_3_pth_L3_org.txt", "epoch_3_pth_L3_org_detail.txt"]
    for kind in ("L3_org.txt", "L3_org_detail.txt"):
        assert h5_run[f"epoch_3_msgpack_{kind}"] == h5_run[f"epoch_3_pth_{kind}"]
    assert len(h5_run["epoch_3_pth_L3_org_detail.txt"]["SYN"]["s1"]["mse"]) == 5


@pytest.mark.parametrize("ltype,datasets", [("ENPY", ("raw_s1",)), ("NPY", ("vox_s1",)),
                                            ("H5VOX", ("SYN",))])
def test_backend_scores_match_the_h5_run(tree, h5_run, tmp_path, ltype, datasets):
    got = _numbers(_eval(tree, ltype, tmp_path, datasets))
    want = _numbers(h5_run)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, k


def test_read_datafiles_and_checkpoints(tree, tmp_path):
    for ltype, sub in (("NPY", "npy"), ("ENPY", "npy"), ("H5VOX", "h5"), ("MMP", "mmp")):
        files, root = read_datafiles(str(tree / "data"), ["SYN"], ltype)
        assert root == str(tree / "data" / sub)
        assert files == {"npy": ["SYN/raw_s1", "SYN/vox_s1"], "h5": ["SYN/s1.h5"],
                         "mmp": []}[sub]
    for name in ("epoch_10.msgpack", "epoch_9.pth", "epoch_9.msgpack", "best.pth"):
        (tmp_path / name).write_bytes(b"")
    ckpts = read_checkpoints(str(tmp_path), 0, -1)
    assert [os.path.basename(c) for c in ckpts] == ["epoch_9.msgpack", "epoch_9.pth",
                                                    "epoch_10.msgpack", "best.pth"]
    assert sorted(result_names(ckpts).values()) == ["best", "epoch_10", "epoch_9_msgpack",
                                                    "epoch_9_pth"]


@pytest.fixture(scope="module")
def resume_files(tree, tmp_path_factory):
    """The JAX package's E2VIDRecurrent (BatchNorm) checkpoint and the same
    weights as a ``.pth``; a training config of it."""
    root = tmp_path_factory.mktemp("resume")
    jm = jax_build("E2VIDRecurrent", E2VID_BN)
    x = jax.numpy.zeros((1, 16, 16, 5))
    init = lambda: jm.init(jax.random.PRNGKey(0), x, jm.initial_state(1, 16, 16))
    variables = jax.tree_util.tree_map(np.asarray, seeded_tree(jax.eval_shape(init), 15))
    jax_save_checkpoint(str(root / "epoch_5.msgpack"), variables, "E2VIDRecurrent", E2VID_BN)
    model = build_model("E2VIDRecurrent", E2VID_BN, device="cpu")
    load_state_dict_checked(model, state_dict_from_jax(variables))
    save_checkpoint(str(root / "epoch_5.pth"), model, "E2VIDRecurrent", E2VID_BN)
    cfg = {"name": "resume", "model": {"type": "E2VIDRecurrent", "args": E2VID_BN},
           "losses": [{"type": "L1Loss"}],
           "optimizer": {"type": "Adam", "args": {"lr": 1e-3}},
           "data": {"sequence_length": 3, "num_bins": 5, "crop_size": 24},
           "train": {"steps": 2, "ckpt_every": 2}}
    (root / "cfg.json").write_text(json.dumps(cfg))
    return root


def _train(root, data, out, resume):
    assert ttm.main(["--config", str(root / "cfg.json"), "--data_dir", str(data),
                     "--out_dir", str(out), "--device", "cpu", "--resume", str(resume)]) == 0
    return [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]


def test_train_resumes_from_a_jax_msgpack(tree, resume_files, tmp_path):
    data = tree / "data" / "h5"
    got = _train(resume_files, data, tmp_path / "msgpack", resume_files / "epoch_5.msgpack")
    want = _train(resume_files, data, tmp_path / "pth", resume_files / "epoch_5.pth")
    assert [r["step"] for r in got] == [0, 1]
    assert [r["loss"] for r in got] == [r["loss"] for r in want]
    a = torch.load(tmp_path / "msgpack" / "epoch_2.pth", weights_only=False)["state_dict"]
    b = torch.load(tmp_path / "pth" / "epoch_2.pth", weights_only=False)["state_dict"]
    assert all(torch.equal(a[k], b[k]) for k in b)


def test_train_refuses_an_orbax_directory(tree, resume_files, tmp_path):
    state = tmp_path / "epoch_2.state"
    os.makedirs(state)
    (tmp_path / "epoch_2.state.json").write_text('{"train_state": true}')
    with pytest.raises(ValueError, match="orbax"):
        _train(resume_files, tree / "data" / "h5", tmp_path / "out", state)
