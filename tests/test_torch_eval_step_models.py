"""The port's eval CLI on step models vs the JAX eval CLI, on the CPU in
f32: an E2VIDRecurrent template checkpoint (arguments under ``config``) and
a FireNet one (arguments under ``model``, so it asks for LegacyNorm'd voxels
itself), scored together on the same tiny synthetic H5 and MMP trees at
``--subseq_L 3``, without and with ``--normalize``. Result, detail and table
files agree within 1e-4, as the BDE2VID eval test's do
(tests/test_torch_eval.py). A step model carries its state across chunks,
so ``--subseq_L 0`` (one dispatch) gives the same detail numbers within
1e-6; a second run leaves the result file alone (the skip lock). The
normalised voxels match JAX's."""

import json
import os
import re

import numpy as np
import pytest
import torch

from bde2vid_tpu.data.pipeline import load_sequence as jax_load_sequence
from bde2vid_tpu.eval.__main__ import main as jax_main
from bde2vid_tpu.events.h5_io import H5EventWriter
from bde2vid_tpu.events.tools import h5_to_memmap
from bde2vid_tpu_torch.data.pipeline import load_sequence
from bde2vid_tpu_torch.eval.__main__ import main as port_main
from bde2vid_tpu_torch.models import build_model
from tests.conftest import make_events
from tests.test_torch_checkpoint_dialects import seeded_state_dict

SENSOR = (35, 45)  # pads to 36x48 for 2 encoders
E2VID_CFG = {"num_bins": 5, "num_encoders": 2, "base_num_channels": 8, "num_residual_blocks": 1}
FIRE_CFG = {"num_bins": 5, "base_num_channels": 8}
RUNS = [("H5", False), ("H5", True), ("MMP", False), ("MMP", True)]
OUT_FILES = ["{}_L3_org.txt", "{}_L3_org_detail.txt", "{}_L3_org_table.txt"]


def _write_h5(path, rng, num_frames=6):
    xs, ys, ts, ps = make_events(rng, n=9000, sensor_size=SENSOR, t1=1.0)
    with H5EventWriter(str(path), sensor_size=SENSOR) as w:
        w.append_events(xs, ys, ts.astype(np.float64) + 10.0, ps > 0)
        for i in range(num_frames):
            w.add_image(rng.uniform(0, 255, SENSOR).astype(np.uint8), 10.0 + (i + 0.5) / num_frames)


@pytest.fixture(scope="module")
def step_tree(tmp_path_factory):
    """weights/{e2vid,firenet}.pth and two sequences as data/h5/SYN/*.h5
    and data/mmp/SYN/*/."""
    root = tmp_path_factory.mktemp("step_tree")
    rng = np.random.default_rng(17)
    os.makedirs(root / "data" / "h5" / "SYN")
    for name in ("s1", "s2"):
        h5 = root / "data" / "h5" / "SYN" / f"{name}.h5"
        _write_h5(h5, rng)
        h5_to_memmap(str(h5), str(root / "data" / "mmp" / "SYN" / name))
    os.makedirs(root / "weights")
    e2vid = build_model("E2VIDRecurrent", E2VID_CFG, device="cpu")
    torch.save({"arch": "E2VIDRecurrent",
                "config": {"arch": {"args": {"unet_kwargs": E2VID_CFG}}},
                "state_dict": seeded_state_dict(e2vid, 18)}, str(root / "weights" / "e2vid.pth"))
    fire = build_model("FireNet", FIRE_CFG, device="cpu")
    torch.save({"arch": "FireNet", "model": FIRE_CFG, "state_dict": seeded_state_dict(fire, 19)},
               str(root / "weights" / "firenet.pth"))
    return root


def _cli_args(tree, ltype, normalize, out_dir, subseq_L=3):
    return (["--weights_dir", str(tree / "weights"), "--data_dir", str(tree / "data"),
             "--datasets", "SYN", "--metrics", "mse", "ssim", "--subseq_L", str(subseq_L),
             "--loader_type", ltype, "--output_dir", str(out_dir)]
            + (["--normalize"] if normalize else []))


def _run_name(ltype, normalize):
    return f"{ltype}{'_norm' if normalize else ''}"


@pytest.fixture(scope="module")
def jax_cli_results(step_tree, tmp_path_factory):
    cache = tmp_path_factory.mktemp("xla_cache")
    mp = pytest.MonkeyPatch()
    mp.setenv("BDE2VID_COMPILE_CACHE", str(cache))
    out = {}
    try:
        for ltype, normalize in RUNS:
            od = step_tree / f"jax_{_run_name(ltype, normalize)}"
            assert jax_main(_cli_args(step_tree, ltype, normalize, od)) == 0
            out[(ltype, normalize)] = od
    finally:
        mp.undo()
    return out


def _table_numbers(path):
    return [float(v) for v in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", open(path).read())]


def _assert_results_close(got_path, want_path, atol):
    want, got = json.load(open(want_path)), json.load(open(got_path))
    assert list(got) == list(want) == ["SYN"]
    assert sorted(got["SYN"]) == sorted(want["SYN"]) == ["s1", "s2"]
    for seq, metrics in want["SYN"].items():
        assert sorted(got["SYN"][seq]) == sorted(metrics)
        for metric, val in metrics.items():
            np.testing.assert_allclose(got["SYN"][seq][metric], val, atol=atol, rtol=0)


@pytest.mark.parametrize("ltype,normalize", RUNS)
def test_step_model_eval_cli_matches_jax_cli(step_tree, jax_cli_results, ltype, normalize):
    od = step_tree / f"port_{_run_name(ltype, normalize)}"
    args = _cli_args(step_tree, ltype, normalize, od) + ["--device", "cpu"]
    assert port_main(args) == 0
    jd = jax_cli_results[(ltype, normalize)]
    names = sorted(f.format(c) for c in ("e2vid", "firenet") for f in OUT_FILES)
    assert sorted(os.listdir(jd)) == sorted(os.listdir(od)) == names
    for ckpt in ("e2vid", "firenet"):
        result, detail, table = (f.format(ckpt) for f in OUT_FILES)
        _assert_results_close(od / result, jd / result, 1e-4)
        _assert_results_close(od / detail, jd / detail, 1e-4)
        np.testing.assert_allclose(_table_numbers(od / table), _table_numbers(jd / table),
                                   atol=1e-4, rtol=0)

    # one dispatch for the whole sequence: the same numbers, state carried
    od0 = step_tree / f"port_{_run_name(ltype, normalize)}_L0"
    assert port_main(_cli_args(step_tree, ltype, normalize, od0, subseq_L=0) + ["--device", "cpu"]) == 0
    for ckpt in ("e2vid", "firenet"):
        _assert_results_close(od0 / f"{ckpt}_org_detail.txt", od / f"{ckpt}_L3_org_detail.txt", 1e-6)

    # the skip lock: a second run leaves the result untouched
    mtime = os.path.getmtime(od / "e2vid_L3_org.txt")
    assert port_main(args) == 0
    assert os.path.getmtime(od / "e2vid_L3_org.txt") == mtime


@pytest.mark.parametrize("ltype", ["H5", "MMP"])
def test_normalized_voxels_match_jax(step_tree, ltype):
    sub = "h5/SYN/s1.h5" if ltype == "H5" else "mmp/SYN/s1"
    path = str(step_tree / "data" / sub)
    want = np.asarray(jax_load_sequence(path, num_bins=5, ltype=ltype, normalize=True).voxels())
    got = load_sequence(path, num_bins=5, ltype=ltype, normalize=True).voxels(device="cpu", batch=2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    plain = load_sequence(path, num_bins=5, ltype=ltype).voxels(device="cpu")
    assert not np.allclose(got.numpy(), plain.numpy())
