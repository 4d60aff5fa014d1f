"""Port parity of the eval path: voxel grids (vs the JAX voxelizer and the
numpy oracle), sequence windows, MSE/PSNR/SSIM, and the eval CLI vs the JAX
eval CLI on tiny synthetic H5 and MMP trees. CPU, f32."""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bde2vid_tpu.data.pipeline import load_sequence as jax_load_sequence
from bde2vid_tpu.eval.__main__ import main as jax_main
from bde2vid_tpu.events.h5_io import H5EventWriter
from bde2vid_tpu.events.tools import h5_to_memmap
from bde2vid_tpu.events.voxel import events_to_voxel_batch as jax_voxel_batch
from bde2vid_tpu.events.voxel_np import events_to_voxel_np
from bde2vid_tpu.metrics import basic as jm
from bde2vid_tpu_torch.data.pipeline import load_sequence
from bde2vid_tpu_torch.eval.__main__ import main as port_main
from bde2vid_tpu_torch.eval.mmengine_cfg import parse_embedded_cfg
from bde2vid_tpu_torch.events.voxel import events_to_voxel, events_to_voxel_batch
from bde2vid_tpu_torch.metrics import basic as tm
from bde2vid_tpu_torch.models import build_model
from tests.conftest import make_events
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

SENSOR = (36, 44)


def _padded_windows(rng, ns, cap, sensor=SENSOR):
    xs = np.zeros((len(ns), cap), np.int32)
    ys = np.zeros((len(ns), cap), np.int32)
    ts = np.zeros((len(ns), cap), np.float32)
    ps = np.zeros((len(ns), cap), np.float32)
    for i, n in enumerate(ns):
        x, y, t, p = make_events(rng, n=n, sensor_size=sensor, t1=0.05)
        xs[i, :n], ys[i, :n], ts[i, :n], ps[i, :n] = x, y, t - (t[0] if n else 0), p
        ts[i, n:] = ts[i, n - 1] if n else 0.0
    return xs, ys, ts, ps, np.asarray(ns, np.int32)


def test_voxel_batch_matches_jax_and_numpy_oracle(rng):
    xs, ys, ts, ps, ns = _padded_windows(rng, [3000, 1, 0, 777, 2048], 3072)
    xs[3, :5] = [-1, 44, 0, 43, 50]  # out-of-range coordinates are dropped
    ys[3, :5] = [0, 0, 36, 35, -3]
    want = np.asarray(jax_voxel_batch(*map(jnp.asarray, (xs, ys, ts, ps, ns)),
                                      num_bins=5, sensor_size=SENSOR))
    got = events_to_voxel_batch(*map(torch.from_numpy, (xs, ys, ts, ps, ns)), num_bins=5,
                                sensor_size=SENSOR).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for i in (0, 4):
        n = ns[i]
        oracle = events_to_voxel_np(xs[i, :n], ys[i, :n], ts[i, :n], ps[i, :n], 5, SENSOR)
        np.testing.assert_allclose(got[i], oracle, atol=1e-5, rtol=0)
        single = events_to_voxel(*(torch.from_numpy(a[i]) for a in (xs, ys, ts, ps)), int(n),
                                 num_bins=5, sensor_size=SENSOR).numpy()
        np.testing.assert_allclose(single, got[i], atol=1e-6, rtol=0)


@pytest.mark.parametrize("fn", ["mse", "psnr", "ssim"])
def test_metrics_match_jax(rng, fn):
    preds = rng.uniform(size=(4, 36, 44)).astype(np.float32)
    gts = np.clip(preds + rng.normal(scale=0.1, size=preds.shape), 0, 1).astype(np.float32)
    if fn == "ssim":
        want = [float(jm.structural_similarity(jnp.asarray(p[None, ..., None]),
                                               jnp.asarray(g[None, ..., None])))
                for p, g in zip(preds, gts)]
        batch = tm.structural_similarity(torch.from_numpy(preds[:, None]), torch.from_numpy(gts[:, None]))
        assert abs(float(batch) - np.mean(want)) <= 1e-6
    else:
        want = [float(getattr(jm, fn)(jnp.asarray(p), jnp.asarray(g))) for p, g in zip(preds, gts)]
    got = getattr(tm, fn)(torch.from_numpy(preds), torch.from_numpy(gts)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 if fn != "psnr" else 1e-4, rtol=0)


def _write_h5(path, rng, num_frames=6):
    xs, ys, ts, ps = make_events(rng, n=9000, sensor_size=SENSOR, t1=1.0)
    with H5EventWriter(str(path), sensor_size=SENSOR) as w:
        w.append_events(xs, ys, ts.astype(np.float64) + 10.0, ps > 0)
        for i in range(num_frames):
            w.add_image(rng.uniform(0, 255, SENSOR).astype(np.uint8), 10.0 + (i + 0.5) / num_frames)


_CFG = """
model = dict(
    type='BDE2VID',
    generator=dict(
        type='BDE2VIDCrossscalePropogationV5',
        num_bins=5, basechannels=4, num_encoders=2, ks=3, num_res_blocks=1,
        buffer_index=[-1, 0, 1], depths=[1, 1], num_heads=2, window_size=(4, 4),
        activation=dict(type='Sigmoid'),
    ),
)
"""


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """weights/epoch_3.pth (a small BDE2VID, numpy-seeded weights) and the
    same two sequences as data/h5/SYN/*.h5 and data/mmp/SYN/*/."""
    root = tmp_path_factory.mktemp("eval_tree")
    rng = np.random.default_rng(7)
    os.makedirs(root / "data" / "h5" / "SYN")
    for name in ("s1", "s2"):
        h5 = root / "data" / "h5" / "SYN" / f"{name}.h5"
        _write_h5(h5, rng)
        h5_to_memmap(str(h5), str(root / "data" / "mmp" / "SYN" / name))
    cfg = parse_embedded_cfg(_CFG)
    cfg.pop("type")
    model = build_model("BDE2VID", cfg, device="cpu")
    sd = {k: torch.from_numpy((rng.normal(size=tuple(v.shape)) * 0.3).astype(np.float32))
          if v.is_floating_point() else v for k, v in model.state_dict().items()}
    os.makedirs(root / "weights")
    torch.save({"meta": {"cfg": _CFG}, "state_dict": sd}, str(root / "weights" / "epoch_3.pth"))
    return root


@pytest.mark.parametrize("ltype", ["H5", "MMP"])
def test_sequence_voxels_match_jax(eval_tree, ltype):
    sub = "h5/SYN/s1.h5" if ltype == "H5" else "mmp/SYN/s1"
    path = str(eval_tree / "data" / sub)
    jseq = jax_load_sequence(path, num_bins=5, ltype=ltype)
    seq = load_sequence(path, num_bins=5, ltype=ltype)
    assert len(seq) == len(jseq)
    np.testing.assert_array_equal(seq.windows, jseq.windows)
    np.testing.assert_allclose(seq.voxels(device="cpu", batch=2).numpy(),
                               np.asarray(jseq.voxels()), atol=1e-5, rtol=0)
    np.testing.assert_allclose(seq.frames(), jseq.frames(), atol=1e-7, rtol=0)


def _table_numbers(path):
    return [float(v) for v in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", open(path).read())]


@pytest.fixture(scope="module")
def jax_cli_results(eval_tree, tmp_path_factory):
    out = {}
    cache = tmp_path_factory.mktemp("xla_cache")
    mp = pytest.MonkeyPatch()
    mp.setenv("BDE2VID_COMPILE_CACHE", str(cache))
    try:
        for ltype in ("H5", "MMP"):
            od = eval_tree / f"jax_{ltype}"
            assert jax_main(_cli_args(eval_tree, ltype, od)) == 0
            out[ltype] = od
    finally:
        mp.undo()
    return out


def _cli_args(tree, ltype, out_dir):
    return ["--weights_dir", str(tree / "weights"), "--data_dir", str(tree / "data"),
            "--datasets", "SYN", "--metrics", "mse", "ssim", "--subseq_L", "3",
            "--loader_type", ltype, "--output_dir", str(out_dir)]


@pytest.mark.parametrize("ltype", ["H5", "MMP"])
@pytest.mark.parametrize("kernel", ["--no-pallas", "--pallas"])
def test_eval_cli_matches_jax_cli(eval_tree, jax_cli_results, ltype, kernel):
    od = eval_tree / f"port_{ltype}{kernel}"
    assert port_main(_cli_args(eval_tree, ltype, od) + ["--device", "cpu", kernel]) == 0
    jd = jax_cli_results[ltype]
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(od)) == [
        "epoch_3_L3_org.txt", "epoch_3_L3_org_detail.txt", "epoch_3_L3_org_table.txt"]
    for name in names[:2]:
        want = json.load(open(jd / name))
        got = json.load(open(od / name))
        assert list(got) == list(want) == ["SYN"]
        assert sorted(got["SYN"]) == sorted(want["SYN"]) == ["s1", "s2"]
        for seq in want["SYN"]:
            for metric, val in want["SYN"][seq].items():
                np.testing.assert_allclose(got["SYN"][seq][metric], val, atol=1e-4, rtol=0)
    np.testing.assert_allclose(_table_numbers(od / names[2]), _table_numbers(jd / names[2]),
                               atol=1e-4, rtol=0)
    # the skip lock: a second run leaves the result untouched
    mtime = os.path.getmtime(od / names[0])
    assert port_main(_cli_args(eval_tree, ltype, od) + ["--device", "cpu", kernel]) == 0
    assert os.path.getmtime(od / names[0]) == mtime
