"""The eval CLI's experiment and output flags, the port vs the JAX eval CLI on
the CPU in f32, on one synthetic 32x40 H5 sequence of 6 items with a few hot
pixels and one tiny FireNet template checkpoint: ``--pause_st/--pause_ed``,
``--eq``, ``--filter_hot_events`` and ``--saveim`` with ``--show`` and
``--wait_time`` (no display here, so both viewers warn and go on). The JAX
CLI runs once per flag (module-scoped). Result and detail numbers agree
within 1e-5; the tables have the same layout and numbers within 1e-5 (they
print 8 decimals, and the two frameworks' f32 sums differ in the 7th); the
triptych PNGs decode to images within one grey level.

``--separate_polarity`` feeds a model 2B-channel voxels where it takes B
(both CLIs size the voxels by the checkpoint's ``num_bins``), so with any
checkpoint both CLIs raise at the first forward; the flag's voxels are
compared with JAX's pipeline, and its scoring through both ``evaluate_all``
with a FireNet of 10 input channels over 5 bins a polarity. The hot-pixel
mask is compared bit for bit, its degenerate case included; the pause's
validation errors are JAX's, word for word."""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from bde2vid_tpu.data.pipeline import load_sequence as jax_load_sequence
from bde2vid_tpu.eval.__main__ import main as jax_main
from bde2vid_tpu.eval.checkpoint import load_model_from_torch as jax_load_model
from bde2vid_tpu.eval.driver import EvalConfig as JaxEvalConfig
from bde2vid_tpu.eval.driver import evaluate_all as jax_evaluate_all
from bde2vid_tpu.eval.driver import evaluate_sequence as jax_evaluate_sequence
from bde2vid_tpu.events.h5_io import H5EventWriter
from bde2vid_tpu.events.voxel import hot_event_mask as jax_hot_event_mask
from bde2vid_tpu_torch.data.pipeline import load_sequence
from bde2vid_tpu_torch.eval.__main__ import main as port_main
from bde2vid_tpu_torch.eval.checkpoint import load_model_from_torch
from bde2vid_tpu_torch.eval.driver import EvalConfig, evaluate_all, evaluate_sequence
from bde2vid_tpu_torch.events.voxel import hot_event_mask
from bde2vid_tpu_torch.models import build_model
from tests.test_torch_checkpoint_dialects import seeded_state_dict
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

cv2 = pytest.importorskip("cv2")

SENSOR = (32, 40)
FIRE_CFG = {"num_bins": 5, "base_num_channels": 8}
HOT = [(3, 5), (10, 20), (31, 39), (0, 0), (16, 7)]  # (y, x) pixels that fire far more often
# (run name, CLI flags, result file stem)
FLAG_RUNS = {
    "pause": (["--pause_st", "1", "--pause_ed", "3", "--max_length", "8"], "firenet_org_1_3"),
    "eq": (["--eq", "--subseq_L", "3"], "firenet_L3_org"),
    "hot": (["--filter_hot_events", "--subseq_L", "3"], "firenet_L3_org"),
    "saveim": (["--saveim", "{out}/png", "--show", "--wait_time", "2", "--subseq_L", "3"],
               "firenet_L3_org"),
}


def _write_h5(path, rng, num_frames=7, n=9000):
    h, w = SENSOR
    hot = rng.integers(0, len(HOT), size=n // 10)
    xs = np.concatenate([rng.integers(0, w, size=n), [HOT[i][1] for i in hot]]).astype(np.int32)
    ys = np.concatenate([rng.integers(0, h, size=n), [HOT[i][0] for i in hot]]).astype(np.int32)
    order = rng.permutation(len(xs))
    xs, ys = xs[order], ys[order]
    ts = np.sort(rng.uniform(0.0, 1.0, size=len(xs)))
    ps = rng.choice([False, True], size=len(xs))
    with H5EventWriter(str(path), sensor_size=SENSOR) as wr:
        wr.append_events(xs, ys, ts + 10.0, ps)
        for i in range(num_frames):
            wr.add_image(rng.uniform(0, 255, SENSOR).astype(np.uint8), 10.0 + (i + 0.5) / num_frames)


def _firenet(root, name, cfg, seed):
    fire = build_model("FireNet", cfg, device="cpu")
    torch.save({"arch": "FireNet", "config": {"arch": {"args": cfg}},
                "state_dict": seeded_state_dict(fire, seed)}, str(root / name))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """data/h5/SYN/s1.h5 (6 items), weights/firenet.pth (5 bins) and
    weights10/firenet10.pth (10 input channels)."""
    root = tmp_path_factory.mktemp("flag_tree")
    os.makedirs(root / "data" / "h5" / "SYN")
    _write_h5(root / "data" / "h5" / "SYN" / "s1.h5", np.random.default_rng(23))
    for sub, name, cfg, seed in (("weights", "firenet.pth", FIRE_CFG, 24),
                                 ("weights10", "firenet10.pth", dict(FIRE_CFG, num_bins=10), 25)):
        os.makedirs(root / sub)
        _firenet(root / sub, name, cfg, seed)
    return root


def _cli_args(tree, out, flags, weights="weights"):
    return (["--weights_dir", str(tree / weights), "--data_dir", str(tree / "data"),
             "--datasets", "SYN", "--metrics", "mse", "ssim", "--output_dir", str(out)]
            + [f.format(out=out) for f in flags])


@pytest.fixture(scope="module")
def jax_runs(tree, tmp_path_factory):
    """Each flag's JAX CLI run: {run: (output dir, stdout)}."""
    cache = tmp_path_factory.mktemp("xla_cache")
    mp = pytest.MonkeyPatch()
    mp.setenv("BDE2VID_COMPILE_CACHE", str(cache))
    mp.delenv("DISPLAY", raising=False)
    mp.delenv("WAYLAND_DISPLAY", raising=False)
    runs = {}
    try:
        for run, (flags, _) in FLAG_RUNS.items():
            out = tree / f"jax_{run}"
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert jax_main(_cli_args(tree, out, flags)) == 0
            runs[run] = (out, buf.getvalue())
    finally:
        mp.undo()
    return runs


def _close(got_path, want_path, atol=1e-5):
    got, want = json.load(open(got_path)), json.load(open(want_path))
    assert list(got) == list(want) == ["SYN"]
    for seq, metrics in want["SYN"].items():
        assert sorted(got["SYN"][seq]) == sorted(metrics)
        for metric, val in metrics.items():
            np.testing.assert_allclose(got["SYN"][seq][metric], val, atol=atol, rtol=0)


_NUMBER = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


@pytest.mark.parametrize("run", sorted(FLAG_RUNS))
def test_eval_cli_flag_matches_jax_cli(tree, jax_runs, run, monkeypatch, capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    flags, stem = FLAG_RUNS[run]
    out = tree / f"port_{run}"
    assert port_main(_cli_args(tree, out, flags) + ["--device", "cpu"]) == 0
    jd, jax_stdout = jax_runs[run]
    files = [f"{stem}.txt", f"{stem}_detail.txt", f"{stem}_table.txt"]
    assert sorted(f for f in os.listdir(out) if f.endswith(".txt")) == sorted(files)
    assert sorted(f for f in os.listdir(jd) if f.endswith(".txt")) == sorted(files)
    _close(out / files[0], jd / files[0])
    _close(out / files[1], jd / files[1])
    steps = 8 if run == "pause" else 6
    assert all(len(v) == steps for v in json.load(open(out / files[1]))["SYN"]["s1"].values())
    got_table, want_table = open(out / files[2]).read(), open(jd / files[2]).read()
    assert len(got_table.splitlines()) == len(want_table.splitlines())
    np.testing.assert_allclose([float(v) for v in _NUMBER.findall(got_table)],
                               [float(v) for v in _NUMBER.findall(want_table)], atol=1e-5, rtol=0)
    if run == "saveim":
        pngs = sorted(os.listdir(out / "png"))
        assert pngs == sorted(os.listdir(jd / "png")) == [f"frame_{i:010d}.png" for i in range(6)]
        for name in pngs:
            got = cv2.imread(str(out / "png" / name), cv2.IMREAD_UNCHANGED).astype(int)
            want = cv2.imread(str(jd / "png" / name), cv2.IMREAD_UNCHANGED).astype(int)
            assert got.shape == want.shape == (SENSOR[0], 3 * SENSOR[1])
            assert np.abs(got - want).max() <= 1, name
        warning = "warning: --show disabled (no display in this environment)"
        assert warning in jax_stdout and warning in capsys.readouterr().out


@pytest.mark.parametrize("case", ["random", "degenerate", "sequence"])
def test_hot_event_mask_is_bit_equal_to_jax(tree, case):
    """Random counts, fewer than 100 pixels with a positive sum (the
    argmax then picks zeroed pixels again), and the mask of the synthetic
    sequence as each pipeline builds it."""
    rng = np.random.default_rng(31)
    h, w = SENSOR
    if case == "sequence":
        path = str(tree / "data" / "h5" / "SYN" / "s1.h5")
        got = load_sequence(path, num_bins=5, hot_filter=True).hot_mask
        want = jax_load_sequence(path, num_bins=5, hot_filter=True).hot_mask
        assert (got == 0).sum() == 100 and all(got[y, x] == 0 for y, x in HOT)
    else:
        n = 4000 if case == "random" else 300
        pixels = w * h if case == "random" else 60
        flat = rng.integers(0, pixels, size=n)
        xs, ys = flat % w, flat // w
        ps = rng.choice([-1.0, 1.0], size=n) if case == "degenerate" else np.abs(rng.normal(size=n))
        got = hot_event_mask(xs, ys, ps, SENSOR, num_hot=100)
        want = jax_hot_event_mask(xs, ys, ps, SENSOR, num_hot=100)
        if case == "degenerate":
            assert (got == 0).sum() < 100
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


PAUSE_ERRORS = {
    "unpaired": dict(pause_st=1, pause_ed=None),
    "negative": dict(pause_st=3, pause_ed=1),
    "beyond": dict(pause_st=6, pause_ed=8),
    "event_rate": dict(pause_st=1, pause_ed=2),
}


@pytest.fixture(scope="module")
def specs(tree):
    path = str(tree / "weights" / "firenet.pth")
    return load_model_from_torch(path, device="cpu"), jax_load_model(path)


@pytest.mark.parametrize("case", sorted(PAUSE_ERRORS))
def test_pause_validation_matches_jax(tree, specs, case):
    path = str(tree / "data" / "h5" / "SYN" / "s1.h5")
    ltype = "SpadeH5" if case == "event_rate" else "H5"
    kw = dict(metrics=("mse",), subseq_L=None, **PAUSE_ERRORS[case])
    messages = []
    for evaluate, spec, cfg, seq in (
            (evaluate_sequence, specs[0], EvalConfig(**kw), load_sequence(path, ltype=ltype)),
            (jax_evaluate_sequence, specs[1], JaxEvalConfig(**kw), jax_load_sequence(path, ltype=ltype))):
        with pytest.raises(ValueError) as err:
            evaluate(spec, seq, cfg)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("hot,normalize", [(False, False), (True, False), (True, True)])
def test_separate_polarity_voxels_match_jax(tree, hot, normalize):
    path = str(tree / "data" / "h5" / "SYN" / "s1.h5")
    kw = dict(num_bins=5, combined_voxel_channels=False, hot_filter=hot, normalize=normalize)
    want = np.asarray(jax_load_sequence(path, **kw).voxels())
    got = load_sequence(path, **kw).voxels(device="cpu", batch=4).numpy()
    assert got.shape == want.shape == (6, 10, *SENSOR)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    combined = load_sequence(path, num_bins=5, hot_filter=hot).voxels(device="cpu").numpy()
    if not normalize:  # positive bins first: the two halves sum to the |p| weights
        assert np.abs(got[:, :5] - got[:, 5:]).max() > 0
        assert np.allclose(got[:, :5] - got[:, 5:], combined, atol=1e-5)


def test_separate_polarity_scores_like_jax(tree):
    """A FireNet of 10 input channels over 5 bins a polarity, scored by
    both packages' evaluate_all: the same files, numbers within 1e-5."""
    path = str(tree / "weights10" / "firenet10.pth")
    data = str(tree / "data" / "h5")
    kw = dict(num_bins=5, combined_voxel_channels=False, metrics=("mse", "ssim"), subseq_L=4)
    out_port, out_jax = tree / "sep_port" / "firenet10.txt", tree / "sep_jax" / "firenet10.txt"
    evaluate_all(load_model_from_torch(path, device="cpu"), ["SYN/s1.h5"], data, str(out_port),
                 EvalConfig(**kw))
    jax_evaluate_all(jax_load_model(path), ["SYN/s1.h5"], data, str(out_jax), JaxEvalConfig(**kw),
                     progress=False)
    for suffix in ("", "_detail"):
        _close(out_port.with_name(f"firenet10{suffix}.txt"), out_jax.with_name(f"firenet10{suffix}.txt"))


def test_separate_polarity_cli_refuses_a_b_channel_model_like_jax(tree):
    """Both CLIs size the voxels by the checkpoint's num_bins: with
    --separate_polarity a 5-bin FireNet gets 10 channels, and both raise at
    its first layer instead of scoring."""
    for main, extra in ((jax_main, []), (port_main, ["--device", "cpu"])):
        with pytest.raises(Exception, match="10"):
            main(_cli_args(tree, tree / "sep_cli", ["--separate_polarity"]) + extra)
