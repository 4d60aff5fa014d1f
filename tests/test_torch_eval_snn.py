"""The SNN entry points of the port vs the JAX package's, on the CPU in f32.

- The eval CLI on two bare SNN state dicts in one weights directory (a path
  with "SNN"): ``PAEVSNN_seeded.pth`` and a lowercase ``evsnn_e10.pth``
  (its dict under ``"model"``), both carrying the dead pooled-MLP tensors
  of reference checkpoints, on a tiny synthetic H5 tree at ``--subseq_L 3``:
  result, detail and table files within 1e-4 of the JAX CLI's. Both are
  robust-normalised by their loaded family (the lowercase file name has no
  "SNN"); without that the numbers differ. ``--subseq_L 0`` gives the same
  detail numbers within 1e-6 (the membranes carry across chunks).
- ``rec_snn`` on a text stream with a 10-line header and epoch-scale
  timestamps (~1.6e9 s): the same PNG names as the JAX ``rec_snn``, pixels
  within 1 level; a checkpoint of another family than ``-network``, a
  ``.pth`` or a ``.msgpack``, is refused, and the entry point needs CUDA
  unless the CPU is asked for.
"""

import json
import os
import re
import struct
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.eval.__main__ import main as jax_main
from bde2vid_tpu.eval.rec_snn import main as jax_rec_snn
from bde2vid_tpu.events.h5_io import H5EventWriter
from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu_torch.data.pipeline import load_sequence
from bde2vid_tpu_torch.eval.__main__ import main as port_main
from bde2vid_tpu_torch.eval.checkpoint import load_model_from_torch, state_dict_from_jax
from bde2vid_tpu_torch.eval.driver import EvalConfig, evaluate_sequence
from bde2vid_tpu_torch.eval.msgpack_checkpoint import save_msgpack_checkpoint
from bde2vid_tpu_torch.eval.rec_snn import main as port_rec_snn
from tests.conftest import make_events
from tests.test_torch_e2vid import seeded_tree
from tests.test_torch_evsnn import dead_tensors
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

SENSOR = (35, 45)  # pads to 40x48 for 3 encoders
CKPTS = {"PAEVSNN_seeded": ("PAEVSNN", False), "evsnn_e10": ("EVSNN", True)}  # (family, wrapped)
OUT_FILES = ["{}_L3_org.txt", "{}_L3_org_detail.txt", "{}_L3_org_table.txt"]
REC_HW, REC_CHUNKS = (20, 24), 3


def _snn_state_dict(name, seed):
    jm = jax_build(name, {})
    init = lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 5)),
                           jm.initial_state(1, 16, 16))
    sd = state_dict_from_jax(seeded_tree(jax.eval_shape(init), seed))
    return {**sd, **dead_tensors(sd)}


@pytest.fixture(scope="module")
def snn_tree(tmp_path_factory):
    """weights_SNN/{PAEVSNN_seeded,evsnn_e10}.pth and data/h5/SYN/s1.h5."""
    root = tmp_path_factory.mktemp("snn_tree")
    rng = np.random.default_rng(31)
    os.makedirs(root / "data" / "h5" / "SYN")
    xs, ys, ts, ps = make_events(rng, n=12000, sensor_size=SENSOR, t1=1.0)
    with H5EventWriter(str(root / "data" / "h5" / "SYN" / "s1.h5"), sensor_size=SENSOR) as w:
        w.append_events(xs, ys, ts.astype(np.float64) + 10.0, ps > 0)
        for i in range(6):
            w.add_image(rng.uniform(0, 255, SENSOR).astype(np.uint8), 10.0 + (i + 0.5) / 6)
    os.makedirs(root / "weights_SNN")
    torch.manual_seed(32)
    for i, (stem, (family, wrapped)) in enumerate(CKPTS.items()):
        sd = _snn_state_dict(family, 33 + i)
        torch.save({"model": sd} if wrapped else sd, str(root / "weights_SNN" / f"{stem}.pth"))
    return root


def _cli_args(tree, out_dir, subseq_L=3):
    return ["--weights_dir", str(tree / "weights_SNN"), "--data_dir", str(tree / "data"),
            "--datasets", "SYN", "--metrics", "mse", "ssim", "--subseq_L", str(subseq_L),
            "--loader_type", "H5", "--output_dir", str(out_dir)]


@pytest.fixture(scope="module")
def jax_cli_dir(snn_tree, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("BDE2VID_COMPILE_CACHE", str(tmp_path_factory.mktemp("xla_cache")))
    try:
        assert jax_main(_cli_args(snn_tree, snn_tree / "jax_out")) == 0
    finally:
        mp.undo()
    return snn_tree / "jax_out"


def _close(got_path, want_path, atol):
    want, got = json.load(open(want_path)), json.load(open(got_path))
    assert list(got) == list(want) == ["SYN"] and list(got["SYN"]) == list(want["SYN"]) == ["s1"]
    for metric, val in want["SYN"]["s1"].items():
        np.testing.assert_allclose(got["SYN"]["s1"][metric], val, atol=atol, rtol=0)


def _numbers(path):
    return [float(v) for v in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", open(path).read())]


def test_snn_eval_cli_matches_jax_cli(snn_tree, jax_cli_dir):
    od = snn_tree / "port_out"
    assert port_main(_cli_args(snn_tree, od) + ["--device", "cpu"]) == 0
    names = sorted(f.format(c) for c in CKPTS for f in OUT_FILES)
    assert sorted(os.listdir(jax_cli_dir)) == sorted(os.listdir(od)) == names
    for stem in CKPTS:
        result, detail, table = (f.format(stem) for f in OUT_FILES)
        _close(od / result, jax_cli_dir / result, 1e-4)
        _close(od / detail, jax_cli_dir / detail, 1e-4)
        np.testing.assert_allclose(_numbers(od / table), _numbers(jax_cli_dir / table), atol=1e-4,
                                   rtol=0)
    od0 = snn_tree / "port_out_L0"
    assert port_main(_cli_args(snn_tree, od0, subseq_L=0) + ["--device", "cpu"]) == 0
    for stem in CKPTS:
        _close(od0 / f"{stem}_org_detail.txt", od / f"{stem}_L3_org_detail.txt", 1e-6)


def test_lowercase_snn_checkpoint_is_robust_normalised(snn_tree, jax_cli_dir):
    """The driver's numbers for evsnn_e10.pth equal the CLI's with robust
    norm on, and move without it."""
    spec = load_model_from_torch(str(snn_tree / "weights_SNN" / "evsnn_e10.pth"), device="cpu")
    assert spec.name == "EVSNN"
    seq = load_sequence(str(snn_tree / "data" / "h5" / "SYN" / "s1.h5"))
    try:
        on, detail_on = evaluate_sequence(spec, seq, EvalConfig(subseq_L=3, robust_norm_output=True))
        off, _ = evaluate_sequence(spec, seq, EvalConfig(subseq_L=3))
    finally:
        seq.reader.close()
    want = json.load(open(jax_cli_dir / "evsnn_e10_L3_org_detail.txt"))["SYN"]["s1"]
    np.testing.assert_allclose(detail_on["mse"], want["mse"], atol=1e-4, rtol=0)
    assert abs(on["mse"] - off["mse"]) > 1e-3


# ------------------------------------------------------------------- rec_snn


def _write_stream(path, rng, n):
    h, w = REC_HW
    ts = 1.6e9 + 0.1234 + np.sort(rng.uniform(0.0, 0.5, n))
    with open(path, "w") as fp:
        for i in range(10):
            fp.write(f"# header line {i}\n")
        for t, x, y, p in zip(ts, rng.integers(0, w, n), rng.integers(0, h, n),
                              rng.integers(0, 2, n)):
            fp.write(f"{t:.9f} {x} {y} {p}\n")


def read_gray_png(path):
    """(H, W) uint8 of an 8-bit grayscale PNG with filter 0 on every row."""
    data = open(path, "rb").read()
    pos, idat, size = 8, b"", None
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:]


@pytest.fixture(scope="module")
def rec_inputs(snn_tree):
    stream = snn_tree / "events.txt"
    h, w = REC_HW
    _write_stream(stream, np.random.default_rng(34), REC_CHUNKS * int(h * w * 0.5) + 100)
    return snn_tree / "weights_SNN" / "evsnn_e10.pth", stream


def _rec_args(ckpt, stream, out, network="EVSNN"):
    h, w = REC_HW
    return ["-network", network, "-path_to_pretrain_models", str(ckpt),
            "-path_to_event_files", str(stream), "-save_path", str(out), "-height", str(h),
            "-width", str(w), "-num_events_per_pixel", "0.5"]


def test_rec_snn_matches_jax_rec_snn(rec_inputs, tmp_path):
    ckpt, stream = rec_inputs
    assert jax_rec_snn(_rec_args(ckpt, stream, tmp_path / "jax")) == 0
    assert port_rec_snn(_rec_args(ckpt, stream, tmp_path / "port") + ["--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "port" / "EVSNN"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "EVSNN"))
    assert names == [f"result-idx{i:04d}{j:04d}.png" for i in range(REC_CHUNKS) for j in range(5)]
    for name in names:
        got = read_gray_png(tmp_path / "port" / "EVSNN" / name)
        want = read_gray_png(tmp_path / "jax" / "EVSNN" / name)
        assert got.shape == want.shape == REC_HW
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name
    assert len({read_gray_png(tmp_path / "port" / "EVSNN" / n).tobytes() for n in names}) > 1


def test_rec_snn_refuses_another_family_and_msgpack(rec_inputs, tmp_path):
    ckpt, stream = rec_inputs
    with pytest.raises(SystemExit, match="checkpoint is a EVSNN model but -network says PAEVSNN"):
        port_rec_snn(_rec_args(ckpt, stream, tmp_path, "PAEVSNN") + ["--device", "cpu"])
    msgpack = str(tmp_path / "EVSNN.msgpack")
    save_msgpack_checkpoint(msgpack, load_model_from_torch(str(ckpt), device="cpu").module,
                            "EVSNN", {})
    with pytest.raises(SystemExit, match="checkpoint is a EVSNN model but -network says PAEVSNN"):
        port_rec_snn(_rec_args(msgpack, stream, tmp_path, "PAEVSNN") + ["--device", "cpu"])


def test_rec_snn_needs_cuda_unless_cpu_is_asked_for(rec_inputs, tmp_path, monkeypatch):
    ckpt, stream = rec_inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_rec_snn(_rec_args(ckpt, stream, tmp_path))
