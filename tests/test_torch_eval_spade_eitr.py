"""SPADE's event-rate windows and the eval CLI on SPADE and EITR, the port
vs the JAX package on the CPU in f32.

- ``load_sequence`` with SpadeH5 (``ev_rate`` 0.35 by default) and on the
  MMP copy with ``ev_rate`` given: flat sub-windows and ``item_last``
  bit-equal to JAX's, ``len()`` per item, the sub-windows' voxels within
  1e-5.
- The eval CLI on one tiny H5 tree (35x45, padded to 40x48) with a bare
  ``SPADE_E2VID.pth`` (full widths; ``--loader_type H5``, which SPADE reads
  as SpadeH5) and an EITR pytorch-template checkpoint (small widths):
  result, detail and table numbers within 1e-4 of the JAX CLI's at
  ``--subseq_L 3``, and ``--subseq_L 0`` within 1e-6 of 3 (the state
  carries across chunks, sub-voxels included).
"""

import json
import os

import numpy as np
import pytest
import torch

from bde2vid_tpu.data.pipeline import load_sequence as jax_load_sequence
from bde2vid_tpu.eval.__main__ import main as jax_main
from bde2vid_tpu.events.tools import h5_to_memmap
from bde2vid_tpu_torch.data.pipeline import load_sequence
from bde2vid_tpu_torch.eval.__main__ import main as port_main
from bde2vid_tpu_torch.models import build_model
from tests.test_torch_checkpoint_dialects import seeded_state_dict
from tests.test_torch_eval_step_models import _table_numbers, _write_h5
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

EITR_CFG = {"num_bins": 5, "norm": None, "d_model": 32, "dim_feedforward": 64, "nhead": 4,
            "channels": [8, 16, 32, 32]}
CKPTS = ("SPADE_E2VID", "eitr")
OUT_FILES = ("{}_L3_org.txt", "{}_L3_org_detail.txt", "{}_L3_org_table.txt")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """weights/{SPADE_E2VID,eitr}.pth, data/h5/SYN/s1.h5 (5 items of about
    1500 events at 35x45) and its MMP copy data/mmp/SYN/s1/."""
    root = tmp_path_factory.mktemp("spade_eitr_tree")
    os.makedirs(root / "data" / "h5" / "SYN")
    h5 = root / "data" / "h5" / "SYN" / "s1.h5"
    _write_h5(h5, np.random.default_rng(21))
    h5_to_memmap(str(h5), str(root / "data" / "mmp" / "SYN" / "s1"))
    os.makedirs(root / "weights")
    spade = build_model("SPADEE2VID", {}, device="cpu")
    torch.save(seeded_state_dict(spade.generator, 22), str(root / "weights" / "SPADE_E2VID.pth"))
    eitr = build_model("EITR", EITR_CFG, device="cpu")
    torch.save({"arch": "EITR", "config": {"arch": {"args": {"eitr_kwargs": EITR_CFG}}},
                "state_dict": seeded_state_dict(eitr, 23)}, str(root / "weights" / "eitr.pth"))
    return root


@pytest.mark.parametrize("ltype,ev_rate", [("SpadeH5", None), ("MMP", 0.35), ("MMP", 0.05),
                                           ("H5", 0.1)])
def test_event_rate_windows_are_bit_equal_to_jax(tree, ltype, ev_rate):
    sub = "mmp/SYN/s1" if ltype == "MMP" else "h5/SYN/s1.h5"
    path = str(tree / "data" / sub)
    want = jax_load_sequence(path, num_bins=5, ltype=ltype, ev_rate=ev_rate)
    got = load_sequence(path, num_bins=5, ltype=ltype, ev_rate=ev_rate)
    np.testing.assert_array_equal(got.windows, want.windows)
    np.testing.assert_array_equal(got.item_last, want.item_last)
    assert len(got) == len(want) == 5 and len(got.item_last) == 5
    assert len(got.windows) > len(got)  # items split, at the default rate too
    sizes = np.diff(got.windows, axis=1)[:, 0]
    assert (got.windows[1:, 0] == got.windows[:-1, 1]).all() and sizes.min() > 0
    np.testing.assert_allclose(got.voxels(device="cpu", batch=4).numpy(),
                               np.asarray(want.voxels()).reshape(len(got.windows), 5, 35, 45),
                               atol=1e-5, rtol=0)
    assert got.frames().shape == (5, 35, 45) and got.flows() is None


def _cli_args(tree, out_dir, subseq_L=3):
    return ["--weights_dir", str(tree / "weights"), "--data_dir", str(tree / "data"),
            "--datasets", "SYN", "--metrics", "mse", "ssim", "--subseq_L", str(subseq_L),
            "--loader_type", "H5", "--output_dir", str(out_dir)]


@pytest.fixture(scope="module")
def jax_cli(tree, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("BDE2VID_COMPILE_CACHE", str(tmp_path_factory.mktemp("xla_cache")))
    try:
        assert jax_main(_cli_args(tree, tree / "jax")) == 0
    finally:
        mp.undo()
    return tree / "jax"


def _assert_numbers_close(got_path, want_path, atol):
    want, got = json.load(open(want_path)), json.load(open(got_path))
    assert list(got) == list(want) == ["SYN"] and list(got["SYN"]) == list(want["SYN"]) == ["s1"]
    g, w = got["SYN"]["s1"], want["SYN"]["s1"]
    assert sorted(g) == sorted(w) == ["mse", "ssim"]
    for metric in w:
        np.testing.assert_allclose(g[metric], w[metric], atol=atol, rtol=0)


@pytest.fixture(scope="module")
def port_cli(tree):
    assert port_main(_cli_args(tree, tree / "port") + ["--device", "cpu"]) == 0
    return tree / "port"


@pytest.mark.parametrize("ckpt", CKPTS)
def test_eval_cli_matches_the_jax_cli(jax_cli, port_cli, ckpt):
    result, detail, table = (f.format(ckpt) for f in OUT_FILES)
    _assert_numbers_close(port_cli / result, jax_cli / result, 1e-4)
    _assert_numbers_close(port_cli / detail, jax_cli / detail, 1e-4)
    assert len(json.load(open(port_cli / detail))["SYN"]["s1"]["mse"]) == 5  # one score per item
    np.testing.assert_allclose(_table_numbers(port_cli / table), _table_numbers(jax_cli / table),
                               atol=1e-4, rtol=0)


def test_subseq_L_does_not_change_the_numbers(tree, port_cli):
    od0 = tree / "port_L0"
    assert port_main(_cli_args(tree, od0, subseq_L=0) + ["--device", "cpu"]) == 0
    for ckpt in CKPTS:
        _assert_numbers_close(od0 / f"{ckpt}_org_detail.txt", port_cli / OUT_FILES[1].format(ckpt),
                              1e-6)


@pytest.mark.parametrize("ckpt", CKPTS)
def test_entry_points_need_cuda_unless_the_cpu_is_asked_for(tree, monkeypatch, ckpt):
    """``build_model`` and ``load_model_from_torch`` of both families raise
    without CUDA rather than fall back, and run on the CPU when asked."""
    from bde2vid_tpu_torch.eval.checkpoint import load_model_from_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    name, cfg = ("SPADEE2VID", {}) if ckpt.startswith("SPADE") else ("EITR", EITR_CFG)
    path = str(tree / "weights" / f"{ckpt}.pth")
    for call in (lambda: build_model(name, cfg), lambda: load_model_from_torch(path)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert load_model_from_torch(path, device="cpu").device.type == "cpu"
