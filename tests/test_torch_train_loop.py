"""The rest of one-card training in the port, on the CPU: exact resume from
a full train state, ``--resume`` of a weights file, held-out validation vs
the JAX package's ``Validator``, and ``--prefetch``.

- A CLI run of 4 steps with ``--save_state`` (validating every step), and
  a run resumed from its ``epoch_2.state``: ``epoch_4.pth``, every tensor of
  ``epoch_4.state`` and the losses of steps 2-3 equal bit for bit, for
  BDE2VID with DropPath 0.2, pause, noise, hot pixels, rotation, StepLR and
  gradient clipping, and for E2VIDRecurrent with BatchNorm.
- ``--resume epoch_2.pth`` loads the weights and starts at step 0 with a
  fresh optimizer and schedule.
- The port's ``Validator`` vs JAX's on the same held-out tree with the same
  weights (JAX's seeded init, carried to the port by ``state_dict_from_jax``):
  MSE and SSIM within 2e-4; ``val_log.jsonl`` gets one record a round and
  ``best.pth`` is written only when MSE improves.
- ``--prefetch 2`` gives the losses of ``--prefetch 0`` bit for bit and leaves
  no thread behind; a producer's error surfaces in the consumer.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.events.h5_io import H5EventWriter
from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.train.validate import Validator as JaxValidator
import bde2vid_tpu_torch.train.__main__ as ttm
from bde2vid_tpu_torch.data.prefetch import Prefetcher
from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked, state_dict_from_jax
from bde2vid_tpu_torch.models import build_model
from bde2vid_tpu_torch.train.validate import Validator
from tests.conftest import make_events
from tests.test_torch_parallel_nwindow import concrete_gathers  # noqa: F401 (a fixture)

SEQ_LEN = 3
_SMALL = {"num_bins": 5, "basechannels": 8, "num_encoders": 2, "ks": 3, "num_res_blocks": 1,
          "buffer_index": [-1, 0, 1], "depths": [2, 0], "num_heads": 4, "window_size": [7, 7]}
E2VID_BN = {"num_bins": 5, "num_encoders": 2, "base_num_channels": 8, "num_residual_blocks": 1,
            "norm": "BN"}
MODELS = {
    "BDE2VID": {"generator": dict(_SMALL, drop_path_rate=0.2), "use_pallas_attention": True},
    "E2VIDRecurrent": E2VID_BN,
}



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one intra-op thread: the step loops are many small ops, each
    a parallel region that, beside other test processes on the same cores,
    waits on descheduled threads (tens of times slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _write_tree(root, seed, sensors):
    rng = np.random.default_rng(seed)
    os.makedirs(root / "SYN")
    for i, (sensor, n) in enumerate(sensors):
        xs, ys, ts, ps = make_events(rng, n=6000, sensor_size=sensor, t1=1.0)
        with H5EventWriter(str(root / "SYN" / f"s{i}.h5"), sensor_size=sensor) as w:
            w.append_events(xs, ys, ts, ps > 0)
            for k in range(n):
                w.add_image(rng.integers(0, 255, sensor).astype(np.uint8), (k + 0.5) / n)
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(training tree, held-out tree) of H5 sequences."""
    root = tmp_path_factory.mktemp("loop")
    train = _write_tree(root / "train", 41, [((20, 24), 8), ((22, 26), 10)])
    val = _write_tree(root / "val", 42, [((16, 20), 7), ((18, 20), 9)])
    return train, val


def _config(tmp_path, name, **train):
    cfg = {
        "name": "loop", "model": {"type": name, "args": MODELS[name]},
        "losses": [{"type": "L1Loss"}],
        "optimizer": {"type": "Adam", "args": {"lr": 1e-3, "grad_clip": 1.0}},
        "lr_scheduler": {"type": "StepLR", "args": {"step_size": 1, "gamma": 0.5}},
        "data": {"sequence_length": SEQ_LEN, "num_bins": 5, "proba_pause_when_running": 0.3,
                 "proba_pause_when_paused": 0.7, "noise_std": 0.1, "noise_fraction": 0.1,
                 "hot_pixel_std": 2.0, "max_hot_pixel_fraction": 0.01,
                 "transforms": {"RandomRotationFlip": {"degrees": 10}}},
        "train": {"steps": 4, "ckpt_every": 2, **train},
    }
    path = tmp_path / f"cfg_{name}.json"
    path.write_text(json.dumps(cfg))
    return path


def _train(cfg_path, data, out, *flags):
    assert ttm.main(["--config", str(cfg_path), "--data_dir", str(data), "--out_dir", str(out),
                     "--device", "cpu", *flags]) == 0
    return [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module", params=sorted(MODELS))
def full_run(request, trees, tmp_path_factory):
    """The uninterrupted 4-step run of one family, validating every step."""
    name = request.param
    tmp = tmp_path_factory.mktemp(f"full_{name}")
    train, val = trees
    cfg_path = _config(tmp, name)
    out = tmp / "full"
    log = _train(cfg_path, train, out, "--save_state", "--val_dir", str(val), "--val_every", "1",
                 "--val_windows", "2")
    return name, cfg_path, out, log


def _state_tensors(tree, prefix=""):
    """Every tensor and number of a nested train state, by path."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_state_tensors(v, f"{prefix}/{k}"))
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_exact_resume_is_bit_equal(full_run, trees, tmp_path):
    name, cfg_path, full, full_log = full_run
    assert [r["step"] for r in full_log] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in full_log)
    state = full / "epoch_2.state"
    assert json.loads((full / "epoch_2.state.json").read_text()) == {
        "model": name, "config": MODELS[name], "train_state": True}
    resumed = tmp_path / "resumed"
    log = _train(cfg_path, trees[0], resumed, "--resume", str(state), "--save_state")
    assert [r["step"] for r in log] == [2, 3]
    for a, b in zip(log, full_log[2:]):
        assert {k: v for k, v in a.items() if k.startswith("L") or k == "loss"} == \
               {k: v for k, v in b.items() if k.startswith("L") or k == "loss"}
    load = lambda p: torch.load(p, map_location="cpu", weights_only=False)
    _assert_same(_state_tensors(load(resumed / "epoch_4.pth")["state_dict"]),
                 _state_tensors(load(full / "epoch_4.pth")["state_dict"]))
    want = load(full / "epoch_4.state")
    got = load(resumed / "epoch_4.state")
    assert got["step"] == want["step"] == 4
    assert set(got) == {"model", "optimizer", "scheduler", "step", "generators"}
    assert got["optimizer"]["state"]  # Adam moments are in it
    _assert_same(_state_tensors(got), _state_tensors(want))


def test_resume_from_weights_starts_fresh_at_step_zero(full_run, trees, tmp_path):
    name, cfg_path, full, full_log = full_run
    out = tmp_path / "from_pth"
    log = _train(cfg_path, trees[0], out, "--resume", str(full / "epoch_2.pth"), "--steps", "2",
                 "--save_state")
    assert [r["step"] for r in log] == [0, 1]
    # the same window as the full run's step 0, other weights: another loss
    assert log[0]["loss"] != full_log[0]["loss"]
    state = torch.load(out / "epoch_2.state", map_location="cpu", weights_only=False)
    assert state["step"] == 2 and state["scheduler"]["last_epoch"] == 2
    assert all(int(s["step"]) == 2 for s in state["optimizer"]["state"].values())
    fresh = tmp_path / "fresh"
    fresh_log = _train(cfg_path, trees[0], fresh, "--steps", "1")
    assert fresh_log[0]["loss"] == full_log[0]["loss"]


def test_validation_log_and_best_checkpoint(full_run):
    name, _, full, _ = full_run
    recs = [json.loads(line) for line in (full / "val_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(set(r) == {"step", "time", "mse", "ssim", "best"} for r in recs)
    best = np.inf
    for r in recs:
        assert np.isfinite(r["mse"]) and np.isfinite(r["ssim"])
        assert r["best"] == (r["mse"] < best)
        best = min(best, r["mse"])
    ckpt = torch.load(full / "best.pth", map_location="cpu", weights_only=False)
    assert "meta" in ckpt and "state_dict" in ckpt


@pytest.mark.parametrize("name", sorted(MODELS))
def test_validator_matches_jax_validator(trees, tmp_path, name, concrete_gathers):
    _, val = trees
    cfg = dict(MODELS[name], use_pallas_attention=False) if name == "BDE2VID" else MODELS[name]
    jmodel = jax_build(name, cfg)
    h = w = 16
    if name == "BDE2VID":
        params = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, 1, h, w, 5))))(
            jax.random.PRNGKey(3))
    else:
        params = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, h, w, 5)),
                                               jmodel.initial_state(1, h, w)))(
            jax.random.PRNGKey(3))
    kw = dict(seq_len=SEQ_LEN, num_bins=5, windows=3, multiple=4)
    want = JaxValidator(name, cfg, str(val), **kw)(params)

    model = build_model(name, MODELS[name], device="cpu", train=True)
    load_state_dict_checked(model, state_dict_from_jax(params))
    validator = Validator(name, MODELS[name], str(val), device="cpu", **kw)
    got = validator(model)
    assert model.training  # back in training mode
    np.testing.assert_allclose(got["mse"], want["mse"], atol=2e-4, rtol=0)
    np.testing.assert_allclose(got["ssim"], want["ssim"], atol=2e-4, rtol=0)

    # a round that does not improve leaves best.pth alone
    first = validator.log_and_track(str(tmp_path), 1, model)
    assert first["best"] and (tmp_path / "best.pth").exists()
    os.remove(tmp_path / "best.pth")
    again = validator.log_and_track(str(tmp_path), 2, model)
    assert not again["best"] and not (tmp_path / "best.pth").exists()
    assert again["mse"] == first["mse"]
    lines = (tmp_path / "val_log.jsonl").read_text().splitlines()
    assert [json.loads(line)["best"] for line in lines] == [True, False]


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch"]


def test_prefetch_keeps_the_losses(full_run, trees, tmp_path):
    name, cfg_path, _, full_log = full_run
    log = _train(cfg_path, trees[0], tmp_path / "pf", "--prefetch", "2")
    assert [r["loss"] for r in log] == [r["loss"] for r in full_log]
    assert not _prefetch_threads()


def test_prefetch_raises_the_producers_error_and_stops_early():
    def items():
        yield torch.zeros(2)
        yield torch.ones(2)
        raise OSError("sequence unreadable")

    pf = Prefetcher(items(), size=2)
    assert [int(t.sum()) for t in (next(pf), next(pf))] == [0, 2]
    with pytest.raises(OSError, match="unreadable"):
        next(pf)
    assert not _prefetch_threads()

    def endless():
        k = 0
        while True:
            yield torch.full((2,), float(k))
            k += 1

    with Prefetcher(endless(), size=3) as pf:
        assert [int(next(pf)[0]) for _ in range(5)] == [0, 1, 2, 3, 4]
    assert not _prefetch_threads()
    with pytest.raises(StopIteration):
        next(pf)
    assert [int(t[0]) for t in Prefetcher(iter([torch.zeros(1), torch.ones(1)]))] == [0, 1]
    assert not _prefetch_threads()


def test_prefetch_keeps_order_under_frequent_thread_switches():
    """Producer and consumer switched every microsecond: every item arrives
    once and in order, and the thread ends with the stream."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pf = Prefetcher((torch.tensor(k) for k in range(500)), size=3)
        assert [int(t) for t in pf] == list(range(500))
    finally:
        sys.setswitchinterval(interval)
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
