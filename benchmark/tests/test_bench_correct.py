"""``correct`` on the CPU at a small size: the reference agrees with the
program, and a run whose timed path is broken underneath (the check for a
card skipped, the rest of the run driven as on the chip) reads not
correct, once for each fault a recon cell can have. The control (the
reference in TF32) needs the card."""

import math

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import tiny_cell

CELLS = ["bde2vid-flagship.recon-hd", "e2vid-recurrent.recon-hd"]
TRAIN = "bde2vid-flagship.train-b16"


def _run(cell, seed=2 ** 31 + 11):
    import time

    return cell.entry().run(cell, seed, 0.1, False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", CELLS + [TRAIN])
def test_program_agrees_with_reference(name):
    cell = tiny_cell(name)
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_layers(name):
    import time

    cell = tiny_cell(name)
    result = cell.entry().run(cell, 2 ** 31 + 13, 0.1, True, torch.device("cpu"), time.perf_counter())
    # judged, as an untraced run is (the limits are the card's at the cell's size: at 48x64 on the
    # CPU E2VID's SSIM gap reads about them)
    assert all(math.isfinite(c["value"]) for c in result["checks"].values()), result["checks"]
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert 0 < result["metrics"]["mfu.recon"]["value"] <= 100
    assert result["device"]["window_s"] > 0 and set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["setup"]["recording_write_s"] > 0


def _state_unchanged(monkeypatch):
    from bde2vid_tpu_torch.nn import recurrent

    step = recurrent.ConvLSTMCell.forward
    monkeypatch.setattr(recurrent.ConvLSTMCell, "forward", lambda self, x, state: (step(self, x, state)[0], state))


def _half_batch(monkeypatch):
    from bde2vid_tpu_torch.data.pipeline import EventSequence

    voxels = EventSequence.voxels

    def half(self, *a, **k):
        v = voxels(self, *a, **k)
        return torch.cat([v[: (len(v) + 1) // 2], torch.zeros_like(v[(len(v) + 1) // 2:])])

    monkeypatch.setattr(EventSequence, "voxels", half)


def _image_altered(monkeypatch):
    from bde2vid_tpu_torch.models import bde2vid, e2vid

    for cls in (bde2vid.BDE2VID, e2vid.E2VIDRecurrent):
        def altered(self, *a, _forward=cls.forward, **k):
            out = _forward(self, *a, **k)
            d = out[0] if isinstance(out, tuple) else out
            img = d["image"]
            moved = torch.zeros_like(img)
            moved[..., 0, 0] = 1e-2
            d["image"] = img + moved
            return out

        monkeypatch.setattr(cls, "forward", altered)


def _score_altered(monkeypatch):
    from bde2vid_tpu_torch.eval import driver

    ssim = driver._METRICS["ssim"]
    monkeypatch.setitem(driver._METRICS, "ssim", lambda p, g: ssim(p, g) * 1.001)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "image_altered": _image_altered, "score_altered": _score_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = _run(tiny_cell(name))
    assert not result["correct"], result["checks"]


def _no_update(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _loss_half_batch(monkeypatch):
    from bde2vid_tpu_torch.train.trainer import SequenceLossComputer

    call = SequenceLossComputer.__call__
    monkeypatch.setattr(SequenceLossComputer, "__call__",
                        lambda self, p, g, f=None: call(self, p[:, : p.shape[1] // 2], g[:, : g.shape[1] // 2], f))


def _grad_altered(monkeypatch):
    clip = torch.nn.utils.clip_grad_norm_

    def altered(params, *a, **k):
        params = list(params)
        params[0].grad.mul_(2)  # the model's first leaf: the head conv's weight
        return clip(params, *a, **k)

    monkeypatch.setattr(torch.nn.utils, "clip_grad_norm_", altered)


TRAIN_FAULTS = {"state_unchanged": _no_update, "half_batch": _loss_half_batch, "grad_altered": _grad_altered}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_broken_train_step_is_not_correct(fault, monkeypatch):
    TRAIN_FAULTS[fault](monkeypatch)
    result = _run(tiny_cell(TRAIN))
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, card):
    cell = tiny_cell(name)
    cell.traffic.update(sensor=[240, 320])
    harness.set_precision()
    for seed in (1, 2, 3):
        numbers = cell.entry().calibration(cell, seed, card, ["tf32"])["tf32"]
        ok, checks = harness.judge(numbers, cell.limits)
        assert not ok, checks
