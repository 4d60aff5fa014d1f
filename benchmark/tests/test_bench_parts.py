"""The harness's parts on the CPU: the recording writer, the frozen cost
formulas, the weights, the reference's operation count and the JAX check."""

import sys
import types

import numpy as np
import pytest
import torch

from benchmark import harness, weights, yardstick
from benchmark.tests.conftest import TINY_TRAFFIC
from benchmark.traffic import recording

TRAFFIC = {**harness._json("traffic", "recon-hd.json"), **TINY_TRAFFIC}


def _arrays(path):
    return {n: np.load(f"{path}/{n}.npy") for n in ("t", "xy", "p", "images", "timestamps")}


def test_recording_deterministic_by_seed(tmp_path):
    a, b, c = (str(tmp_path / n) for n in "abc")
    recording.write(a, TRAFFIC, 5)
    recording.write(b, TRAFFIC, 5)
    recording.write(c, TRAFFIC, 6)
    ra, rb, rc = _arrays(a), _arrays(b), _arrays(c)
    assert all(np.array_equal(ra[k], rb[k]) for k in ra)
    assert not np.array_equal(ra["xy"], rc["xy"])
    # every seed has the same window sizes, in another order
    ends = lambda r: np.searchsorted(r["t"], r["timestamps"][:-1])
    sizes = lambda r: np.diff(np.concatenate([[0], ends(r)]))
    assert np.array_equal(np.sort(sizes(ra)), np.sort(sizes(rc)))
    assert len(ra["t"]) == len(rc["t"]) and np.all(np.diff(ra["t"]) >= 0)


def test_recording_written_once(tmp_path):
    first, wrote = recording.recording("recon-hd", TRAFFIC, 9)
    stamp = np.load(f"{first}/t.npy")
    assert wrote > 0 and recording.recording("recon-hd", TRAFFIC, 9) == (first, 0.0)
    assert np.array_equal(np.load(f"{first}/t.npy"), stamp)
    assert recording.recording("recon-hd", {**TRAFFIC, "frames": 9}, 9)[0] != first


def test_swin_cost_is_chip_smokes():
    import chip_smoke

    for (hw, c), blocks in zip(chip_smoke.LEVELS.values(), chip_smoke.BLOCKS_PER_FRAME.values()):
        for dilate in (False, True):
            nwin = yardstick.swin_windows(hw[0] - 6, hw[1] - 6, (7, 7), dilate)
            args = (7, nwin, 49, c, 16, 4 * c, 4)
            assert yardstick.swin_block_cost(*args) == chip_smoke.swin_block_cost(*args)
    # the flagship at 184x240: levels of 92x120 and 23x30, 252 and 20 windows either way
    assert [yardstick.swin_windows(92, 120, (7, 7), d) for d in (False, True)] == [252, 252]
    assert [yardstick.swin_windows(23, 30, (7, 7), d) for d in (False, True)] == [20, 20]


def test_weights_deterministic_and_scaled():
    shapes = {"a.weight": (64, 32, 3, 3), "a.bias": (64,), "n.running_var": (8,), "lin0.model.1.weight": (1, 4, 1, 1)}
    w1 = weights.seeded_state(shapes, 2 ** 31 + 5, "cpu")
    w2 = weights.seeded_state(shapes, 2 ** 31 + 5, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in shapes)
    assert float(w1["a.weight"].abs().max()) <= (3.0 / (32 * 9)) ** 0.5
    assert float(w1["n.running_var"].min()) >= 0.5 and float(w1["lin0.model.1.weight"].min()) >= 0.0
    assert not torch.equal(w1["a.weight"], weights.seeded_state(shapes, 6, "cpu")["a.weight"])


@pytest.mark.parametrize("config", ["bde2vid-flagship", "e2vid-recurrent"])
def test_reference_flops_linear_in_batch(config):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = harness._json("configs", config + ".json")
    ref = __import__(f"benchmark.reference.{cfg['reference']}", fromlist=["Runner"])
    meta = {k: torch.empty(v, device="meta") for k, v in ref.param_shapes(cfg["args"]).items()}

    def count(frames):
        with FlopCounterMode(display=False) as counter:
            ref.Runner(meta, cfg["args"]).chunk(torch.empty(frames, 5, 48, 64, device="meta"))
        return counter.get_total_flops()

    one, two = count(1 if ref.Runner.carries_state else 3), count(2 if ref.Runner.carries_state else 6)
    assert one > 0 and two == 2 * one


def _event(name, device, id_, start, end):
    from torch.autograd import DeviceType

    span = types.SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)
    return types.SimpleNamespace(name=name, device_type=getattr(DeviceType, device), id=id_, time_range=span)


def test_trace_counts_launches_without_a_device_record():
    # torch op ids and the runtime's correlation ids are counted apart: op 50 is no launch
    events = [_event(harness.WINDOW_RANGE, "CPU", 1, 0, 100), _event("bench.model", "CPU", 3, 5, 60),
              _event("aten::mm", "CPU", 50, 10, 20), _event("cudaLaunchKernel", "CPU", 50, 11, 12),
              _event("cuLaunchKernel", "CPU", 51, 13, 14), _event("cudaMemcpyAsync", "CPU", 52, 70, 71),
              _event("void gemm_kernel<float>(Args)", "CUDA", 50, 30, 40),
              _event("Memcpy HtoD (Pinned -> Device)", "CUDA", 52, 71, 72),
              _event("void fill_kernel(Args)", "CUDA", 77, 80, 81)]
    s = harness.summarize(types.SimpleNamespace(events=lambda: events))
    assert (s["launches"], s["launches_lost"], s["unlaunched"]) == (2, 1, 1)
    assert s["kernels"]["gemm_kernel"] == 1 and s["device_ms"] == {"bench.model": 0.01}
    assert s["busy_s"] == pytest.approx(12e-6) and s["window_s"] == pytest.approx(100e-6)


def test_jax_check_by_top_level_name(monkeypatch):
    for name in ("bde2vid_tpu_torch", "bde2vid_tpu_torchx.y"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not [m for m in harness.forbidden_modules() if m.startswith("bde2vid_tpu_torch")]
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "bde2vid_tpu.models", types.ModuleType("bde2vid_tpu.models"))
    assert {"jax.numpy", "bde2vid_tpu.models"} <= set(harness.forbidden_modules())
    with pytest.raises(SystemExit):
        harness.check_no_jax()
