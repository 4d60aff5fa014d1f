"""The port's library surface (ROADMAP A15) against the JAX package on the
CPU: the helpers of ``utils`` (norms, json io, crop sizes, ``flow2rgb``,
the timers, ``model_cost_summary``), ``data`` (transforms, prefetch),
``metrics.MseMetric`` and ``nn`` (the recurrent initial states), each held
to its JAX counterpart on the same inputs, and the packages' public names
held to the JAX package's ``__all__``."""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bde2vid_tpu.data.transforms as jtr
import bde2vid_tpu.metrics.basic as jmet
import bde2vid_tpu.nn.recurrent as jrec
import bde2vid_tpu.utils.config as jcfg
import bde2vid_tpu.utils.norm as jnorm
import bde2vid_tpu.utils.padding as jpad
from bde2vid_tpu.data.prefetch import prefetch_to_device as jax_prefetch
from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.models.api import ModelSpec as JaxSpec
from bde2vid_tpu.utils.flow_viz import flow2rgb as jax_flow2rgb
from bde2vid_tpu.utils.profiling import model_cost_summary as jax_cost
from bde2vid_tpu_torch.data import transforms as ttr
from bde2vid_tpu_torch.data.prefetch import prefetch_to_device
from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked, state_dict_from_jax
from bde2vid_tpu_torch.metrics.basic import MseMetric
from bde2vid_tpu_torch.models import ModelSpec, build_model
from bde2vid_tpu_torch.nn import window_attention as twa
from bde2vid_tpu_torch.nn.recurrent import gru_initial_state, lstm_initial_state
from bde2vid_tpu_torch.utils import (abs_norm, flow2rgb, model_cost_summary, quick_norm,
                                     read_json, timer_summary, write_json)
from bde2vid_tpu_torch.utils import timers
from bde2vid_tpu_torch.utils.norm import from_uint8_image
from bde2vid_tpu_torch.utils.padding import CropSize3D, optimal_crop_size_multiple
from tests.test_torch_e2vid import seeded_tree
from tests.test_torch_parallel_nwindow import concrete_gathers  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- utils


@pytest.mark.parametrize("kind", ["normal", "constant", "negative"])
def test_quick_and_abs_norm_match_jax(kind):
    rng = np.random.default_rng(1)
    x = {"normal": rng.normal(size=(3, 17, 23)), "constant": np.full((4, 5), 2.5),
         "negative": -rng.uniform(1, 2, size=(9, 11))}[kind].astype(np.float32)
    for ours, theirs in ((quick_norm, jnorm.quick_norm), (abs_norm, jnorm.abs_norm)):
        np.testing.assert_allclose(ours(_t(x)).numpy(), np.asarray(theirs(jnp.asarray(x))),
                                   atol=1e-6, rtol=0)


def test_from_uint8_image_is_jax_in_nchw():
    img = np.random.default_rng(2).integers(0, 256, (13, 17)).astype(np.uint8)
    got = from_uint8_image(img, device="cpu")
    want = np.asarray(jnorm.from_uint8_image(img))  # (1, H, W, 1)
    assert got.shape == (1, 1, 13, 17) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))


def test_json_io_writes_the_jax_bytes(tmp_path):
    content = {"model": {"type": "BDE2VID", "args": {"depths": [4, 0, 6]}}, "lr": 1e-4}
    write_json(content, str(tmp_path / "port.json"))
    jcfg.write_json(content, str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert read_json(str(tmp_path / "port.json")) == jcfg.read_json(str(tmp_path / "jax.json"))


@pytest.mark.parametrize("size,factor,margin", [(180, 8, 0), (181, 7, 3), (1, 4, 0), (64, 16, 16)])
def test_optimal_crop_size_multiple_matches_jax(size, factor, margin):
    assert optimal_crop_size_multiple(size, factor, margin) == jpad.optimal_crop_size_multiple(
        size, factor, margin)


@pytest.mark.parametrize("hwt", [(29, 45, 5), (32, 48, 8)])
def test_crop_size_3d_matches_jax_in_nctwh(hwt):
    h, w, t = hwt
    patch = {"h": 8, "w": 16, "t": 4}
    ours, theirs = CropSize3D(w, h, t, patch, 1), jpad.CropSize3D(w, h, t, patch, 1)
    assert vars(ours) == vars(theirs)
    x = np.random.default_rng(3).normal(size=(1, 2, t, h, w)).astype(np.float32)  # N C T H W
    padded = ours.pad(_t(x))
    want = np.asarray(theirs.pad(jnp.asarray(np.moveaxis(x, 1, -1))))  # N T H W C
    np.testing.assert_array_equal(padded.numpy(), np.moveaxis(want, -1, 1))
    np.testing.assert_array_equal(ours.crop(padded).numpy(), x)


@pytest.mark.parametrize("max_magnitude", [None, 40.0])
def test_flow2rgb_is_bit_equal_to_jax(max_magnitude):
    rng = np.random.default_rng(4)
    dx, dy = rng.normal(0, 0.3, (32, 40)), rng.normal(0, 0.3, (32, 40))
    np.testing.assert_array_equal(flow2rgb(dx, dy, max_magnitude),
                                  jax_flow2rgb(dx, dy, max_magnitude))


def test_timers_summarise_like_jax_and_cuda_is_asked_for():
    """Timer and CudaTimer(device="cpu") land in the summary under their
    names; a CudaTimer without a device asks for CUDA and raises where
    there is none (never a silent wall clock)."""
    timers._timers.clear()
    for _ in range(3):
        with timers.Timer("host"):
            pass
    with timers.CudaTimer("device", device="cpu") as t:
        t.sync(torch.ones(3))
    lines = timer_summary().splitlines()
    assert [l.split(":")[0] for l in lines] == ["device", "host"]
    assert lines[1].startswith("host: n=3 total=") and " mean=" in lines[1] and " max=" in lines[1]
    timers.set_enabled(False)
    with timers.Timer("off"):
        pass
    timers.set_enabled(True)
    assert "off" not in timer_summary()
    timers._timers.clear()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            timers.CudaTimer("x")


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with timers.DeviceTrace(str(tmp_path / "trace"), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(tmp_path, "trace", "trace.json")) as fp:
        assert "traceEvents" in json.load(fp)


# the small BDE2VID of the JAX package's serving tests (tests/test_serving.py:44)
COST_GEN = {"num_bins": 5, "basechannels": 8, "num_encoders": 2, "ks": 3, "num_res_blocks": 1,
            "buffer_index": [-1, 0, 1], "depths": [1, 1], "num_heads": 2, "window_size": [4, 4]}
# the port's gflops_per_frame over JAX's at t=1: measured 1.0117 (depths
# [1, 1]) and 0.9732 ([2, 2]). XLA's cost analysis counts elementwise work
# too, and leaves out the taps a convolution reads from its zero padding;
# FlopCounterMode counts products only, every tap. At t > 1 XLA counts a
# scanned body once, not once a frame, so JAX's count a frame falls as 1/t
# (t=2: the port's is 1.79 / 1.75 times it); the comparison runs at t=1.
COST_GFLOPS_RATIO = (0.95, 1.05)


@pytest.mark.parametrize("depths", [[1, 1], [2, 2]])
def test_model_cost_summary(depths):
    """``params`` equals JAX's; ``gflops_per_frame`` is the same on the
    kernel path (the operators' registered formulas) and the unfused path,
    and within the stated ratio of XLA's count at t=1; ``hbm_gb_per_frame``
    is lower on the kernel path. Here no B1 call runs its MLP on tokens
    outside the frame: the 4x4 windows tile the 16x24 and 8x12 maps, and
    the even dilated blocks run the unfused body around B3."""
    gen = dict(COST_GEN, depths=depths)
    jm = jax_build("BDE2VID", {"generator": gen})
    variables = seeded_tree(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 1, 32, 48, 5)))), 5)
    jspec = JaxSpec(name="BDE2VID", module=jm, params=variables, num_bins=5, num_encoders=2,
                    is_sequence_model=True)
    model = build_model("BDE2VID", {"generator": gen}, device="cpu")
    load_state_dict_checked(model, state_dict_from_jax(variables))
    spec = ModelSpec("BDE2VID", model, num_bins=5, num_encoders=2, is_sequence_model=True)
    got = {}
    for kernel in (True, False):
        twa.set_attention_kernel(model, kernel)
        got[kernel] = model_cost_summary(spec, 32, 48, t=1)
    want = jax_cost(jspec, 32, 48, t=1)
    assert set(got[True]) == set(want)
    assert got[True]["params"] == got[False]["params"] == want["params"]
    assert got[True]["gflops_per_frame"] == got[False]["gflops_per_frame"]
    ratio = got[True]["gflops_per_frame"] / want["gflops_per_frame"]
    assert COST_GFLOPS_RATIO[0] <= ratio <= COST_GFLOPS_RATIO[1], ratio
    assert 0 < got[True]["hbm_gb_per_frame"] < got[False]["hbm_gb_per_frame"]


# ---------------------------------------------------------------- data, metrics, nn


def test_center_random_crop_and_compose_match_jax():
    x = np.random.default_rng(6).normal(size=(2, 3, 31, 44)).astype(np.float32)
    np.testing.assert_array_equal(ttr.CenterCrop((16, 25))(x), jtr.CenterCrop((16, 25))(x))
    np.testing.assert_array_equal(ttr.CenterCrop(7)(_t(x)).numpy(), jtr.CenterCrop(7)(x))
    ours, theirs = ttr.RandomCrop(20), jtr.RandomCrop(20)
    with pytest.raises(RuntimeError):
        ours(x)
    ours.sample_params(31, 44, np.random.default_rng(7))
    theirs.sample_params(31, 44, np.random.default_rng(7))
    chain = ttr.Compose([ours, ttr.CenterCrop(10)])
    np.testing.assert_array_equal(chain(x), jtr.Compose([theirs, jtr.CenterCrop(10)])(x))


def test_normalize_image_sequence_matches_jax():
    frames = np.random.default_rng(8).uniform(0, 255, size=(5, 17, 23)).astype(np.float32)
    np.testing.assert_allclose(ttr.normalize_image_sequence(_t(frames)).numpy(),
                               np.asarray(jtr.normalize_image_sequence(jnp.asarray(frames))),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("n,keep_at_least", [(500, 100), (50, 100)])
def test_subsample_events_matches_jax(n, keep_at_least):
    rng = np.random.default_rng(9)
    ev = (rng.integers(0, 40, n), rng.integers(0, 30, n), np.sort(rng.uniform(0, 1, n)),
          rng.integers(0, 2, n))
    got = ttr.subsample_events(*ev, np.random.default_rng(10), keep_at_least)
    want = jtr.subsample_events(*ev, np.random.default_rng(10), keep_at_least)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mse_metric_matches_jax():
    rng = np.random.default_rng(11)
    ours, theirs = MseMetric(), jmet.MseMetric()
    for t in (3, 5):
        p, g = rng.uniform(size=(t, 12, 14)).astype(np.float32), rng.uniform(size=(t, 12, 14))
        ours.process(_t(p), _t(g.astype(np.float32)), "s", "d")
        theirs.process(jnp.asarray(p), jnp.asarray(g.astype(np.float32)), "s", "d")
    assert ours.compute_metrics().keys() == theirs.compute_metrics().keys()
    np.testing.assert_allclose(ours.compute_metrics()["MSE"], theirs.compute_metrics()["MSE"],
                               rtol=1e-6)


def test_recurrent_initial_states_are_jax_in_nchw():
    h, c = lstm_initial_state(2, 5, 7, 4)
    jh, jc = jrec.lstm_initial_state(2, 5, 7, 4)
    for ours, theirs in ((h, jh), (c, jc), (gru_initial_state(2, 5, 7, 4),
                                            jrec.gru_initial_state(2, 5, 7, 4))):
        assert ours.shape == (2, 4, 5, 7) and ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(), np.moveaxis(np.asarray(theirs), -1, 1))
    assert lstm_initial_state(1, 2, 3, 4, dtype=torch.bfloat16)[0].dtype == torch.bfloat16


def test_prefetch_to_device_yields_jax_s_items():
    rng = np.random.default_rng(12)
    items = [{"v": rng.normal(size=(2, 3)).astype(np.float32), "i": k,
              "t": (rng.normal(size=4).astype(np.float32),)} for k in range(5)]
    got = list(prefetch_to_device(iter(items), size=2, device="cpu"))
    want = list(jax_prefetch(iter(items), size=2, device=jax.devices("cpu")[0]))
    assert [g["i"] for g in got] == [w["i"] for w in want] == list(range(5))
    for g, w in zip(got, want):
        assert isinstance(g["v"], torch.Tensor) and isinstance(g["t"], tuple)
        np.testing.assert_array_equal(g["v"].numpy(), np.asarray(w["v"]))
        np.testing.assert_array_equal(g["t"][0].numpy(), np.asarray(w["t"][0]))


# ---------------------------------------------------------------- public names

# JAX names with no counterpart: the TPU compiler's cache
TPU_ONLY = {"utils": {"enable_compilation_cache"}}


@pytest.mark.parametrize("package", ["utils", "data", "events", "nn", "eval", "serving", "parallel"])
def test_public_names_are_the_jax_package_s(package):
    ours = importlib.import_module(f"bde2vid_tpu_torch.{package}")
    theirs = importlib.import_module(f"bde2vid_tpu.{package}")
    left_out = TPU_ONLY.get(package, set())
    assert left_out <= set(theirs.__all__)
    assert set(ours.__all__) == set(theirs.__all__) - left_out
    assert all(hasattr(ours, name) for name in ours.__all__)
