"""Port parity of the event images, warps and voxel helpers
(``events/voxel.py``): each function against the JAX package's on the same
seeded inputs, within 1e-5 x max(1, max |JAX|). CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bde2vid_tpu.events import voxel as jv
from bde2vid_tpu_torch.events import voxel as tv

SENSOR = (32, 40)
CAP = 2048
N = 1500


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    bound = 1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0)))
    assert float(np.abs(got - ref).max(initial=0.0)) <= bound


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def events():
    """A padded buffer of N events over a 32x40 sensor: float coordinates
    spanning [-3, size + 3) (out-of-range and negative ones among them),
    their integer floors, sorted ts and +-1 polarity; the padding after N."""
    rng = np.random.default_rng(0)
    fx = rng.uniform(-3, SENSOR[1] + 3, N).astype(np.float32)
    fy = rng.uniform(-3, SENSOR[0] + 3, N).astype(np.float32)
    ts = np.sort(rng.uniform(0.1, 0.15, N)).astype(np.float32)
    ps = rng.choice(np.array([-1.0, 1.0], np.float32), N)
    px, py, pt, pp, n = jv.pad_events(fx, fy, ts, ps, capacity=CAP)
    ix, iy, _, _, _ = jv.pad_events(np.floor(fx).astype(np.int32), np.floor(fy).astype(np.int32),
                                     ts, ps, capacity=CAP)
    return dict(fx=px, fy=py, ix=ix, iy=iy, ts=pt, ps=pp, n=n)


@pytest.mark.parametrize("coords", ["int", "float"])
def test_events_to_image(events, coords):
    x, y = (events["ix"], events["iy"]) if coords == "int" else (events["fx"], events["fy"])
    ref = jv.events_to_image(x, y, events["ps"], events["n"], sensor_size=SENSOR)
    close(tv.events_to_image(t(x), t(y), t(events["ps"]), events["n"], sensor_size=SENSOR), ref)


@pytest.mark.parametrize("padding,clip", [(True, True), (False, True), (True, False)])
def test_events_to_image_bilinear(events, padding, clip):
    args = (events["fx"], events["fy"], events["ps"], events["n"])
    kw = dict(sensor_size=SENSOR, padding=padding, clip_weights=clip)
    close(tv.events_to_image_bilinear(*map(t, args), **kw), jv.events_to_image_bilinear(*args, **kw))


def test_events_to_image_bilinear_counts_a_tensor_n(events):
    args = (events["fx"], events["fy"], events["ps"])
    ref = jv.events_to_image_bilinear(*args, jnp.int32(700), sensor_size=SENSOR)
    close(tv.events_to_image_bilinear(*map(t, args), torch.tensor(700), sensor_size=SENSOR), ref)


@pytest.mark.parametrize("padding", [True, False])
def test_events_to_image_drv_two_planes(events, padding):
    """P = 2 jacobian rows; out-of-range events pre-masked to coordinate 0
    as the cmax chain masks them, and left as they are."""
    rng = np.random.default_rng(1)
    jx = rng.normal(size=(2, CAP)).astype(np.float32)
    jy = rng.normal(size=(2, CAP)).astype(np.float32)
    args = (events["fx"], events["fy"], events["ps"], jx, jy, events["n"])
    kw = dict(sensor_size=SENSOR, padding=padding)
    img, d = tv.events_to_image_drv(*map(t, args), **kw)
    ref_img, ref_d = jv.events_to_image_drv(*args, **kw)
    assert d.shape == (2,) + img.shape
    close(img, ref_img)
    close(d, ref_d)
    close(img, jv.events_to_image_bilinear(events["fx"], events["fy"], events["ps"], events["n"],
                                           **kw))


@pytest.mark.parametrize("fn", ["events_to_timestamp_image", "events_to_zhu_timestamp_image"])
def test_events_to_timestamp_image(events, fn):
    args = (events["fx"], events["fy"], events["ts"], events["ps"], events["n"])
    got = getattr(tv, fn)(*map(t, args), sensor_size=SENSOR)
    ref = getattr(jv, fn)(*args, sensor_size=SENSOR)
    for g, r in zip(got, ref):
        close(g, r)


@pytest.mark.parametrize("mode", ["all", "n_events", "t0"])
def test_warp_events_by_flow(events, mode):
    rng = np.random.default_rng(2)
    flow = rng.normal(size=SENSOR + (2,)).astype(np.float32) * 20
    x = np.clip(events["fx"], 0, SENSOR[1] - 1)
    y = np.clip(events["fy"], 0, SENSOR[0] - 1)
    kw = {"all": {}, "n_events": {"n_events": events["n"]}, "t0": {"t0": 0.12}}[mode]
    got = tv.warp_events_by_flow(t(x), t(y), t(events["ts"]), t(flow), **kw)
    ref = jv.warp_events_by_flow(jnp.asarray(x), jnp.asarray(y), jnp.asarray(events["ts"]),
                                 jnp.asarray(flow), **kw)
    for g, r in zip(got, ref):
        close(g, r)


def test_events_to_voxel_accumulate(events):
    for n in (events["n"], 1):
        args = (events["ix"], events["iy"], events["ts"], events["ps"], n)
        close(tv.events_to_voxel_accumulate(*map(t, args), num_bins=5, sensor_size=SENSOR),
              jv.events_to_voxel_accumulate(*args, num_bins=5, sensor_size=SENSOR))


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(3)
    n = 5000
    xs = rng.integers(0, SENSOR[1], n).astype(np.int32)
    ys = rng.integers(0, SENSOR[0], n).astype(np.int32)
    ts = np.sort(rng.uniform(0.0, 1.0, n))
    ts[2500:] += 0.3  # a gap: empty fixed-t windows
    ps = rng.choice(np.array([-1.0, 1.0], np.float32), n)
    return xs, ys, ts, ps


@pytest.mark.parametrize("n", [1000, 1200])
def test_voxel_grids_fixed_n_windows(stream, n):
    """5000 events: windows of 1000 drop the last full one (start 4000),
    windows of 1200 the partial tail; each grid equals JAX's."""
    got = tv.voxel_grids_fixed_n(*stream, num_bins=3, n=n, sensor_size=SENSOR, device="cpu")
    ref = jv.voxel_grids_fixed_n(*stream, num_bins=3, n=n, sensor_size=SENSOR)
    assert len(got) == len(ref) == len(range(0, 5000 - n, n))
    for g, r in zip(got, ref):
        close(g, r)


def test_voxel_grids_fixed_t_windows(stream):
    got = tv.voxel_grids_fixed_t(*stream, num_bins=3, t=0.1, sensor_size=SENSOR, device="cpu")
    ref = jv.voxel_grids_fixed_t(*stream, num_bins=3, t=0.1, sensor_size=SENSOR)
    starts = np.arange(stream[2][0], stream[2][-1] - 0.1, 0.1)
    assert len(got) == len(ref) < len(starts)  # an empty window skipped
    for g, r in zip(got, ref):
        close(g, r)


def test_events_to_voxel_timesync(stream):
    got = tv.events_to_voxel_timesync(*stream, num_bins=4, t0=0.2, t1=0.5, sensor_size=SENSOR,
                                      device="cpu")
    close(got, jv.events_to_voxel_timesync(*stream, num_bins=4, t0=0.2, t1=0.5,
                                           sensor_size=SENSOR))
    with pytest.raises(ValueError, match="t1 must be > t0"):
        tv.events_to_voxel_timesync(*stream, num_bins=4, t0=0.5, t1=0.5, device="cpu")
    with pytest.raises(ValueError, match="no events"):
        tv.events_to_voxel_timesync(*stream, num_bins=4, t0=5.0, t1=6.0, device="cpu")


@pytest.mark.parametrize("fn", ["voxel_grids_fixed_n", "voxel_grids_fixed_t",
                                "events_to_voxel_timesync"])
def test_numpy_entry_points_refuse_a_missing_card(stream, fn, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extra = {"voxel_grids_fixed_n": dict(n=1000), "voxel_grids_fixed_t": dict(t=0.1),
             "events_to_voxel_timesync": dict(t0=0.2, t1=0.5)}[fn]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(tv, fn)(*stream, num_bins=3, sensor_size=SENSOR, **extra)


@pytest.mark.parametrize("coords", ["int16", "float64"])
@pytest.mark.parametrize("capacity", [None, 4096])
def test_pad_events(coords, capacity):
    rng = np.random.default_rng(4)
    xs = rng.integers(0, 40, 1500).astype(coords)
    ys = rng.integers(0, 30, 1500).astype(coords)
    ts = np.sort(rng.uniform(size=1500))
    ps = rng.choice([-1.0, 1.0], 1500)
    got = tv.pad_events(xs, ys, ts, ps, capacity=capacity)
    ref = jv.pad_events(xs, ys, ts, ps, capacity=capacity)
    assert got[4] == ref[4]
    for g, r in zip(got[:4], ref[:4]):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    with pytest.raises(ValueError, match="exceed capacity"):
        tv.pad_events(xs, ys, ts, ps, capacity=1024)


def test_unpack_batched_events():
    events = np.random.default_rng(5).normal(size=(23, 4)).astype(np.float32)
    for ends in ([5, 12, 23], [23], []):
        got = tv.unpack_batched_events(events, ends)
        ref = jv.unpack_batched_events(events, ends)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
