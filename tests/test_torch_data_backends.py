"""Port parity of the data side's other backends and windowing policies:
``k_events`` and ``t_seconds`` windows, the raw-NPY and memmap readers,
``load_sequence`` over ENPY, NPY and H5VOX, sliding ``k_events``,
``t_seconds`` on H5 and MMP, HFR windows, the host item surface and the
NumPy voxel oracle, each against the JAX package on the same recording.
CPU, f32: windows exactly, voxels within 1e-5, frames within 1e-7."""

import os
import shutil

import numpy as np
import pytest
import torch

from bde2vid_tpu.data import pipeline as jp
from bde2vid_tpu.data import windowing as jw
from bde2vid_tpu.events import tools as jt
from bde2vid_tpu.events import voxel_np as jv
from bde2vid_tpu.events.h5_io import H5EventWriter
from bde2vid_tpu_torch.data import pipeline as tp
from bde2vid_tpu_torch.data import windowing as tw
from bde2vid_tpu_torch.events import tools as tt
from bde2vid_tpu_torch.events import voxel_np as tv
from tests.conftest import make_events

SENSOR = (36, 44)
N_EVENTS, N_FRAMES = 9000, 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_enpy(root, xs, ys, ts, ps, frames, frame_ts, windows):
    """The raw-NPY layout: events/{xs,ys,ts,ps}.npy and frames/frames.npy
    with frame_ts.txt and frame_event_idxes.txt."""
    os.makedirs(os.path.join(root, "events"))
    os.makedirs(os.path.join(root, "frames"))
    for name, a in (("xs", xs), ("ys", ys), ("ts", ts), ("ps", ps)):
        np.save(os.path.join(root, "events", f"{name}.npy"), a)
    np.save(os.path.join(root, "frames", "frames.npy"), frames)
    np.savetxt(os.path.join(root, "frames", "frame_ts.txt"), frame_ts)
    np.savetxt(os.path.join(root, "frames", "frame_event_idxes.txt"), windows, fmt="%d")


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """One recording in every layout: h5 (absolute timestamps from 10 s),
    memmap, ENPY (the same events, uint8 0/1 polarity, explicit windows
    with a gap and an overlap), the NPY tree and an h5 with both voxel
    caches; the last two written by the JAX package."""
    root = tmp_path_factory.mktemp("recording")
    rng = np.random.default_rng(5)
    xs, ys, ts, ps = make_events(rng, n=N_EVENTS, sensor_size=SENSOR, t1=1.2)
    ts = ts.astype(np.float64) + 10.0
    frames = rng.integers(0, 256, (N_FRAMES,) + SENSOR).astype(np.uint8)
    frame_ts = 10.0 + (np.arange(N_FRAMES) + 0.5) * 0.2
    h5 = str(root / "seq.h5")
    with H5EventWriter(h5, sensor_size=SENSOR) as w:
        w.append_events(xs, ys, ts, ps > 0)
        for f, t in zip(frames, frame_ts):
            w.add_image(f, float(t))
    jt.h5_to_memmap(h5, str(root / "mmp"))
    ends = np.searchsorted(ts, frame_ts)
    starts = np.concatenate([[0], ends[:-1]])
    starts[2] += 150  # a gap before window 2
    starts[4] -= 300  # window 4 overlaps window 3
    write_enpy(str(root / "enpy"), xs.astype(np.int16), ys.astype(np.int16), ts,
               (ps > 0).astype(np.uint8), frames, frame_ts, np.stack([starts, ends], 1))
    jt.h5_to_prevoxelized_npy(h5, str(root / "npy"))
    vox = str(root / "vox.h5")
    shutil.copy(h5, vox)
    jt.h5_precompute_voxels(vox)
    jt.h5_precompute_voxels(vox, combined_voxel_channels=False)
    return {"H5": h5, "MMP": str(root / "mmp"), "ENPY": str(root / "enpy"),
            "NPY": str(root / "npy"), "H5VOX": vox}


# ------------------------------- windowing ------------------------------------


@pytest.mark.parametrize("n,k,w", [(9000, 1000, 0), (9000, 1000, 250), (9001, 777, 776),
                                   (5, 10, 0), (0, 4, 1)])
def test_k_events_windows_match_jax(n, k, w):
    np.testing.assert_array_equal(tw.k_events_windows(n, k, w), jw.k_events_windows(n, k, w))


@pytest.mark.parametrize("fn,args", [(tw.k_events_windows, (100, 5, 5)),
                                     (tw.t_seconds_windows, (None, 0.0, 1.0, 0.1, 0.2))])
def test_windows_refuse_a_step_at_or_below_zero(fn, args):
    with pytest.raises(ValueError):
        fn(*args)


@pytest.mark.parametrize("t,slide,t0", [(0.1, 0.0, 0.0), (0.13, 0.05, 0.0), (0.25, 0.0, 0.3)])
def test_t_seconds_windows_match_jax(recording, t, slide, t0):
    reader = tt.MemMapEventReader(recording["MMP"])
    got = tw.t_seconds_windows(reader.search_time, t0, 1.1, t, slide)
    want = jw.t_seconds_windows(jt.MemMapEventReader(recording["MMP"]).search_time, t0, 1.1,
                                t, slide)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and len(got) == int(1.1 / (t - slide))


# -------------------------------- readers -------------------------------------


@pytest.mark.parametrize("backend", ["MMP", "ENPY"])
def test_readers_match_jax(recording, backend):
    cls = "MemMapEventReader" if backend == "MMP" else "NPYEventReader"
    got, want = getattr(tt, cls)(recording[backend]), getattr(jt, cls)(recording[backend])
    assert got.sensor_size == want.sensor_size and got.t0 == want.t0
    assert (got.num_events, got.num_frames, got.num_flow) == (
        want.num_events, want.num_frames, want.num_flow)
    np.testing.assert_array_equal(got.frame_timestamps, want.frame_timestamps)
    np.testing.assert_array_equal(got.frame_event_indices, want.frame_event_indices)
    if backend == "ENPY":
        np.testing.assert_array_equal(got.frame_windows, want.frame_windows)
    for a, b in zip(got.raw_events(100, 2100), want.raw_events(100, 2100)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for f in ("xs", "ys", "ts", "ps"):
        np.testing.assert_array_equal(getattr(got.events(7, 907), f), getattr(want.events(7, 907), f))
    for i in (0, N_FRAMES - 1):
        np.testing.assert_array_equal(got.frame(i), want.frame(i))
    assert got.ts_bounds(5, 600) == want.ts_bounds(5, 600) and got.ts_bounds(3, 3) == (0.0, 0.0)
    for t in np.linspace(-0.01, 1.25, 41):
        for side in ("left", "right"):
            assert got.search_time(float(t), side) == want.search_time(float(t), side)
    with pytest.raises(IndexError):
        got.flow(0)


def test_enpy_hands_the_packer_0_1_polarity(recording, tmp_path):
    """ps.npy stored as -1/+1 int8 voxelizes as the 0/1 file does: the reader
    hands the packer 0/1, where a cast of -1 to uint8 would read +1."""
    src = recording["ENPY"]
    dst = str(tmp_path / "pm1")
    shutil.copytree(src, dst)
    ps = np.load(os.path.join(src, "events", "ps.npy"))
    np.save(os.path.join(dst, "events", "ps.npy"), np.where(ps > 0, 1, -1).astype(np.int8))
    got = tp.load_sequence(dst, ltype="ENPY").voxels(device="cpu")
    want = tp.load_sequence(src, ltype="ENPY").voxels(device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(tt.NPYEventReader(dst).raw_events(0, 50)[3], ps[:50])


# ------------------------------ load_sequence ---------------------------------

CASES = {
    "k_events_sliding_h5": ("H5", {"voxel_method": {"method": "k_events", "k": 1500,
                                                    "sliding_window_w": 600}}),
    "k_events_sliding_mmp": ("MMP", {"voxel_method": {"method": "k_events", "k": 1200,
                                                      "sliding_window_w": 200},
                                     "combined_voxel_channels": False}),
    "k_events_max_length": ("H5", {"voxel_method": {"method": "k_events", "k": 700},
                                   "max_length": 4}),
    "t_seconds_h5": ("H5", {"voxel_method": {"method": "t_seconds", "t": 0.15}}),
    "t_seconds_sliding_h5": ("H5", {"voxel_method": {"method": "t_seconds", "t": 0.2,
                                                     "sliding_window_t": 0.08}}),
    "t_seconds_mmp": ("MMP", {"voxel_method": {"method": "t_seconds", "t": 0.15},
                              "normalize": True}),
    "hfr_h5": ("H5", {"k_framerate": 3}),
    "hfr_mmp": ("MMP", {"k_framerate": 2, "hot_filter": True}),
    "enpy": ("ENPY", {}),
    "enpy_negpos_norm": ("ENPY", {"combined_voxel_channels": False, "normalize": True}),
    "enpy_k_events": ("ENPY", {"voxel_method": {"method": "k_events", "k": 2000,
                                                "sliding_window_w": 500}}),
    "npy": ("NPY", {}),
    "npy_norm_max_length": ("NPY", {"normalize": True, "max_length": 2}),
    "h5vox": ("H5VOX", {}),
    "h5vox_negpos_norm": ("H5VOX", {"combined_voxel_channels": False, "normalize": True}),
    "h5_max_length": ("H5", {"max_length": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_sequence_matches_jax(recording, case):
    ltype, kw = CASES[case]
    got = tp.load_sequence(recording[ltype], num_bins=5, ltype=ltype, **kw)
    want = jp.load_sequence(recording[ltype], num_bins=5, ltype=ltype, **kw)
    assert len(got) == len(want) and got.sensor_size == want.sensor_size
    if hasattr(want, "windows"):
        np.testing.assert_array_equal(got.windows, want.windows)
        assert got.has_frames == want.has_frames
    np.testing.assert_allclose(got.voxels(device="cpu", batch=3).numpy(),
                               np.asarray(want.voxels()), atol=1e-5, rtol=0)
    if getattr(want, "has_frames", True):
        np.testing.assert_allclose(got.frames(), want.frames(), atol=1e-7, rtol=0)
        u8 = got.frames_u8()
        if u8 is not None:
            np.testing.assert_array_equal(u8.astype(np.float32) / np.float32(255), got.frames())
    got.reader.close()
    want.reader.close()


def test_overlapping_windows_pack_right(recording):
    """Sliding k_events windows overlap: each window's voxel equals the
    oracle's on its own events."""
    seq = tp.load_sequence(recording["H5"], ltype="H5",
                           voxel_method={"method": "k_events", "k": 1500, "sliding_window_w": 600})
    assert (seq.windows[1:, 0] < seq.windows[:-1, 1]).all()
    got = seq.voxels(device="cpu", batch=4).numpy()
    for i in (0, 1, len(seq) - 1):
        sl = seq.reader.events(*(int(v) for v in seq.windows[i]))
        want = tv.events_to_voxel_np(sl.xs, sl.ys, sl.ts - sl.ts[0], sl.ps, 5, SENSOR)
        np.testing.assert_allclose(got[i], want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("ltype,kw", [
    ("H5", {}),
    ("MMP", {"voxel_method": {"method": "k_events", "k": 900}}),
    ("ENPY", {}),
    ("H5", {"voxel_method": {"method": "t_seconds", "t": 0.3}}),
])
def test_item_surface_matches_jax(recording, ltype, kw):
    got = tp.load_sequence(recording[ltype], ltype=ltype, **kw)
    want = jp.load_sequence(recording[ltype], ltype=ltype, **kw)
    assert got.capacity == want.capacity and got.data_source_idx == want.data_source_idx
    for i in (0, len(want) - 1):
        a, b = got.item(i), want.item(i)
        for x, y in zip(a.events, b.events):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert (a.n_events, a.timestamp, a.dt, a.data_source_idx) == (
            b.n_events, b.timestamp, b.dt, b.data_source_idx)
        assert (a.frame is None) == (b.frame is None) and a.flow is None and b.flow is None
        if a.frame is not None:
            np.testing.assert_array_equal(a.frame, b.frame)


def test_item_refuses_event_rate_split(recording):
    seq = tp.load_sequence(recording["MMP"], ltype="MMP", ev_rate=0.35)
    with pytest.raises(ValueError, match="ev_rate"):
        seq.item(0)


def test_unknown_loader_type_and_method_raise(recording):
    with pytest.raises(ValueError, match="loader type"):
        tp.load_sequence(recording["H5"], ltype="TXT")
    with pytest.raises(ValueError, match="voxel method"):
        tp.load_sequence(recording["H5"], voxel_method={"method": "k_seconds"})


def test_h5vox_without_cache_names_the_writer(recording):
    with pytest.raises(ValueError, match="h5_precompute_voxels"):
        tp.load_sequence(recording["H5"], ltype="H5VOX", num_bins=3)


def test_stored_voxel_sequences_keep_the_surface(recording):
    for ltype in ("NPY", "H5VOX"):
        seq = tp.load_sequence(recording[ltype], ltype=ltype)
        assert seq.item_last is None and seq.reader is not None
        assert seq.voxels(1, 3, device="cpu").shape == (2, 5) + SENSOR
        seq.close()


# ------------------------------- the oracle -----------------------------------


def test_voxel_np_matches_jax(rng):
    xs, ys, ts, ps = make_events(rng, n=3000, sensor_size=SENSOR, t1=0.05)
    fx = xs + rng.uniform(-0.5, 0.5, len(xs))
    fy = ys + rng.uniform(-0.5, 0.5, len(ys))
    for name, args in (
        ("events_to_image_np", (xs, ys, ps, SENSOR)),
        ("events_to_image_bilinear_np", (fx, fy, ps, SENSOR)),
        ("events_to_image_bilinear_np", (fx, fy, ps, SENSOR, False)),
        ("events_to_voxel_np", (xs, ys, ts, ps, 5, SENSOR)),
        ("events_to_voxel_np", (xs[:1], ys[:1], ts[:1] * 0, ps[:1], 3, SENSOR)),
        ("events_to_neg_pos_voxel_np", (xs, ys, ts, ps, 4, SENSOR)),
        ("events_bounds_mask", (xs, ys, 3, 40, 2, 30)),
        ("clip_events_to_bounds", (xs, ys, ps, SENSOR)),
    ):
        got, want = getattr(tv, name)(*args), getattr(jv, name)(*args)
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
    grid = tv.events_to_voxel_np(xs, ys, ts, ps, 5, SENSOR)
    np.testing.assert_array_equal(tv.voxel_grid_as_image(grid), jv.voxel_grid_as_image(grid))
