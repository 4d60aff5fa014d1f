"""Port parity of the event converters and the pre-voxelized writers
(``events/tools.py``): each port writer's file against the JAX package's on
the same input, read back by the JAX readers, and the JAX writers' files
read back by the port's. CPU."""

import io
import os
import shutil
import zipfile

import h5py
import numpy as np
import pytest
import torch

from bde2vid_tpu.data import pipeline as jp
from bde2vid_tpu.events import tools as jt
from bde2vid_tpu.events.h5_io import H5EventReader as JaxH5Reader
from bde2vid_tpu_torch.data import pipeline as tp
from bde2vid_tpu_torch.events import tools as tt
from bde2vid_tpu_torch.events.h5_io import H5EventWriter
from tests.conftest import make_events

SENSOR = (30, 40)


@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    """An h5 recording at epoch-scale timestamps (f64 precision matters),
    one window of 2 events (a zero voxel), 6 uint8 frames."""
    root = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(3)
    xs, ys, ts, ps = make_events(rng, n=6000, sensor_size=SENSOR, t1=1.0)
    ts = 1.6e9 + np.sort(rng.uniform(0.0, 1.0, len(ts)))
    frame_ts = 1.6e9 + np.array([0.05, 0.3, 0.3 + 1e-7, 0.55, 0.8, 0.97])
    path = str(root / "seq.h5")
    with H5EventWriter(path, sensor_size=SENSOR) as w:
        w.append_events(xs, ys, ts, ps > 0)
        for t in frame_ts:
            w.add_image(rng.integers(0, 256, SENSOR).astype(np.uint8), float(t))
    return path


def _h5_tree(path):
    """{name: (array, attrs)} of every dataset, and the file attrs."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, d: out.__setitem__(n, (d[()], dict(d.attrs)))
                     if isinstance(d, h5py.Dataset) else None)
        attrs = dict(f.attrs)
    return out, attrs


def _assert_same_h5(a, b, voxel_atol=0.0):
    """Equal datasets and attributes; the voxel caches' grids within
    ``voxel_atol`` and their dt within 1e-6 where it is above 0."""
    (da, aa), (db, ab) = _h5_tree(a), _h5_tree(b)
    assert sorted(da) == sorted(db) and sorted(aa) == sorted(ab)
    for k in da:
        assert da[k][0].dtype == db[k][0].dtype and sorted(da[k][1]) == sorted(db[k][1]), k
        if k.startswith("events_voxels"):
            np.testing.assert_allclose(da[k][0], db[k][0], atol=voxel_atol, rtol=0, err_msg=k)
            np.testing.assert_allclose(da[k][1]["dt"], db[k][1]["dt"], atol=1e-6, rtol=0)
            continue
        np.testing.assert_array_equal(da[k][0], db[k][0], err_msg=k)
        for attr in da[k][1]:
            np.testing.assert_array_equal(da[k][1][attr], db[k][1][attr], err_msg=f"{k}:{attr}")
    for k in aa:
        np.testing.assert_array_equal(aa[k], ab[k], err_msg=k)


@pytest.mark.parametrize("header,zero", [(True, False), (False, True)])
def test_txt_to_h5_matches_jax(tmp_path, header, zero):
    rng = np.random.default_rng(1)
    xs, ys, ts, ps = make_events(rng, n=700, sensor_size=SENSOR, t1=1.0)
    txt = tmp_path / "events.txt"
    with open(txt, "w") as fp:
        fp.write(f"{SENSOR[1]} {SENSOR[0]}\n" if header else "# t x y p\n")
        for t, x, y, p in zip(ts + 5.0, xs, ys, ps):
            fp.write(f"{t:.9f} {x} {y} {1 if p > 0 else 0}\n")
    tt.txt_to_h5(str(txt), str(tmp_path / "port.h5"), zero_timestamps=zero, chunksize=256)
    jt.txt_to_h5(str(txt), str(tmp_path / "jax.h5"), zero_timestamps=zero, chunksize=256)
    _assert_same_h5(str(tmp_path / "port.h5"), str(tmp_path / "jax.h5"))


def test_zip_to_h5_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    xs, ys, ts, ps = make_events(rng, n=900, sensor_size=SENSOR, t1=1.0)
    zpath = str(tmp_path / "seq.zip")
    with zipfile.ZipFile(zpath, "w") as zf:
        listing = []
        for i in range(3):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, SENSOR).astype(np.uint8)).save(buf, "PNG")
            zf.writestr(f"frame_{i:04d}.png", buf.getvalue())
            listing.append(f"{7.0 + 0.3 * i:.6f} frame_{i:04d}.png")
        zf.writestr("images.txt", "\n".join(listing))
        zf.writestr("events.txt", "\n".join(f"{t + 7.01:.9f} {x} {y} {int(p > 0)}"
                                            for t, x, y, p in zip(ts, xs, ys, ps)))
    tt.zip_to_h5(zpath, str(tmp_path / "port.h5"), zero_timestamps=True)
    jt.zip_to_h5(zpath, str(tmp_path / "jax.h5"), zero_timestamps=True)
    _assert_same_h5(str(tmp_path / "port.h5"), str(tmp_path / "jax.h5"))
    with JaxH5Reader(str(tmp_path / "port.h5")) as r:
        assert r.num_frames == 3 and r.num_events == 900 and r.sensor_size == SENSOR


def test_h5_cut_matches_jax_and_keeps_f64(tmp_path, h5_file):
    tt.h5_cut(h5_file, str(tmp_path / "port.h5"), 0.2, 0.7)
    jt.h5_cut(h5_file, str(tmp_path / "jax.h5"), 0.2, 0.7)
    _assert_same_h5(str(tmp_path / "port.h5"), str(tmp_path / "jax.h5"))
    with h5py.File(h5_file) as src, h5py.File(str(tmp_path / "port.h5")) as cut:
        ts = cut["events/ts"][()]
        assert ts.dtype == np.float64 and len(ts) and np.isin(ts, src["events/ts"][()]).all()


def test_add_hdf5_attribute(tmp_path, h5_file):
    path = str(tmp_path / "attr.h5")
    shutil.copy(h5_file, path)
    tt.add_hdf5_attribute(path, "source", "ijrr")
    tt.add_hdf5_attribute(path, "note", 3, dataset="events/ts")
    with h5py.File(path) as f:
        assert f.attrs["source"] == "ijrr" and f["events/ts"].attrs["note"] == 3
    assert tp.load_sequence(path).data_source_idx == jp.DATA_SOURCES.index("ijrr")


def test_h5_to_memmap_matches_jax(tmp_path, h5_file):
    tt.h5_to_memmap(h5_file, str(tmp_path / "port"))
    jt.h5_to_memmap(h5_file, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        if n.endswith(".npy"):
            a, b = np.load(tmp_path / "port" / n), np.load(tmp_path / "jax" / n)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert open(tmp_path / "port" / n).read() == open(tmp_path / "jax" / n).read()
    assert np.load(tmp_path / "port" / "t.npy").dtype == np.float64
    got = tt.MemMapEventReader(str(tmp_path / "port"))
    want = jt.MemMapEventReader(str(tmp_path / "port"))
    np.testing.assert_array_equal(got.frame_event_indices, want.frame_event_indices)


@pytest.mark.parametrize("combined", [True, False])
def test_h5_precompute_voxels_matches_jax(tmp_path, h5_file, combined):
    port, jax_ = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    shutil.copy(h5_file, port)
    shutil.copy(h5_file, jax_)
    assert tt.h5_precompute_voxels(port, 5, combined) == jt.h5_precompute_voxels(jax_, 5, combined)
    _assert_same_h5(port, jax_, voxel_atol=1e-5)
    assert tt.h5_precompute_voxels(port, 5, combined) == 0  # kept unless overwrite
    assert tt.h5_precompute_voxels(port, 5, combined, overwrite=True) == 5
    _assert_same_h5(port, jax_, voxel_atol=1e-5)
    for path in (port, jax_):  # each cache read by the other package
        got = tp.load_sequence(path, ltype="H5VOX", combined_voxel_channels=combined)
        want = jp.load_sequence(path, ltype="H5VOX", combined_voxel_channels=combined)
        np.testing.assert_array_equal(got.voxels(device="cpu").numpy(), np.asarray(want.voxels()))
        np.testing.assert_array_equal(got.frames(), want.frames())
        got.close()
        want.close()
    with h5py.File(port) as f:
        grp = f[tt.voxel_cache_group(5, combined)]
        assert not np.asarray(grp["event000000002"]).any()  # 2 events: zeros
        assert grp["event000000002"].attrs["dt"] == 0.0


def test_h5_to_prevoxelized_npy_matches_jax(tmp_path, h5_file):
    tt.h5_to_prevoxelized_npy(h5_file, str(tmp_path / "port"), num_bins=3)
    jt.h5_to_prevoxelized_npy(h5_file, str(tmp_path / "jax"), num_bins=3)
    for sub in ("VoxelGrid-betweenframes-3", "frames"):
        for n in sorted(os.listdir(tmp_path / "jax" / sub)):
            a, b = tmp_path / "port" / sub / n, tmp_path / "jax" / sub / n
            if n.endswith(".npy"):
                np.testing.assert_allclose(np.load(a), np.load(b), atol=1e-5, rtol=0)
            else:
                assert open(a).read() == open(b).read()
    kw = {"event_folder": "VoxelGrid-betweenframes-3"}
    for root in ("port", "jax"):
        got = tp.PrevoxelizedSequence(str(tmp_path / root), **kw)
        want = jp.PrevoxelizedSequence(str(tmp_path / root), **kw)
        np.testing.assert_array_equal(got.frame_idx, want.frame_idx)
        np.testing.assert_array_equal(got.voxels(device="cpu").numpy(), np.asarray(want.voxels()))
        np.testing.assert_array_equal(got.frames(), want.frames())


def test_voxel_writers_shift_in_f64(tmp_path):
    """Windows 300 s into a recording: the port's writers give the event
    pipeline's voxels within 1e-6 (timestamps shifted to each window's first
    event in f64); the JAX package's, which shift f32 timestamps relative to
    the recording's start, lie more than 1e-5 away (ROADMAP Queue C)."""
    rng = np.random.default_rng(4)
    xs, ys, _, ps = make_events(rng, n=8000, sensor_size=SENSOR, t1=1.0)
    ts = 1000.0 + np.concatenate([[0.0], 300.0 + np.sort(rng.uniform(0.0, 0.4, len(xs) - 1))])
    path = str(tmp_path / "late.h5")
    with H5EventWriter(path, sensor_size=SENSOR) as w:
        w.append_events(xs, ys, ts, ps > 0)
        for t in 1300.0 + np.array([0.01, 0.1, 0.2, 0.3, 0.4]):
            w.add_image(np.zeros(SENSOR, np.uint8), float(t))
    want = tp.load_sequence(path).voxels(device="cpu").numpy()
    for package, atol in ((tt, 1e-6), (jt, None)):
        out = str(tmp_path / package.__name__)
        package.h5_to_prevoxelized_npy(path, out)
        got = np.load(os.path.join(out, "VoxelGrid-betweenframes-5", "voxels.npy"))
        diff = np.abs(got - want).max()
        assert diff <= atol if atol else diff > 1e-5, (package.__name__, diff)


def test_prevoxelized_tree_from_a_memmap_reader(tmp_path, h5_file):
    """The NPY tree written from the memmap export: the h5 tree's timestamps
    and frames, and the voxels of the MMP sequence within 1e-5."""
    tt.h5_to_memmap(h5_file, str(tmp_path / "mmp"))
    tt.h5_to_prevoxelized_npy(h5_file, str(tmp_path / "from_h5"))
    tt.write_prevoxelized_npy(tt.MemMapEventReader(str(tmp_path / "mmp")), str(tmp_path / "from_mmp"))
    for sub, name in (("VoxelGrid-betweenframes-5", "timestamps.txt"), ("frames", "timestamps.txt")):
        assert (open(tmp_path / "from_mmp" / sub / name).read()
                == open(tmp_path / "from_h5" / sub / name).read())
    np.testing.assert_array_equal(np.load(tmp_path / "from_mmp" / "frames" / "frames.npy"),
                                  np.load(tmp_path / "from_h5" / "frames" / "frames.npy"))
    want = tp.load_sequence(str(tmp_path / "mmp"), ltype="MMP").voxels(device="cpu").numpy()
    got = np.load(tmp_path / "from_mmp" / "VoxelGrid-betweenframes-5" / "voxels.npy")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_prevoxelized_pairs_the_first_frame_at_or_after(tmp_path):
    """Voxel timestamps between, on and past the frames; float frames above
    1.5 are scaled by 1/255, uint8 ones always."""
    ef, ff = tmp_path / "VoxelGrid-betweenframes-5", tmp_path / "frames"
    os.makedirs(ef)
    os.makedirs(ff)
    np.save(ef / "voxels.npy", np.arange(4 * 5 * 2 * 3, dtype=np.float32).reshape(4, 5, 2, 3))
    np.savetxt(ef / "timestamps.txt", np.stack([np.arange(4), [0.5, 1.0, 1.7, 9.0]], 1))
    np.savetxt(ff / "timestamps.txt", np.stack([np.arange(3), [1.0, 1.5, 2.0]], 1))
    for frames in (np.arange(18, dtype=np.float32).reshape(3, 2, 3) * 10,
                   np.arange(18, dtype=np.uint8).reshape(3, 2, 3)):
        np.save(ff / "frames.npy", frames)
        got, want = tp.PrevoxelizedSequence(str(tmp_path)), jp.PrevoxelizedSequence(str(tmp_path))
        np.testing.assert_array_equal(got.frame_idx, [0, 0, 2, 2])
        np.testing.assert_array_equal(got.frames(), want.frames())
        assert (got.frames_u8() is not None) == (frames.dtype == np.uint8)
        torch.testing.assert_close(got.voxels(device="cpu"), torch.from_numpy(np.load(ef / "voxels.npy")))
