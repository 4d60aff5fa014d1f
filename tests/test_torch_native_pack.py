"""The port's event packer (``bde2vid_tpu_torch/native``) on the CPU.

- ``pack_windows``, both the g++ library and the NumPy twin, is bit-equal to
  the JAX package's ``bde2vid_tpu.native.pack_windows`` on windows that are
  empty, exactly at capacity, overlapping and at the stream's end, and fills
  buffers it is given; out-of-range windows, windows above capacity and
  wrong buffers raise before the library is called.
- ``voxelize_batch`` of the library is bit-equal to the JAX package's.
- The library builds into a file named by its source's hash, and a source
  that does not compile raises with the compiler's output (skipped where
  there is no g++).
- ``EventSequence.voxels``, which packs each batch from one span read, is
  bit-equal to the per-window path it replaced (kept below as the
  reference), on H5 and MMP sequences, with and without event-rate
  sub-windows, and goes through the native packer.
"""

import shutil

import numpy as np
import pytest
import torch

from bde2vid_tpu.events.h5_io import H5EventWriter
from bde2vid_tpu.events.tools import h5_to_memmap
from bde2vid_tpu.native import loader as jax_native
from bde2vid_tpu_torch.data.pipeline import load_sequence
from bde2vid_tpu_torch.events.voxel import events_to_voxel_batch
from bde2vid_tpu_torch.native import evpack, pack_counts, pack_windows, voxelize_batch
from tests.conftest import make_events

SENSOR = (35, 45)


@pytest.fixture(scope="module")
def stream():
    """int16 xs, ys, epoch-scale f64 ts, 0/1 uint8 ps, as the readers give them."""
    rng = np.random.default_rng(21)
    n = 3000
    return (rng.integers(0, 45, n).astype(np.int16), rng.integers(0, 35, n).astype(np.int16),
            1.6e9 + np.sort(rng.uniform(0, 2.0, n)), rng.integers(0, 2, n).astype(np.uint8))


# [start, end): empty, at capacity (400), overlapping, one event, the stream's tail
WINDOWS = np.array([[0, 0], [10, 410], [300, 650], [650, 651], [1000, 1000], [2700, 3000],
                    [2900, 3000]], np.int64)
CAPACITY = 400


@pytest.mark.parametrize("packer", ["native", "numpy"])
def test_pack_windows_is_bit_equal_to_jax(stream, packer):
    want = jax_native.pack_windows(*stream, WINDOWS, CAPACITY)
    before = pack_counts[packer]
    got = pack_windows(*stream, WINDOWS, CAPACITY, packer=packer)
    assert pack_counts[packer] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[4].tolist() == [0, 400, 350, 1, 0, 300, 100]
    # timestamps rebased per window in f64: distinct values survive the f32 cast
    assert len(np.unique(got[2][1, :400])) > 390
    # given buffers are filled in place
    out = [np.full_like(a, 7) for a in want]
    assert all(a is b for a, b in zip(pack_windows(*stream, WINDOWS, CAPACITY, packer, out), out))
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("packer", ["native", "numpy"])
@pytest.mark.parametrize("windows,capacity,match", [
    ([[0, 10], [-1, 5]], 16, "out of range"),
    ([[2990, 3001]], 16, "out of range"),
    ([[20, 10]], 16, "end precedes start"),
    ([[0, 17]], 16, "exceeds capacity"),
])
def test_bad_windows_raise_before_the_library(stream, packer, windows, capacity, match):
    with pytest.raises(ValueError, match=match):
        pack_windows(*stream, np.array(windows), capacity, packer=packer)


def test_bad_arguments_raise(stream):
    xs, ys, ts, ps = stream
    with pytest.raises(ValueError, match="differ in length"):
        pack_windows(xs[:-1], ys, ts, ps, WINDOWS, CAPACITY)
    with pytest.raises(ValueError, match="packer"):
        pack_windows(*stream, WINDOWS, CAPACITY, packer="cuda")
    out = [np.empty(a.shape, a.dtype) for a in pack_windows(*stream, WINDOWS, CAPACITY)]
    out[3] = out[3].astype(np.int16)
    with pytest.raises(ValueError, match="C-contiguous buffers"):
        pack_windows(*stream, WINDOWS, CAPACITY, out=out)


def test_voxelize_batch_is_bit_equal_to_jax(stream):
    packed = pack_windows(*stream, WINDOWS, CAPACITY)
    want = jax_native.voxelize_batch_native(*packed, num_bins=5, sensor_size=SENSOR)
    got = voxelize_batch(*packed, num_bins=5, sensor_size=SENSOR)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[1]).sum() > 0 and not got[3].any()  # under 3 events: zero


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on this machine")
def test_library_builds_by_source_hash_and_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(evpack, "BUILD_DIR", tmp_path / "native")
    path = evpack.build()
    assert path == evpack.library_path() and path.exists()
    assert path.parent == tmp_path / "native" and path.name.startswith("evpack-")
    bad = tmp_path / "evpack.cc"
    bad.write_text("int pack_windows( {\n")
    monkeypatch.setattr(evpack, "_SRC", bad)
    assert evpack.library_path() != path
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build evpack.cc:\n.*error"):
        evpack.build()


# ---------------------------------------------- EventSequence.voxels vs per window


def per_window_voxels(seq, start, stop, batch):
    """The per-window path ``EventSequence.voxels`` had before it packed spans:
    one reader call per window, int32 coordinates and f32 polarity, padded
    to the batch's largest window."""
    def raw_window(i):
        i0, i1 = (int(v) for v in seq.windows[i])
        xs, ys, ts, ps = seq.reader.raw_events(i0, i1)
        n = len(xs)
        ts = np.asarray(ts, np.float64)
        ts_rel = (ts - ts[0]).astype(np.float32) if n else np.zeros(0, np.float32)
        return (np.asarray(xs, np.int32), np.asarray(ys, np.int32), ts_rel,
                np.where(np.asarray(ps) > 0, 1.0, -1.0).astype(np.float32), n)

    out = []
    for s in range(start, stop, batch):
        wins = [raw_window(i) for i in range(s, min(s + batch, stop))]
        cap, c = max(1, max(w[4] for w in wins)), len(wins)
        xs, ys = np.zeros((c, cap), np.int32), np.zeros((c, cap), np.int32)
        ts, ps = np.zeros((c, cap), np.float32), np.zeros((c, cap), np.float32)
        ns = np.zeros(c, np.int64)
        for j, (x, y, t, p, n) in enumerate(wins):
            xs[j, :n], ys[j, :n], ts[j, :n], ps[j, :n] = x, y, t, p
            ts[j, n:] = t[n - 1] if n else 0.0
            ns[j] = n
        tensors = [torch.from_numpy(a) for a in (xs, ys, ts, ps, ns)]
        v = events_to_voxel_batch(*tensors, num_bins=seq.num_bins, sensor_size=seq.sensor_size)
        v = torch.where((tensors[4] < 3)[:, None, None, None], torch.zeros_like(v), v)
        out.append(v)
    return torch.cat(out)


@pytest.fixture(scope="module")
def sequence_paths(tmp_path_factory):
    """An H5 file (with an empty window) and its MMP copy."""
    root = tmp_path_factory.mktemp("pack_seq")
    rng = np.random.default_rng(22)
    xs, ys, ts, ps = make_events(rng, n=6000, sensor_size=SENSOR, t1=1.0)
    ts = ts.astype(np.float64)
    ts[(ts > 0.3) & (ts < 0.45)] = 0.29  # no events between frames 2 and 3
    order = np.argsort(ts, kind="stable")
    h5 = str(root / "seq.h5")
    with H5EventWriter(h5, sensor_size=SENSOR) as w:
        w.append_events(xs[order], ys[order], ts[order] + 1.6e9, ps[order] > 0)
        for i in range(8):
            w.add_image(rng.uniform(0, 255, SENSOR).astype(np.uint8), 1.6e9 + (i + 0.5) / 8)
    mmp = str(root / "mmp")
    h5_to_memmap(h5, mmp)
    return {"H5": h5, "MMP": mmp}


@pytest.mark.parametrize("ltype", ["H5", "MMP"])
@pytest.mark.parametrize("ev_rate,batch", [(None, 3), (None, 64), (0.3, 4)])
def test_voxels_are_bit_equal_to_the_per_window_path(sequence_paths, ltype, ev_rate, batch):
    seq = load_sequence(sequence_paths[ltype], ltype=ltype, ev_rate=ev_rate)
    try:
        n = len(seq.windows)
        counts = (seq.windows[:, 1] - seq.windows[:, 0]).tolist()
        assert 0 in counts or ev_rate is not None
        if ev_rate is not None:
            assert n > len(seq)
        before = pack_counts["native"]
        got = seq.voxels(device="cpu", batch=batch)
        assert pack_counts["native"] == before + -(-n // batch)
        want = per_window_voxels(seq, 0, n, batch)
        assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got, want)
        assert torch.equal(seq.voxels(2, n - 1, device="cpu", batch=batch),
                           per_window_voxels(seq, 2, n - 1, batch))
    finally:
        seq.reader.close()
