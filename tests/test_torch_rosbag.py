"""Port parity of the h5 writer's flow (``events/h5_io.py``), the rosbag
packaging (``events/rosbag.py``) on fake ROS-shaped messages, and the
rasterization micro-benchmark (``events/bench_voxel.py``). CPU; no ROS
package is needed."""

import sys
from types import SimpleNamespace as NS

import h5py
import numpy as np
import pytest
import torch

from bde2vid_tpu.events import rosbag as jrb
from bde2vid_tpu.events.h5_io import H5EventWriter as JaxWriter
from bde2vid_tpu_torch.events import bench_voxel
from bde2vid_tpu_torch.events import rosbag as trb
from bde2vid_tpu_torch.events.h5_io import H5EventWriter


def h5_tree(path):
    """({dataset: (array, attrs)}, file attrs)."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, d: out.__setitem__(n, (d[()], dict(d.attrs)))
                     if isinstance(d, h5py.Dataset) else None)
        return out, dict(f.attrs)


def assert_same_h5(a, b):
    (da, aa), (db, ab) = h5_tree(a), h5_tree(b)
    assert sorted(da) == sorted(db) and sorted(aa) == sorted(ab)
    for k in da:
        assert da[k][0].dtype == db[k][0].dtype and np.array_equal(da[k][0], db[k][0]), k
        assert sorted(da[k][1]) == sorted(db[k][1]), k
        for name in da[k][1]:
            assert np.array_equal(da[k][1][name], db[k][1][name]), (k, name)
    for name in aa:
        assert np.array_equal(aa[name], ab[name]), name


def test_writer_writes_flow_like_jax(tmp_path):
    """Images and flow written by both writers: equal datasets and attrs,
    ``num_flow`` counted and ``event_idx`` stamped on the flow too."""
    rng = np.random.default_rng(0)
    ts = np.sort(rng.uniform(10.0, 11.0, 3000))
    ev = (rng.integers(0, 40, 3000), rng.integers(0, 30, 3000), ts, rng.integers(0, 2, 3000) > 0)
    frames = [(rng.integers(0, 256, (30, 40)).astype(np.uint8), 10.1 + 0.2 * i) for i in range(4)]
    flows = [(rng.normal(size=(2, 30, 40)), 10.05 + 0.3 * i) for i in range(3)]
    paths = []
    for name, writer in (("port", H5EventWriter), ("jax", JaxWriter)):
        path = str(tmp_path / f"{name}.h5")
        w = writer(path, sensor_size=(30, 40))
        w.append_events(*ev)
        for img, t in frames:
            w.add_image(img, t)
        for flow, t in flows:
            w.add_flow(flow, t)
        w.finalize()
        paths.append(path)
    assert_same_h5(*paths)
    datasets, attrs = h5_tree(paths[0])
    assert attrs["num_flow"] == 3 and datasets["flow/flow000000002"][0].dtype == np.float32
    idx = int(np.searchsorted(ts, flows[1][1])) - 1
    assert datasets["flow/flow000000001"][1]["event_idx"] == idx > 0


def stamp(t):
    return NS(secs=int(t), nsecs=int(round((t - int(t)) * 1e9)))


def image_msg(rng, t, enc, h=12, w=16, pad=3):
    """A sensor_msgs/Image of ``enc`` with rows padded by ``pad`` bytes."""
    ch = 1 if enc == "mono8" else 3
    step = w * ch + pad
    data = rng.integers(0, 256, h * step).astype(np.uint8).tobytes()
    return NS(header=NS(stamp=stamp(t)), height=h, width=w, encoding=enc, step=step, data=data)


def message_stream(rng, enc="mono8", n_msgs=6, per_msg=40, sensor=(12, 16)):
    """(topic, message) pairs: event arrays, images and flow, interleaved."""
    out, t = [], 1_600_000_000.25
    for i in range(n_msgs):
        events = [NS(x=int(rng.integers(0, sensor[1])), y=int(rng.integers(0, sensor[0])),
                     ts=stamp(t + 0.001 * j), polarity=bool(rng.integers(0, 2)))
                  for j in range(per_msg)]
        out.append(("/cam0/events", NS(header=NS(stamp=stamp(t)), events=events)))
        if i % 2 == 0:
            out.append(("/cam0/image_raw", image_msg(rng, t + 0.02, enc, *sensor)))
        if i % 3 == 1:
            fx = rng.normal(size=sensor[0] * sensor[1]).tolist()
            fy = rng.normal(size=sensor[0] * sensor[1]).tolist()
            out.append(("/cam0/optic_flow", NS(header=NS(stamp=stamp(t + 0.03)), height=sensor[0],
                                               width=sensor[1], flow_x=fx, flow_y=fy)))
        out.append(("/other", NS(header=NS(stamp=stamp(t)))))
        t += 0.05
    return out


EXTRACTOR_CASES = {
    "mono8": dict(enc="mono8", kw={}),
    "bgr8_zero_ts": dict(enc="bgr8", kw=dict(zero_timestamps=True)),
    "rgb8_color": dict(enc="rgb8", kw=dict(is_color=True, zero_timestamps=True)),
    "flush": dict(enc="mono8", kw=dict(max_buffer=50, sensor_size=(20, 30))),
    "events_only": dict(enc=None, kw={}),
}


@pytest.mark.parametrize("case", sorted(EXTRACTOR_CASES))
def test_bag_message_extractor_matches_jax(tmp_path, case):
    enc, kw = EXTRACTOR_CASES[case]["enc"], EXTRACTOR_CASES[case]["kw"]
    stream = message_stream(np.random.default_rng(1), enc or "mono8")
    image_topic = None if enc is None else "/cam0/image_raw"
    flow_topic = None if enc is None else "/cam0/optic_flow"
    paths = []
    for name, mod in (("port", trb), ("jax", jrb)):
        path = str(tmp_path / f"{name}.h5")
        ex = mod.BagMessageExtractor(path, "/cam0/events", image_topic, flow_topic, **kw)
        for topic, msg in stream:
            ex.consume(topic, msg)
        ex.finish()
        paths.append(path)
    assert_same_h5(*paths)
    datasets, attrs = h5_tree(paths[0])
    assert attrs["num_events"] == 240
    if case == "events_only":  # the sensor size inferred from the events
        assert tuple(attrs["sensor_resolution"]) == (12, 16) and attrs["num_imgs"] == 0
    if case == "flush":
        assert tuple(attrs["sensor_resolution"]) == (20, 30) and attrs["num_flow"] == 2


@pytest.mark.parametrize("enc", ["mono8", "bgr8", "rgb8"])
@pytest.mark.parametrize("is_color", [False, True])
def test_decode_image_msg_byte_equal(enc, is_color):
    msg = image_msg(np.random.default_rng(2), 1.0, enc, pad=0 if is_color else 5)
    got = trb.decode_image_msg(msg, is_color)
    ref = jrb.decode_image_msg(msg, is_color)
    assert got.dtype == ref.dtype == np.uint8 and np.array_equal(got, ref)
    assert got.shape == ((12, 16, 3) if is_color else (12, 16))


def test_decode_image_msg_refusals():
    msg = image_msg(np.random.default_rng(3), 1.0, "mono8")
    with pytest.raises(ValueError, match="unsupported image encoding"):
        trb.decode_image_msg(NS(**{**vars(msg), "encoding": "16UC1"}))
    with pytest.raises(ValueError, match="image buffer too small"):
        trb.decode_image_msg(NS(**{**vars(msg), "step": 8}))
    assert trb.timestamp_float(stamp(3.25)) == jrb.timestamp_float(stamp(3.25)) == 3.25


def test_rosbag_to_h5_names_the_extractor_without_ros(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "rosbag", None)
    with pytest.raises(ImportError, match="BagMessageExtractor"):
        trb.rosbag_to_h5(str(tmp_path), str(tmp_path / "out"))


ROWS = ("events_to_image", "events_to_image_bilinear", "events_to_voxel (B=5)",
        "events_to_neg_pos_voxel", "events_to_timestamp_image", "events_to_voxel_batch (64 windows)",
        "native pack_windows (host)", "native voxelize_batch (host)")


def test_bench_voxel_prints_every_row(capsys):
    assert bench_voxel.main(["--device", "cpu", "--n_events", "2000", "--iters", "2"]) == 0
    out = capsys.readouterr().out
    for row in ROWS:
        assert f"\n{row} " in out and "Mev/s" in out.split(f"\n{row} ")[1].splitlines()[0], row
    assert "h5 binary search" not in out


def test_bench_voxel_reads_an_h5(tmp_path, capsys):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "seq.h5")
    with H5EventWriter(path, sensor_size=(30, 40)) as w:
        w.append_events(rng.integers(0, 40, 3000), rng.integers(0, 30, 3000),
                        np.sort(rng.uniform(0, 1, 3000)), rng.integers(0, 2, 3000) > 0)
    assert bench_voxel.main(["--h5", path, "--device", "cpu", "--n_events", "2000",
                             "--iters", "2"]) == 0
    out = capsys.readouterr().out
    assert "2000 events, sensor (30, 40)" in out and "h5 binary search (host)" in out


def test_bench_voxel_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_voxel.main(["--n_events", "2000", "--iters", "2"])
