"""rosbag -> canonical event h5 (counterpart of ``bde2vid_tpu/events/rosbag.py``;
reference rosbag_to_h5.py:42-136).

- ``BagMessageExtractor`` packages a stream of (topic, message) pairs with
  ROS-shaped messages (EventArray ``.events`` of ``.x/.y/.ts/.polarity``,
  Image ``.height/.width/.encoding/.step/.data``, flow ``.flow_x/.flow_y``)
  into the canonical h5 through ``H5EventWriter``; it needs no ROS package.
- ``rosbag_to_h5`` opens .bag files with the ROS ``rosbag`` package and
  raises an ImportError naming the extractor when that is absent.

All of it runs on the host.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional, Sequence, Tuple

import numpy as np

from bde2vid_tpu_torch.events.h5_io import H5EventWriter


def timestamp_float(stamp) -> float:
    """ROS Time -> float seconds (reference :19-20)."""
    return stamp.secs + stamp.nsecs / 1e9


def decode_image_msg(msg, is_color: bool = False) -> np.ndarray:
    """Minimal sensor_msgs/Image decoding (mono8 / bgr8 / rgb8) — replaces
    CvBridge (reference :78-82) for the encodings the converters produce."""
    h, w = int(msg.height), int(msg.width)
    buf = np.frombuffer(bytes(msg.data), np.uint8)
    enc = getattr(msg, "encoding", "mono8")
    # honor sensor_msgs/Image.step (row stride in bytes) like CvBridge:
    # aligned camera drivers pad rows, so a bare reshape(h, w[, 3]) fails
    def rows(channels: int) -> np.ndarray:
        step = int(getattr(msg, "step", 0) or w * channels)
        if step < w * channels or len(buf) < h * step:
            raise ValueError(
                f"image buffer too small: step={step}, {len(buf)} bytes for "
                f"{h}x{w}x{channels}"
            )
        out = buf[: h * step].reshape(h, step)[:, : w * channels]
        return out.reshape(h, w) if channels == 1 else out.reshape(h, w, channels)

    if enc == "mono8":
        img = rows(1)
        if is_color:
            img = np.stack([img] * 3, axis=-1)
        return img
    if enc in ("bgr8", "rgb8"):
        img = rows(3)
        if enc == "rgb8":
            img = img[..., ::-1]  # to bgr, like CvBridge 'bgr8'
        if not is_color:
            # OpenCV's exact fixed-point BGR2GRAY (ITU-R 601 luma):
            # (B*1868 + G*9617 + R*4899 + 8192) >> 14 — integer math so
            # packaged frames are byte-identical to a CvBridge('mono8')
            # path; float np.round is half-to-even and can differ by one
            # code value at .5 luma boundaries
            b = img[..., 0].astype(np.int32)
            g = img[..., 1].astype(np.int32)
            r = img[..., 2].astype(np.int32)
            img = ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14).astype(np.uint8)
        return img
    raise ValueError(f"unsupported image encoding {enc!r}")


class BagMessageExtractor:
    """Package a (topic, message) stream into the canonical h5.

    Reference semantics (rosbag_to_h5.py:42-136): the first message on any
    watched topic pins ``first_ts``; with ``zero_timestamps`` every stored
    timestamp is shifted by it; events buffer up to ``max_buffer`` before a
    chunked append; images record the sensor size.
    """

    def __init__(
        self,
        output_path: str,
        event_topic: str,
        image_topic: Optional[str] = None,
        flow_topic: Optional[str] = None,
        zero_timestamps: bool = False,
        is_color: bool = False,
        sensor_size: Optional[Tuple[int, int]] = None,
        max_buffer: int = 1_000_000,
    ):
        self.writer = H5EventWriter(output_path, sensor_size=sensor_size or (180, 240))
        self._explicit_sensor = sensor_size is not None
        self.topics = (event_topic, image_topic, flow_topic)
        self.event_topic = event_topic
        self.image_topic = image_topic
        self.flow_topic = flow_topic
        self.zero_timestamps = zero_timestamps
        self.is_color = is_color
        self.max_buffer = max_buffer
        self.first_ts: Optional[float] = None
        self._xs, self._ys, self._ts, self._ps = [], [], [], []
        self._max_x = self._max_y = -1

    def _shift(self, t: float) -> float:
        return t - self.first_ts if self.zero_timestamps else t

    def consume(self, topic: str, msg) -> None:
        if self.first_ts is None and topic in self.topics:
            self.first_ts = timestamp_float(msg.header.stamp)
        if topic == self.image_topic:
            t = self._shift(timestamp_float(msg.header.stamp))
            img = decode_image_msg(msg, self.is_color)
            self.writer.add_image(img, t)
            if not self._explicit_sensor:
                self.writer.sensor_size = img.shape[:2]
                self._explicit_sensor = True
        elif topic == self.flow_topic:
            t = self._shift(timestamp_float(msg.header.stamp))
            fx = np.asarray(msg.flow_x, np.float32).reshape(msg.height, msg.width)
            fy = np.asarray(msg.flow_y, np.float32).reshape(msg.height, msg.width)
            self.writer.add_flow(np.stack([fx, fy]), t)
        elif topic == self.event_topic:
            for e in msg.events:
                self._xs.append(e.x)
                self._ys.append(e.y)
                self._ts.append(self._shift(timestamp_float(e.ts)))
                self._ps.append(bool(e.polarity))
                if e.x > self._max_x:
                    self._max_x = e.x
                if e.y > self._max_y:
                    self._max_y = e.y
            if len(self._xs) > self.max_buffer:
                self._flush()

    def _flush(self) -> None:
        if not self._xs:
            return
        self.writer.append_events(
            np.asarray(self._xs, np.int16),
            np.asarray(self._ys, np.int16),
            np.asarray(self._ts, np.float64),
            np.asarray(self._ps),
        )
        self._xs, self._ys, self._ts, self._ps = [], [], [], []

    def finish(self) -> None:
        self._flush()
        if not self._explicit_sensor and self._max_y >= 0:
            # infer from events, like the reference (:117-118)
            self.writer.sensor_size = (self._max_y + 1, self._max_x + 1)
        self.writer.finalize()  # writes file attrs + event_idx, closes


def rosbag_to_h5(
    path: str,
    output_dir: str,
    event_topic: str = "/cam0/events",
    image_topic: Optional[str] = "/cam0/image_raw",
    flow_topic: Optional[str] = "/cam0/optic_flow",
    zero_timestamps: bool = True,
    is_color: bool = False,
    sensor_size: Optional[Tuple[int, int]] = None,
) -> Sequence[str]:
    """Convert .bag file(s) to canonical h5 (reference __main__ :150-179).

    Requires the rosbag package; raises a clear ImportError without it —
    the packaging logic itself lives in BagMessageExtractor and has no
    rosbag dependency.
    """
    try:
        import rosbag  # type: ignore
    except ImportError as err:
        raise ImportError(
            "rosbag is not available in this environment; the h5 packaging "
            "logic is in BagMessageExtractor (rosbag-free) — feed it "
            "(topic, message) pairs from any bag reader"
        ) from err

    paths = (
        sorted(glob(os.path.join(path, "*.bag"))) if os.path.isdir(path) else [path]
    )
    os.makedirs(output_dir, exist_ok=True)
    outputs = []
    for bag_path in paths:
        name = os.path.splitext(os.path.basename(bag_path))[0]
        out = os.path.join(output_dir, f"{name}.h5")
        ex = BagMessageExtractor(
            out,
            event_topic,
            image_topic,
            flow_topic,
            zero_timestamps=zero_timestamps,
            is_color=is_color,
            sensor_size=sensor_size,
        )
        with rosbag.Bag(bag_path, "r") as bag:
            for topic, msg, _t in bag.read_messages():
                ex.consume(topic, msg)
        ex.finish()
        outputs.append(out)
    return outputs
