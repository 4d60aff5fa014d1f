"""Event windowing policies (counterpart of ``bde2vid_tpu/data/windowing.py``;
reference h5_dataset.py:320-366, 447-455).

Each policy returns an (L, 2) int64 array of [idx0, idx1) event-index windows:

- between_frames: window i ends at frame i's event index and starts where
  window i-1 ended;
- k_events: ``k`` events a window, consecutive windows ``k -
  sliding_window_w`` events apart (they overlap when ``sliding_window_w`` >
  0);
- t_seconds: ``t`` seconds a window, ``t - sliding_window_t`` seconds apart;
  each window starts where the previous one ended.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def between_frames_windows(frame_event_indices: np.ndarray) -> np.ndarray:
    """(num_frames, 2) int64 [idx0, idx1) windows: window i ends at frame i's
    event index and starts where window i-1 ended."""
    ends = np.asarray(frame_event_indices, np.int64)
    starts = np.concatenate([[0], ends[:-1]])
    return np.stack([starts, ends], axis=1)


def k_events_windows(num_events: int, k: int, sliding_window_w: int = 0) -> np.ndarray:
    """``int(num_events / (k - sliding_window_w))`` windows of ``k`` events
    (the last ones clipped to the stream's end); raises ``ValueError`` when
    the step is not positive."""
    step = k - sliding_window_w
    if step <= 0:
        raise ValueError("sliding_window_w must be < k")
    length = max(int(num_events / step), 0)
    starts = step * np.arange(length, dtype=np.int64)
    return np.stack([starts, np.minimum(starts + k, num_events)], axis=1)


def t_seconds_windows(find_ts_index: Callable[[float], int], t0: float, duration: float,
                      t: float, sliding_window_t: float = 0.0) -> np.ndarray:
    """``int(duration / (t - sliding_window_t))`` windows: window i ends at
    the first event at or after ``t0 + step * i + t`` (``find_ts_index``, a
    reader's ``search_time``) and starts where window i-1 ended; raises
    ``ValueError`` when the step is not positive."""
    step = t - sliding_window_t
    if step <= 0:
        raise ValueError("sliding_window_t must be < t")
    windows, start_idx = [], 0
    for i in range(max(int(duration / step), 0)):
        end_idx = find_ts_index(step * i + t0 + t)
        windows.append([start_idx, end_idx])
        start_idx = end_idx
    return np.asarray(windows, np.int64).reshape(-1, 2)
