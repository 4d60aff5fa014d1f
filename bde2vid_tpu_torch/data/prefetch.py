"""Background assembly of training batches (counterpart of
``bde2vid_tpu/data/prefetch.py``).

A daemon thread pulls the next ``size`` items from an iterator while the
caller computes on the current one: the torch-native form of DataLoader
workers for a window stream whose assembly ends on the device. On CUDA the
thread assembles on a stream of its own; each item carries an event
recorded on that stream after its assembly, the consumer's stream waits on
it before the item is used, and every tensor of the item is marked as used
by the consumer's stream (``record_stream``), so the caching allocator does
not hand its memory back to the assembly stream while the consumer's work
on it is still queued.

An exception in the thread is raised in the consumer at the item where it
happened; ``close()`` (also on leaving a ``with`` block, and when the
consumer stops early) stops the thread and waits for it to end.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

_END = object()


def _tensors(item: Any):
    """The tensors of a (nested) tuple, list or dict item."""
    if isinstance(item, torch.Tensor):
        yield item
    elif isinstance(item, (tuple, list)):
        for x in item:
            yield from _tensors(x)
    elif isinstance(item, dict):
        for x in item.values():
            yield from _tensors(x)


class Prefetcher:
    """Iterate ``iterable`` with up to ``size`` items assembled ahead by a
    daemon thread. ``device``: where the items' tensors live (a CUDA device
    gets its assembly stream; the CPU needs none)."""

    def __init__(self, iterable: Iterable, size: int = 2, device: Optional[torch.device] = None):
        if size < 1:
            raise ValueError(f"prefetch size must be at least 1, got {size}")
        self._it = iter(iterable)
        self._device = torch.device("cpu" if device is None else device)
        self._queue: "queue.Queue" = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._produce, name="prefetch", daemon=True)
        self._thread.start()

    def _put(self, entry) -> bool:
        """Queue ``entry`` unless stopped first; False when stopped."""
        while not self._stop.is_set():
            try:
                self._queue.put(entry, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        cuda = self._device.type == "cuda"
        stream = torch.cuda.Stream(self._device) if cuda else None
        end = (_END, None, None)
        try:
            with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
                while not self._stop.is_set():
                    try:
                        item = next(self._it)
                    except StopIteration:
                        break
                    ready = None
                    if cuda:
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    if not self._put((item, ready, None)):
                        return
        except Exception as e:  # raised again in the consumer
            end = (None, None, e)
        finally:  # the consumer never waits on a thread that has ended
            self._put(end)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item, ready, err = self._queue.get()
        if err is not None or item is _END:
            self.close()
            if err is not None:
                raise err
            raise StopIteration
        if ready is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            for t in _tensors(item):
                if t.device.type == "cuda":
                    t.record_stream(consumer)
        return item

    def close(self) -> None:
        """Stop the thread and wait for it; items not yet taken are dropped."""
        self._done = True
        self._stop.set()
        while self._thread.is_alive():
            try:  # a producer blocked on a full queue sees the stop flag
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()



def prefetch_to_device(iterable: Iterable, size: int = 2, device=None) -> Prefetcher:
    """A :class:`Prefetcher` over ``iterable`` whose items' tensors and NumPy
    arrays are moved to ``device`` (CUDA unless the CPU is asked for) by the
    thread, so that the copies overlap the consumer's work (the JAX
    package's ``prefetch_to_device``)."""
    from bde2vid_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)

    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor):
            return x.to(device, non_blocking=True)
        if isinstance(x, (tuple, list)):
            return type(x)(put(v) for v in x)
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        return x

    return Prefetcher((put(item) for item in iterable), size=size, device=device)
