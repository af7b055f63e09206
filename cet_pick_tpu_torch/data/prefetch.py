"""Background-thread prefetching with host -> device copy overlap — port of
``cet_pick_tpu/data/prefetch.py`` (``PrefetchIterator``).

The reference uses a torch DataLoader worker + pin_memory (reference:
cet_pick/main.py:84-91, test.py:19-60 ``PrefetchDataset``). Here a producer
thread runs the (numpy) pipeline and ships each item's arrays to the device
while the consumer computes on the previous item: on CUDA every array is
copied into pinned host memory and then, on a side stream, to the device
with ``non_blocking=True``. The consumer's stream waits on that copy's
event before the item is handed over, and each tensor is recorded on the
consumer's stream so the caching allocator does not reuse it early.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


def _map_arrays(item, fn):
    """Apply ``fn`` to every ndarray / tensor in a tuple, list or dict."""
    if isinstance(item, (np.ndarray, torch.Tensor)):
        return fn(item)
    if isinstance(item, (tuple, list)):
        return type(item)(_map_arrays(v, fn) for v in item)
    if isinstance(item, dict):
        return {k: _map_arrays(v, fn) for k, v in item.items()}
    return item


class PrefetchIterator:
    """Wrap an iterator; keep ``depth`` items in flight on ``device``.

    A consumer that stops early should call :meth:`close` — or use the
    iterator as a context manager — so the producer thread is released and
    its in-flight items are dropped. The producer closes over locals, not
    ``self``, so an abandoned iterator is also released by GC.
    """

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, depth: int = 2, device="cuda"):
        self._device = torch.device(device)
        self._q = queue.Queue(maxsize=depth)
        self._errs = []
        self._exhausted = False
        self._stop = threading.Event()
        q, stop, errs, sentinel = self._q, self._stop, self._errs, self._SENTINEL
        dev = self._device
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def to_device(a):
            t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            if stream is None:
                return t.to(dev)
            with torch.cuda.stream(stream):
                return t.pin_memory().to(dev, non_blocking=True)

        def worker():
            try:
                for batch in iterator:
                    item = _map_arrays(batch, to_device)
                    event = None
                    if stream is not None:
                        event = torch.cuda.Event()
                        event.record(stream)
                    while not stop.is_set():
                        try:
                            q.put((item, event), timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    del item  # after a successful put the consumer owns it
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced on the consumer side
                errs.append(e)
            finally:
                # the sentinel must reach the consumer: block, stop-aware,
                # like the item puts (close() sets _stop and drains)
                while not stop.is_set():
                    try:
                        q.put((sentinel, None), timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        # the sentinel is enqueued once: remember exhaustion so every later
        # call raises StopIteration instead of blocking on the empty queue
        if self._exhausted:
            raise StopIteration
        item, event = self._q.get()
        if item is self._SENTINEL:
            self._exhausted = True
            if self._errs:
                raise self._errs[0]
            raise StopIteration
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            _map_arrays(item, lambda t: t.record_stream(consumer))
        return item

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def close(self):
        """Release the producer thread and drop queued items. Drain and join
        alternate until the thread is dead: a producer blocked in ``put``
        can still complete that put into the just-drained queue."""
        self._stop.set()
        deadline = 50  # 5 s at 0.1 s joins; the thread only sleeps 0.1 s
        while self._thread.is_alive() and deadline > 0:
            self._drain()
            self._thread.join(timeout=0.1)
            deadline -= 1
        self._drain()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter shutdown

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
