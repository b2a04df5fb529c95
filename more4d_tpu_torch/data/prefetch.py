"""Threaded prefetching for the trainers' sample preparation (PyTorch port
of ``more4d_tpu/data/prefetch.py``).

The reference assembles samples in torch DataLoader worker processes. The
host work here (pickle reads, resizes, the z-buffer projection, whose torch
ops release the GIL) runs in a few threads feeding a bounded queue
instead: while step N runs on the card, the workers assemble samples
N+1..N+depth, and nothing is pickled between processes.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, TypeVar

T = TypeVar("T")

_STOP = object()


class PrefetchIterator:
    """Wrap an iterator so ``depth`` items are produced ahead of
    consumption by ``num_workers`` threads calling ``producer`` on the
    items pulled from ``source``.

    For an already-assembled stream use ``prefetch(it, depth)``. An error
    raised by the source or the producer is raised again in the consumer,
    which then stops the workers."""

    def __init__(self, source: Iterator, producer: Callable[[object], T],
                 num_workers: int = 2, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._source = source
        self._producer = producer
        self._source_lock = threading.Lock()
        self._done = threading.Event()
        self._threads = [threading.Thread(target=self._work, daemon=True)
                         for _ in range(num_workers)]
        self._live = num_workers
        self._live_lock = threading.Lock()
        for t in self._threads:
            t.start()

    def _next_item(self):
        with self._source_lock:
            return next(self._source)

    def _work(self):
        while not self._done.is_set():
            try:
                item = self._next_item()
            except StopIteration:
                break
            except Exception as e:  # the source's error, for the consumer
                self._q.put(("error", e))
                break
            try:
                self._q.put(("ok", self._producer(item)))
            except Exception as e:
                self._q.put(("error", e))
        with self._live_lock:
            self._live -= 1
            if self._live == 0:
                self._q.put((_STOP, None))

    def __iter__(self):
        return self

    def __next__(self) -> T:
        kind, payload = self._q.get()
        if kind is _STOP:
            raise StopIteration
        if kind == "error":
            self.close()
            raise payload
        return payload

    def close(self):
        """Stop the workers: each finishes the item it holds, and the queue
        is drained so none blocks on a full queue."""
        self._done.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def prefetch(iterator: Iterator[T], depth: int = 4,
             num_workers: int = 2) -> PrefetchIterator:
    """Prefetch already-assembled items from ``iterator``."""
    return PrefetchIterator(iterator, lambda x: x, num_workers=num_workers,
                            depth=depth)
