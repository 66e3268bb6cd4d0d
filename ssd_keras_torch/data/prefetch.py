"""Background prefetching for host data generators.

Vendored from ``ssd_keras_tpu/data/prefetch.py`` (standard-library threads,
no framework): worker threads pull batches into a bounded queue so the
host's work overlaps the device's. An exception in a worker reaches the
consumer at its next ``next``. ``stop`` also joins the workers. Unlike the
JAX package's, batches keep the wrapped generator's order with several
workers.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

__all__ = ["PrefetchGenerator", "prefetch"]

_SENTINEL = object()


class PrefetchGenerator:
    """Wraps an iterator; worker threads keep ``buffer_size`` batches ready."""

    def __init__(self, generator: Iterator, buffer_size: int = 4, n_workers: int = 1):
        self._generator = generator
        self._queue: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._lock = threading.Lock()  # generators aren't thread-safe
        self._stopped = threading.Event()
        self._workers = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(max(1, n_workers))
        ]
        for w in self._workers:
            w.start()

    def _worker(self):
        # The put stays under the lock, so batches reach the queue in the
        # generator's order (a streamed pipeline seeds batch i by i).
        while not self._stopped.is_set():
            with self._lock:
                try:
                    item = next(self._generator)
                except StopIteration:
                    self._queue.put(_SENTINEL)
                    return
                except Exception as e:  # surface errors to the consumer
                    self._queue.put(e)
                    return
                self._queue.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _SENTINEL:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def stop(self, timeout: float = 10.0):
        """Stop the workers: drain the queue until each has left its loop
        (a worker blocked on a full queue needs the room), then join them.
        A worker still inside the wrapped generator after ``timeout``
        seconds raises ``RuntimeError``."""
        self._stopped.set()
        deadline = time.monotonic() + timeout
        for w in self._workers:
            while w.is_alive():
                self._drain()
                w.join(timeout=0.01)
                if w.is_alive() and time.monotonic() > deadline:
                    raise RuntimeError("a prefetch worker did not stop")
        self._drain()

    def _drain(self):
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    @property
    def workers_alive(self) -> int:
        return sum(w.is_alive() for w in self._workers)


def prefetch(generator: Iterator, buffer_size: int = 4, n_workers: int = 1):
    """Convenience: ``for batch in prefetch(gen.generate(...)): ...``"""
    return PrefetchGenerator(generator, buffer_size=buffer_size, n_workers=n_workers)
