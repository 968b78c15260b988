"""Background-thread prefetching for the host input pipeline — port of the
JAX package's ``data/prefetch.py``.

A bounded-queue thread overlaps host-side collation (numpy) with device
steps; numpy releases the GIL for most of its work, so one thread suffices.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator


class PrefetchIterator:
    """Wrap an iterator; pull items on a background thread into a bounded queue."""

    _SENTINEL = object()

    def __init__(self, src: Iterable, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None

        def worker():
            try:
                for item in src:
                    self._q.put(item)
            except BaseException as e:  # propagate into the consumer
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(src: Iterable, depth: int = 4) -> PrefetchIterator:
    return PrefetchIterator(src, depth)
