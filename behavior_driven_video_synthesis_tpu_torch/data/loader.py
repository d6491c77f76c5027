"""Batches prepared one step ahead on a background thread.

Counterpart of ``prefetch_iter`` in
``behavior_driven_video_synthesis_tpu/data/loader.py`` (the Human3.6M
``Loader`` is not ported yet, ROADMAP A6b).  ``prepare`` usually copies a
batch to the device (from pinned memory, without blocking), so the copy of
the next batch overlaps the device's work on the current one.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

_SENTINEL = object()


def _put_until_stopped(q: "queue.Queue", item, stop: threading.Event
                       ) -> bool:
    """Put item, giving up once ``stop`` is set; True if it was put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def prefetch_iter(iterator: Iterable, prepare: Optional[Callable] = None,
                  n: int = 2) -> Iterator:
    """Yield ``prepare(item)`` for each item, computed up to n ahead on a
    background thread.  Safe to abandon mid-iteration: the producer stops
    on a flag instead of blocking on a full queue.  An exception in the
    producer re-raises at the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, n))
    stop = threading.Event()
    err = []

    def produce():
        try:
            for item in iterator:
                item = prepare(item) if prepare is not None else item
                if not _put_until_stopped(q, item, stop):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err.append(e)
        finally:
            _put_until_stopped(q, _SENTINEL, stop)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        if err:
            raise err[0]
        t.join()
    finally:
        stop.set()
