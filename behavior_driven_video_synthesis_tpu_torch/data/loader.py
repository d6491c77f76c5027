"""Host-side batch loading: ``collate``, ``Loader`` and ``prefetch_iter``.

Counterpart of ``behavior_driven_video_synthesis_tpu/data/loader.py``
(``collate`` :27-35, ``prefetch_iter``, ``Loader`` :91-118).  ``Loader``
maps ``dataset[idx]`` over each batch of a batch sampler on a thread pool
and collates the items into stacked numpy arrays, keeping ``prefetch``
batches in flight.  ``prefetch_iter``'s ``prepare`` usually copies a batch
to the device (from pinned memory, without blocking), so the copy of the
next batch overlaps the device's work on the current one.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np

_SENTINEL = object()


def collate(items) -> Dict[str, np.ndarray]:
    """A list of item dicts -> one dict of stacked arrays."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        first = np.asarray(vals[0])
        out[key] = np.stack([np.asarray(v) for v in vals]) \
            if first.ndim > 0 else np.asarray(vals)
    return out


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


class Loader:
    """Batches of ``dataset`` in the order of ``batch_sampler`` (lists of
    indices, or of [idx, seq_len] pairs), fetched by ``num_workers``
    threads."""

    def __init__(self, dataset, batch_sampler: Iterable,
                 num_workers: int = 8, prefetch: int = 2):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers == 1:
            for batch_ids in self.batch_sampler:
                yield collate([self.dataset[i] for i in batch_ids])
            return

        def batches():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for batch_ids in self.batch_sampler:
                    yield collate(list(pool.map(self.dataset.__getitem__,
                                                batch_ids)))

        # prefetch_iter's stop flag makes abandoning an epoch safe
        yield from prefetch_iter(batches(), n=self.prefetch)
