"""Stage spans of the serving program: where a request's time goes.

``with trace.span(name, **counts):`` marks one stage of a request;
``pipeline.py`` opens them in ``generate``, ``calibrate`` and ``reenact``,
where the stages are composed.  The outermost open span is the request
(``request``); every span opened inside it belongs to that request.  A span
goes to two sinks:

- the profiler: while ``torch.profiler`` records, the span also opens the
  host range ``bdvs.<name>``, so a trace shows the program's stages on the
  profiler's clock beside the host operations that launch their device
  work.  Nothing is opened when no profiler records.
- the recorder, always on: one record a span in a ring of the last
  :data:`RING` requests.  A record holds the span's name and parent, its
  request, the host clock (``time.perf_counter_ns``) at entry and exit, its
  counts, whether a profiler was recording, and, on CUDA, a pair of timing
  events recorded on the current stream at entry and exit (from a pool
  that the ring's evicted requests give back to).  Nothing in a span
  waits for the device; while the current stream is being captured into a
  CUDA graph, a span keeps the host clock only.

:func:`records` reads the recorder: one plain dict a span, with the device
milliseconds of its entry and exit measured from its request's first event
(None off CUDA).  It is the per-request stage timing a server logs.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List

import torch
from torch._C._profiler import _RecordFunctionFast

PREFIX = "bdvs."
RING = 64


class _Span:
    __slots__ = ("name", "parent", "request", "entry_ns", "exit_ns",
                 "counts", "profiled", "events", "device_ms")

    def __init__(self, name, parent, request, counts, profiled):
        self.name, self.parent, self.request = name, parent, request
        self.counts, self.profiled = counts, profiled
        self.entry_ns = self.exit_ns = None
        self.events = None          # (entry, exit) CUDA events
        self.device_ms = None       # (entry, exit) from the request's entry


class _Request:
    __slots__ = ("id", "spans", "device")

    def __init__(self, id, device):
        self.id, self.device = id, device
        self.spans: List[_Span] = []


class Recorder:
    """The ring of the last ``ring`` requests' spans and the pool of CUDA
    events they use."""

    def __init__(self, ring: int = RING):
        self.ring = ring
        self._requests: collections.deque = collections.deque()
        self._pool: Dict[int, List[torch.cuda.Event]] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()

    def _event(self, index: int) -> torch.cuda.Event:
        try:
            return self._pool.setdefault(index, []).pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def _give_back(self, request: _Request) -> None:
        for s in request.spans:
            if s.events is not None:
                self._pool[request.device.index].extend(s.events)
                s.events = None

    def span(self, name: str, device=None, **counts):
        """A context manager marking stage ``name``; ``device`` (the
        request's, given by its outermost span) decides where its events
        are recorded; ``counts`` are kept with the record."""
        return _Open(self, name, device, counts)

    def _enter(self, name, device, counts):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        if stack:
            request, parent = stack[-1][0], stack[-1][1].name
        else:
            device = torch.device(device) if device is not None else None
            if device is not None and device.type == "cuda" \
                    and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            request, parent = _Request(next(self._ids), device), None
        profiled = torch.autograd._profiler_enabled()
        s = _Span(name, parent, request.id, counts, profiled)
        request.spans.append(s)
        rf = None
        if profiled:
            # a host range only: torch.profiler.record_function would also
            # lay an annotation over the device's timeline, which readers
            # of the trace's device events would take for an operation
            rf = _RecordFunctionFast(PREFIX + name)
            rf.__enter__()
        dev, stream = request.device, None
        if dev is not None and dev.type == "cuda" \
                and not torch.cuda.is_current_stream_capturing():
            # a span opens and closes on one stream: streams change only
            # in blocks that nest within it
            stream = torch.cuda.current_stream(dev)
            s.events = (self._event(dev.index), self._event(dev.index))
            s.events[0].record(stream)
        stack.append((request, s, rf, stream))
        s.entry_ns = time.perf_counter_ns()

    def _exit(self):
        stack = self._local.stack
        request, s, rf, stream = stack.pop()
        s.exit_ns = time.perf_counter_ns()
        if stream is not None:
            s.events[1].record(stream)
        if rf is not None:
            rf.__exit__(None, None, None)
        if stack:
            return
        with self._lock:
            self._requests.append(request)
            while len(self._requests) > self.ring:
                self._give_back(self._requests.popleft())

    def records(self) -> List[dict]:
        """Every span of the requests in the ring, oldest request first and
        each request's spans in the order they opened, as plain dicts:
        ``name``, ``parent`` (its name; None for the request), ``request``,
        ``entry_ns``, ``exit_ns``, ``counts``, ``profiled``, and
        ``device_start_ms`` / ``device_end_ms`` from the request's entry
        event (None off CUDA or while captured).  Waits for the events of
        the requests it reads."""
        out = []
        with self._lock:
            requests = list(self._requests)
            for request in requests:
                self._read(request)
        for request in requests:
            for s in request.spans:
                ms = s.device_ms or (None, None)
                out.append(dict(name=s.name, parent=s.parent,
                                request=s.request, entry_ns=s.entry_ns,
                                exit_ns=s.exit_ns, counts=dict(s.counts),
                                profiled=s.profiled, device_start_ms=ms[0],
                                device_end_ms=ms[1]))
        return out

    def _read(self, request: _Request) -> None:
        """Device ms of each span from the request's entry event; the events
        go back to the pool once read."""
        first = request.spans[0].events
        if first is None:
            return
        first[1].synchronize()      # the request's exit: recorded last
        for s in request.spans:
            if s.events is not None:
                s.device_ms = (first[0].elapsed_time(s.events[0]),
                               first[0].elapsed_time(s.events[1]))
        self._give_back(request)


class _Open:
    __slots__ = ("recorder", "name", "device", "counts")

    def __init__(self, recorder, name, device, counts):
        self.recorder, self.name = recorder, name
        self.device, self.counts = device, counts

    def __enter__(self):
        self.recorder._enter(self.name, self.device, self.counts)
        return self

    def __exit__(self, *exc):
        self.recorder._exit()
        return False


RECORDER = Recorder()


def span(name: str, device=None, **counts):
    """``with span(name, **counts):`` marks a stage in the process's
    recorder (see the module's docstring)."""
    return RECORDER.span(name, device, **counts)


def records() -> List[dict]:
    """The process's recorder's spans (:meth:`Recorder.records`)."""
    return RECORDER.records()
