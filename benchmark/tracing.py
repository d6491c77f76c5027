"""The traced run's spans and their reduction to per-layer numbers.

The program carries no spans of its own yet, so the benchmark opens
``torch.profiler.record_function`` ranges around the program's public
calls from outside: on the pipeline instance (the flow inverse, the
stickman projection, the VUNet's ``encode_means`` and
``transfer_cached``) and on the names ``pipeline.py`` calls
(``render_stickman``, ``decoder_rollout_kernel``).  :func:`summarize`
reads the profiler's raw events: each device operation is charged to the
ranges in which the host launched it (by the CUDA runtime call of the
same correlation id), the device's busy time is the union of its
operations within the traced window, and the longest idle gaps are named
by what the host was doing in them.
"""
from __future__ import annotations

import bisect
import contextlib
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

PREFIX = "bench."
WINDOW = PREFIX + "window"
REQUEST = PREFIX + "request"
# span -> (where, attribute): "instance" paths are attributes of the
# pipeline object, "module" names are globals of the pipeline module
SPANS = {
    "flow.reverse": ("instance", "flow_model.reverse"),
    "rollout": ("module", "decoder_rollout_kernel"),
    "geometry.project": ("instance", "_project"),
    "geometry.raster": ("module", "render_stickman"),
    "vunet.encode_means": ("instance", "vunet.encode_means"),
    "vunet.transfer_cached": ("instance", "vunet.transfer_cached"),
}
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def _wrapped(fn, name):
    from torch.profiler import record_function

    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def spans(pipe, pipeline_module):
    """Within the block, every span of :data:`SPANS` is open around its
    call; the pipeline and its module are as they were afterwards."""
    undo = []
    for span, (where, path) in SPANS.items():
        if where == "instance":
            *owners, attr = path.split(".")
            obj = pipe
            for o in owners:
                obj = getattr(obj, o)
            if obj is None:
                continue
            setattr(obj, attr, _wrapped(getattr(obj, attr), PREFIX + span))
            undo.append(lambda obj=obj, attr=attr: delattr(obj, attr))
        else:
            orig = getattr(pipeline_module, path)
            setattr(pipeline_module, path, _wrapped(orig, PREFIX + span))
            undo.append(lambda path=path, orig=orig:
                        setattr(pipeline_module, path, orig))
    try:
        yield
    finally:
        for u in reversed(undo):
            u()


@dataclass
class Trace:
    """What one traced window holds, for the per-layer readers."""
    cfg: dict
    traffic: dict
    requests: int
    frames: int
    window_s: float
    busy_s: float
    # span -> device seconds of the operations launched within it
    span_device_s: Dict[str, float]
    # device operation name -> (count, seconds)
    ops: Dict[str, Tuple[int, float]]
    counters: Dict[str, int]
    flops_per_request: int
    # wall seconds a request of the same traffic takes untraced
    untraced_s: float
    unattributed: int = 0
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def op_total(self, part: str) -> Tuple[int, float]:
        """(launches, device seconds) of the operations named ``*part*``."""
        n = s = 0
        for name, (count, secs) in self.ops.items():
            if part in name:
                n += count
                s += secs
        return n, s


def _intervals_containing(intervals, t):
    """Whether t lies in one of the sorted, disjoint (start, end) pairs."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def summarize(prof, cfg, traffic, requests, counters, flops,
              untraced_s: float) -> Trace:
    events = prof.profiler.kineto_results.events()
    spans_at: Dict[str, List[Tuple[int, int]]] = {}
    launches: Dict[int, int] = {}
    device: List[Tuple[str, int, int, int]] = []
    host: List[Tuple[int, int, str]] = []
    for e in events:
        name = e.name()
        start, end = e.start_ns(), e.end_ns()
        if e.device_type().name == "CPU":
            if name.startswith(PREFIX):
                spans_at.setdefault(name[len(PREFIX):], []).append(
                    (start, end))
            elif _RUNTIME.match(name):
                launches[e.correlation_id()] = start
            else:
                host.append((start, end, name))
        elif not name.startswith(PREFIX):
            device.append((name, start, end, e.correlation_id()))
    for v in spans_at.values():
        v.sort()
    (w0, w1), = spans_at.pop("window")
    in_window = [d for d in device if d[2] > w0 and d[1] < w1]

    ops: Dict[str, Tuple[int, float]] = {}
    span_s = {name: 0.0 for name in spans_at}
    unattributed = 0
    for name, start, end, corr in in_window:
        secs = (end - start) * 1e-9
        count, total = ops.get(name, (0, 0.0))
        ops[name] = (count + 1, total + secs)
        t = launches.get(corr)
        if t is None:
            unattributed += 1
            continue
        for span, at in spans_at.items():
            if _intervals_containing(at, t):
                span_s[span] += secs

    merged: List[List[int]] = []
    for _, start, end, _ in sorted(in_window, key=lambda d: d[1]):
        start, end = max(start, w0), min(end, w1)
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy = sum(e - s for s, e in merged) * 1e-9
    edges = [w0] + [t for iv in merged for t in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return Trace(cfg=cfg, traffic=traffic, requests=requests,
                 frames=requests * int(traffic["videos"])
                 * int(traffic["frames"]),
                 window_s=(w1 - w0) * 1e-9, busy_s=busy,
                 span_device_s=span_s, ops=ops, counters=counters,
                 flops_per_request=flops, untraced_s=untraced_s,
                 unattributed=unattributed,
                 gaps=[(_host_at(host, spans_at, (a + b) // 2),
                        (b - a) * 1e-9) for a, b in gaps[:10]])


def _host_at(host, spans_at, t) -> str:
    """The benchmark span and the innermost host operation at time t."""
    span = next((s for s, at in spans_at.items()
                 if s != "request" and _intervals_containing(at, t)),
                "request" if _intervals_containing(
                    spans_at.get("request", []), t) else "between requests")
    inner: Optional[Tuple[int, int, str]] = None
    for start, end, name in host:
        if start <= t <= end and (inner is None
                                  or end - start < inner[1] - inner[0]):
            inner = (start, end, name)
    return f"{span}: {inner[2] if inner else 'no host operation'}"


def breakdown(trace: Trace) -> dict:
    top = sorted(trace.ops.items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[name[:200], secs] for name, (_, secs) in top],
            "idle_gaps": [[name[:200], secs] for name, secs in trace.gaps]}
