"""What the per-layer metric readers (``metrics/<name>.py``) share: each
takes a run's trace and returns a number, or None where the trace holds
nothing to read (no device operations, no requests, no such span).

The profiler's host cost stretches a traced request (by about a tenth in
bulk, and more than half for one video), so shares of a request's time
are taken against the untraced latency of the same requests, served in
the same run just before the traced ones."""
from . import yardstick


def mfu_pct(run):
    """A request's model FLOPs (``yardstick.request_flops``) over its
    untraced latency, as a share of the card's bf16 dense tensor peak."""
    t = run.trace
    if t is None or t.busy_s <= 0 or t.requests == 0 or t.untraced_s <= 0:
        return None
    rate = t.flops_per_request / t.untraced_s
    return 100.0 * rate / yardstick.BF16_TENSOR_FLOPS


def span_device_ms(run, spans, per: str):
    """Device milliseconds of the operations launched within ``spans``,
    per frame or per request of the traced window."""
    t = run.trace
    if t is None or t.requests == 0:
        return None
    s = sum(t.span_device_s.get(name, 0.0) for name in spans)
    if s <= 0:
        return None
    return s * 1e3 / (t.frames if per == "frame" else t.requests)


def idle_pct(run):
    """The share of a request's untraced latency in which no operation
    runs on the device: one less the device's busy time a traced request
    (the union of its operations' intervals) over that latency."""
    t = run.trace
    if t is None or t.busy_s <= 0 or t.requests == 0 or t.untraced_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.requests / t.untraced_s)
