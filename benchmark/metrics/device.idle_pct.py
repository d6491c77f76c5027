"""device.idle_pct: in the bulk cells, the share of a request's untraced
latency in which no operation runs on the device (its device busy time
from the trace)."""
from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run)
