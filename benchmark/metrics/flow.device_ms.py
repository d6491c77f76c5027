"""flow.device_ms: the device time of the operations launched within the
flow inverse, per request of the traced window."""
from benchmark.readers import span_device_ms


def read(run):
    return span_device_ms(run, ("flow.reverse",), "request")
