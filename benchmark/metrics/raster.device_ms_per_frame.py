"""raster.device_ms_per_frame: the device time of the operations launched
within the stickman projection and ``render_stickman``, per frame served
in the traced window."""
from benchmark.readers import span_device_ms


def read(run):
    return span_device_ms(run, ("geometry.project", "geometry.raster"),
                          "frame")
