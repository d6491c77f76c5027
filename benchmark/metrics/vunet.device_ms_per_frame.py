"""vunet.device_ms_per_frame: the device time of the operations launched
within the VUNet's ``encode_means`` and ``transfer_cached``, per frame
served in the traced window."""
from benchmark.readers import span_device_ms


def read(run):
    return span_device_ms(
        run, ("vunet.encode_means", "vunet.transfer_cached"), "frame")
