"""vunet.wall_ms_per_frame: the device milliseconds of a request's
``vunet`` stage (its padding, chunk loop and concatenation), from entry to
exit as the program's own spans time them with CUDA events and no
profiler running, over the request's frames: the VUNet's busy time a
frame plus the chunk loop's idle.  The median over the untraced requests
of a ``--trace 1`` run."""
from benchmark.stages import median_over_requests


def read(run):
    return median_over_requests(
        run, "vunet.wall_ms_per_frame",
        lambda by_name, request: ((by_name["vunet"]["device_end_ms"]
                                   - by_name["vunet"]["device_start_ms"])
                                  / request["counts"]["frames"]))
