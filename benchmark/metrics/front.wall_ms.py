"""front.wall_ms: the device milliseconds from a request's entry to the end
of its ``appearance`` stage, as the program's own spans time them with
CUDA events and no profiler running: what the front stages (flow inverse,
rollout, pose, stickman raster, appearance encoder) hold the device for,
idle included.  The median over the untraced requests of a ``--trace 1``
run."""
from benchmark.stages import median_over_requests


def read(run):
    return median_over_requests(
        run, "front.wall_ms",
        lambda by_name, request: (by_name["appearance"]["device_end_ms"]
                                  - request["device_start_ms"]))
