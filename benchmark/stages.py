"""The program's own stage spans (``core/trace.py`` of the port), as the
per-layer readers ``front.wall_ms`` and ``vunet.wall_ms_per_frame`` read
them.

The port's recorder keeps every request it served in a ring, with the
device's own timestamps (CUDA events) at each stage's entry and exit.  A
reader takes the requests served with no profiler recording, leaving out
the first (the warm-up), and of those the last ``traffic["traced"]``: in
a ``--trace 1`` run, the untraced pass that comes before the profiled
window, timed as the device saw it."""
from __future__ import annotations

import statistics
import sys
from typing import Callable, List, Optional

from .yardstick import chunk_size


def untraced_requests(run, metric: str) -> Optional[List[List[dict]]]:
    """Each untraced request's spans (its ``request`` span first), or None
    where the program keeps no spans, too few requests were recorded, one
    holds no device times, or one's ``vunet.chunk`` spans are not the
    chunks its frames imply."""
    try:
        from behavior_driven_video_synthesis_tpu_torch.core import trace
    except ImportError:
        return None
    cfg, traffic = run.cell.config, run.cell.traffic
    n = int(traffic["traced"])
    requests = {}
    for r in trace.records():
        requests.setdefault(r["request"], []).append(r)
    untraced = [spans for spans in requests.values()
                if not spans[0]["profiled"]][1:][-n:]
    if len(untraced) < n or any(spans[0]["device_end_ms"] is None
                                for spans in untraced):
        return None
    cs, padded = chunk_size(int(traffic["videos"]) * int(traffic["frames"]),
                            int(cfg["serving"]["vunet_chunk"]))
    for spans in untraced:
        chunks = sum(s["name"] == "vunet.chunk" for s in spans)
        if chunks != padded // cs:
            print(f"{metric}: {chunks} vunet.chunk spans in a request, not "
                  f"the {padded // cs} of {padded} frames in chunks of {cs}",
                  file=sys.stderr)
            return None
    return untraced


def median_over_requests(run, metric: str,
                         value: Callable[[dict, dict], float]):
    """The median over the untraced requests of ``value(spans by name,
    request span)``, or None (:func:`untraced_requests`)."""
    untraced = untraced_requests(run, metric)
    if untraced is None:
        return None
    return statistics.median(
        value({s["name"]: s for s in spans}, spans[0]) for spans in untraced)
