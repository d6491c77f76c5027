"""rollout.roofline_pct: the least time of one rollout at the request's
(videos, keypoints, hidden width, frames) (``yardstick.rollout_bound_ms``)
over the rollout kernel's device time a launch.  The launches seen on the
device must equal the program's ``rollout_launches`` counter."""
from benchmark import yardstick
from benchmark.reference import spec


def read(run):
    t = run.trace
    if t is None:
        return None
    n, secs = t.op_total("rollout_kernel")
    if n == 0:
        return None
    if n != t.counters["rollout_launches"]:
        raise RuntimeError(f"{n} rollout kernels on the device, "
                           f"{t.counters['rollout_launches']} counted")
    bound_ms, _ = yardstick.rollout_bound_ms(
        int(t.traffic["videos"]), spec.n_kps_used(t.cfg),
        int(t.cfg["behavior_net"]["dim_hidden_b"]), int(t.traffic["frames"]))
    return 100.0 * bound_ms / (secs * 1e3 / n)
