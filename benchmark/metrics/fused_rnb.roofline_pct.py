"""fused_rnb.roofline_pct: the least time of the fused RNB launches of the
traced requests (``yardstick.fused_rnb_bound_ms`` at each launch's site)
over those launches' device time.  The launches seen on the device must
equal the program's ``fused_rnb_launches`` counter; where they are not
the launches of the sites the configuration implies, the bound cannot be
matched to them and nothing is reported."""
import sys

from benchmark import yardstick


def read(run):
    t = run.trace
    if t is None:
        return None
    n, secs = t.op_total("fused_rnb_kernel")
    if n == 0:
        return None
    if n != t.counters["fused_rnb_launches"]:
        raise RuntimeError(f"{n} fused RNB kernels on the device, "
                           f"{t.counters['fused_rnb_launches']} counted")
    sites = yardstick.fused_rnb_sites(t.cfg, t.traffic)
    if n != len(sites) * t.requests:
        print(f"fused_rnb.roofline_pct: {n} launches, not the "
              f"{len(sites)} sites of {t.requests} requests",
              file=sys.stderr)
        return None
    bound_ms = t.requests * sum(yardstick.fused_rnb_bound_ms(*s)[0]
                                for s in sites)
    return 100.0 * bound_ms / (secs * 1e3)
