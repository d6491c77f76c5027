"""What the serving program's stage spans (``core/trace.py``) cost, and
where a request's device time goes by stage, on the card.

    python3 examples/torch_trace_probe.py [--pairs 15] [--single_pairs 150] \
        [--out build/trace_probe.json]

Builds each bulk cell's program from ``BENCHMARK.json`` (alter256 and
org256_fused, B=20, T=50) and a one-video request (alter256, B=1, T=50)
with the benchmark's seeded weights and requests, then, per case:

- serves requests in pairs, the spans on and the spans off (``trace.span``
  swapped for a no-op) in alternating order, each timed on the host clock
  to its synchronize: the recorder's cost, with no profiler running;
- serves a few requests under ``torch.profiler``, the program's ``bdvs.``
  ranges on and off (the range swapped for a no-op inside the
  recorder) in turn: the ranges' host cost under the profiler, and the
  device events the profiler reports per request either way;
- prints each stage's device milliseconds from the recorder's events for
  the untraced requests (the median of each stage's entry-to-exit time);

and last times the spans alone (``span_cost_us``).

The card's name and power limit go with the numbers.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAGES = ("flow", "rollout", "pose", "stickman", "appearance", "vunet")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip()
    except OSError:
        return "nvidia-smi not found"


def quartiles(v):
    q = statistics.quantiles(v, n=4)
    return {"median": statistics.median(v), "q1": q[0], "q3": q[2],
            "min": min(v), "max": max(v), "n": len(v)}


class _Off:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def span_cost_us(trace, dev, real_rf, requests=400, per_request=15):
    """Host microseconds a span costs on the card with no device work:
    requests of ``per_request`` spans (a bulk request's count), each way
    in turn: the recorder as served, spans that do nothing, and under the
    profiler with and without the ``bdvs.`` ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run(span):
        t0 = time.perf_counter()
        for _ in range(requests):
            with span("request", dev, frames=1):
                for _ in range(per_request - 1):
                    with span("vunet.chunk", frames=1):
                        pass
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / (requests * per_request) * 1e6

    out = {"recorder": [], "no_op": [], "profiled_ranges": [],
           "profiled_no_ranges": []}
    for _ in range(3):
        out["recorder"].append(run(trace.span))
        out["no_op"].append(run(lambda *a, **k: _Off()))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            out["profiled_ranges"].append(run(trace.span))
            trace._RecordFunctionFast = lambda name: _Off()
            try:
                out["profiled_no_ranges"].append(run(trace.span))
            finally:
                trace._RecordFunctionFast = real_rf
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=15)
    ap.add_argument("--single_pairs", type=int, default=150)
    ap.add_argument("--profiled", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2**31 + 101)
    ap.add_argument("--out", default="build/trace_probe.json")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from behavior_driven_video_synthesis_tpu_torch import pipeline
    from behavior_driven_video_synthesis_tpu_torch.core import trace
    from benchmark import harness
    from benchmark.traffic import make_pool
    from benchmark.weights import make_params

    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    result = {"card": card(), "torch": torch.__version__, "cases": {}}
    print(result["card"], flush=True)
    cases = [("alter256.bulk_b20_t50", None, args.pairs),
             ("org256_fused.bulk_b20_t50", None, args.pairs),
             ("alter256.single_b1_t50", "alter256.bulk_b20_t50",
              args.single_pairs)]
    real_span = trace.span
    real_rf = trace._RecordFunctionFast

    for name, base, pairs in cases:
        cell = harness.load_cell(base or name)
        cfg, traffic = cell.config, copy.deepcopy(cell.traffic)
        if base:
            traffic.update(videos=1, pool=16)
        params = make_params(cfg, args.seed, dev)
        pool = make_pool(cfg, traffic, args.seed, dev)
        pipe, _ = harness.program(cfg, params, dev)
        T = int(traffic["frames"])

        def serve(i):
            r = pool[i % len(pool)]
            pipe.generate(r["z"], r["x_start"], r["app"], r["extrinsics"],
                          r["intrinsics"], r["image_size"], length=T,
                          use_flow=True, eps=r["eps"])
            torch.cuda.synchronize(dev)

        def timed(i, on):
            pipeline.trace.span = (real_span if on
                                   else lambda *a, **k: _Off())
            try:
                t0 = time.perf_counter()
                serve(i)
                return time.perf_counter() - t0
            finally:
                pipeline.trace.span = real_span

        for i in range(3):
            serve(i)                    # warm-up
        first = trace.records()[-1]["request"] + 1
        on, off = [], []
        for i in range(pairs):
            order = (True, False) if i % 2 == 0 else (False, True)
            for o in order:
                (on if o else off).append(timed(i, o) * 1e3)
        recs = [r for r in trace.records() if r["request"] >= first
                and not r["profiled"]]
        stage_ms = {}
        for s in STAGES + ("request", "vunet.chunk"):
            walls = {}
            for r in recs:
                if r["name"] == s:
                    walls[r["request"]] = walls.get(r["request"], 0.0) + (
                        r["device_end_ms"] - r["device_start_ms"])
            if walls:
                stage_ms[s] = quartiles(list(walls.values()))
        front = [r["device_end_ms"] for r in recs
                 if r["name"] == "appearance"]
        diffs = [a - b for a, b in zip(on, off)]
        case = {"videos": int(traffic["videos"]), "frames": T,
                "latency_ms_spans_on": quartiles(on),
                "latency_ms_spans_off": quartiles(off),
                "on_minus_off_ms": quartiles(diffs),
                "stage_device_ms": stage_ms,
                "front_wall_ms": quartiles(front)}

        # under the profiler: the bdvs. ranges on and off in turn
        prof_ms = {True: [], False: []}
        device_events = {True: [], False: []}
        n_prof = args.profiled if not base else 10 * args.profiled
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            serve(0)                    # the profiler's own start-up
        for i in range(n_prof * 2):
            ranges = i % 2 == 0
            if not ranges:
                trace._RecordFunctionFast = lambda name: _Off()
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    serve(i)
                    prof_ms[ranges].append((time.perf_counter() - t0) * 1e3)
            finally:
                trace._RecordFunctionFast = real_rf
            evs = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type().name != "CPU"]
            device_events[ranges].append(
                (len(evs), sum(e.name().startswith(trace.PREFIX)
                               for e in evs)))
        case["profiled_ms_ranges_on"] = quartiles(prof_ms[True])
        case["profiled_ms_ranges_off"] = quartiles(prof_ms[False])
        case["device_events_ranges_on"] = device_events[True]
        case["device_events_ranges_off"] = device_events[False]
        result["cases"][name] = case
        print(name, json.dumps(case), flush=True)
        del pipe, params, pool
        torch.cuda.empty_cache()

    result["span_us"] = span_cost_us(trace, dev, real_rf)
    print("span_us", json.dumps(result["span_us"]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
