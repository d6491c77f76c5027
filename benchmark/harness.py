"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the reference, and the result line.

Everything a cell names is found by name under ``benchmark/``: its
configuration (the ``file`` that ``BENCHMARK.json`` gives), its traffic
mix (``traffic/<mix>.json``), the limits of its comparison
(``limits/<cell>.json``) and a reader per metric (``metrics/<metric>.py``,
whose ``read(run)`` returns a number or None).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "behavior_driven_video_synthesis_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    return Cell(
        name=workload, config=load_json(root / configs[w["config"]]["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        end_to_end=[m for m in manifest["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[m for m in manifest["per_layer"]
                   if _applies(m, workload)],
        limits={k: float(v["limit"]) for k, v in limits.items()})


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclass
class Window:
    """The measured window: every request's latency and the frames
    served."""
    latencies_s: List[float]
    frames: int
    window_s: float


@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    setup_s: float
    window: Optional[Window] = None
    trace: Optional[object] = None


class Reservoir:
    """A uniform sample of k of the requests served, drawn from the seed
    as they complete (Algorithm R), each kept with its outputs."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, random.Random(seed), 0
        self.kept: List[tuple] = []

    def offer(self, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


def run_config(cfg: dict) -> dict:
    """The synthesis net's keys as a run configuration of the program's
    CLIs holds them."""
    s = cfg["synthesis_net"]
    return {"architecture": {k: s[k] for k in (
                "n_latent_scales", "conv_layer_type", "nf_start", "nf_max",
                "subpixel_upsampling", "n_scales")},
            "data": {k: s[k] for k in ("spatial_size", "inplane_normalize",
                                       "box_factor", "bottleneck_factor")}}


def program(cfg: dict, params, device, marks=None):
    """The serving program as its CLI builds it, with the benchmark's
    weights loaded by name: (pipeline, the pipeline module).  Appends to
    ``marks`` the end of its phases: the networks built without storage,
    then the weights loaded into them."""
    marks = [] if marks is None else marks
    import numpy as np
    import torch
    from behavior_driven_video_synthesis_tpu_torch import pipeline
    from behavior_driven_video_synthesis_tpu_torch.core.precision import (
        disable_tf32)
    from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
        detailed_joint_model)
    from behavior_driven_video_synthesis_tpu_torch.models.behavior import (
        ResidualBehaviorNet)
    from behavior_driven_video_synthesis_tpu_torch.models.flows.transformer \
        import LatentFlow
    from behavior_driven_video_synthesis_tpu_torch.models.vunet import (
        vunet_from_config)

    from .reference import spec as S
    from .weights import subset

    disable_tf32()
    b, s, serve = cfg["behavior_net"], cfg["synthesis_net"], cfg["serving"]
    hid = int(b["dim_hidden_b"])
    behavior = ResidualBehaviorNet(
        n_kps=S.n_kps_used(cfg), dim_hidden_b=hid,
        decoder_arch=b["decoder_arch"], use_nin_dec=b["linear_in_decoder"],
        information_bottleneck=True, device="meta")
    flow = LatentFlow(hid, hid * int(b["flow_mid_channels_factor"]),
                      flow_hidden_depth=int(b["flow_hidden_depth"]),
                      n_flows=int(b["n_flows"]), device="meta")
    vunet = vunet_from_config(run_config(cfg), S.variant(cfg),
                              dtype=getattr(torch, serve["vunet_dtype"]),
                              remat=False, rnb_impl=serve["rnb_impl"],
                              device="meta")
    marks.append(("build", time.perf_counter()))
    for module, part in ((behavior, S.behavior_spec(cfg)),
                         (flow, S.flow_spec(cfg)),
                         (vunet, S.vunet_spec(cfg))):
        module.load_state_dict(subset(params, part), strict=True,
                               assign=True)
        module.eval()
    marks.append(("load_weights", time.perf_counter()))
    a = cfg["assumed"]
    joints = detailed_joint_model(world_coords=True)
    pipe = pipeline.BehaviorTransferPipeline(
        behavior, vunet, joints, np.asarray(a["norm_mean"], np.float32),
        np.asarray(a["norm_std"], np.float32),
        np.asarray(a["dim_to_use"], np.int64),
        spatial_size=int(s["spatial_size"]),
        stickman_thickness=float(serve["stickman_thickness"]),
        flow_model=flow, vunet_chunk=int(serve["vunet_chunk"]))
    return pipe, pipeline


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _split(t_start: float, marks) -> str:
    """``name seconds`` of each phase of set-up, from the marks (name,
    time it ended) in order."""
    parts, t = [], t_start
    for name, end in marks:
        parts.append(f"{name} {end - t:.3f}")
        t = end
    return ", ".join(parts)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=None, marks=None) -> dict:
    """One run; returns the result line as a dict.  ``marks`` are the
    (name, end time) of the phases of set-up before the call."""
    import torch

    log = log or sys.stderr
    marks = list(marks or [])
    from . import check, tracing, yardstick
    from .traffic import make_pool
    from .weights import make_params

    cfg, traffic = cell.config, cell.traffic
    if torch.device(device).type == "cuda":
        torch.empty(1, device=device)       # the CUDA context
        _sync(device)
        marks.append(("cuda_start", time.perf_counter()))
    params = make_params(cfg, seed, device)
    _sync(device)
    marks.append(("params", time.perf_counter()))
    pool = make_pool(cfg, traffic, seed, device)
    _sync(device)
    marks.append(("pool", time.perf_counter()))
    import behavior_driven_video_synthesis_tpu_torch.pipeline  # noqa: F401
    marks.append(("port_imports", time.perf_counter()))
    pipe, pipeline_module = program(cfg, params, device, marks)
    marks.append(("pipeline", time.perf_counter()))
    T = int(traffic["frames"])
    per_request = int(traffic["videos"]) * T

    def serve(r):
        return pipe.generate(r["z"], r["x_start"], r["app"],
                             r["extrinsics"], r["intrinsics"],
                             r["image_size"], length=T, use_flow=True,
                             eps=r["eps"])

    serve(pool[0])                      # the cell's one shape, warmed
    _sync(device)
    marks.append(("warm_up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print(f"setup {setup_s:.3f} s: {_split(t_start, marks)}", file=log)
    sample = Reservoir(int(traffic["checked"]), seed)
    latencies: List[float] = []
    attempted = failed = 0
    prof = counters = None

    def one(i):
        nonlocal attempted, failed
        attempted += 1
        t0 = time.perf_counter()
        try:
            out = serve(pool[i % len(pool)])
            _sync(device)
        except RuntimeError as e:
            failed += 1
            print(f"request {i} failed: {e}", file=log)
            return None
        latencies.append(time.perf_counter() - t0)
        sample.offer((i % len(pool), out))
        return True

    if not trace:
        t0 = time.perf_counter()
        deadline, i = t0 + seconds, 0
        while one(i) and time.perf_counter() < deadline:
            i += 1
        window = Window(latencies, len(latencies) * per_request,
                        time.perf_counter() - t0)
        half = len(latencies) // 2
        ms = [sorted(v)[len(v) // 2] * 1e3 for v in (latencies[:half] or
                                                   latencies,
                                                   latencies[half:])]
        print(f"window: {len(latencies)} requests in {window.window_s:.3f} "
              f"s; median latency {ms[0]:.3f} ms in the first half, "
              f"{ms[1]:.3f} ms in the second; longest "
              f"{max(latencies) * 1e3:.3f} ms", file=log)
    else:
        # the same requests untraced first: the profiler's host cost
        # stretches a traced request, so the shares of a request's time
        # are taken against its untraced latency
        n_traced = int(traffic["traced"])
        t0 = time.perf_counter()
        for i in range(n_traced):
            serve(pool[i % len(pool)])
            _sync(device)
        untraced_s = (time.perf_counter() - t0) / n_traced
        from torch.profiler import ProfilerActivity, profile, record_function

        from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (
            fused_rnb, rollout)
        before = (rollout.rollout_launches, fused_rnb.fused_rnb_launches)
        activities = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with tracing.spans(pipe, pipeline_module), \
                profile(activities=activities) as prof:
            with record_function(tracing.WINDOW):
                for i in range(n_traced):
                    with record_function(tracing.REQUEST):
                        if not one(i):
                            break
        counters = {
            "rollout_launches": rollout.rollout_launches - before[0],
            "fused_rnb_launches": fused_rnb.fused_rnb_launches - before[1]}
        window = None

    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    flops = yardstick.request_flops(cfg, traffic)
    result_run = Run(cell=cell, setup_s=setup_s, window=window)
    if prof is not None:
        result_run.trace = tracing.summarize(
            prof, cfg, traffic, len(latencies), counters,
            sum(flops.values()), untraced_s)
        del prof
    del pipe, pipeline_module, serve
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    readings = [check.judge(params, cfg, traffic, pool[idx], out)
                for idx, out in sample.kept]
    values = (check.worst(readings) if readings
              else {k: float("inf") for k in check.NUMBERS})
    correct = failed == 0 and check.verdict(values, cell.limits)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"])(result_run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        t = result_run.trace
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = tracing.breakdown(t)
        n_ops = sum(n for n, _ in t.ops.values())
        n = max(t.requests, 1)
        print(f"traced {t.requests} requests, {n_ops} device operations, "
              f"{t.unattributed} without a launch record; counters "
              f"{t.counters}; a request {t.window_s / n * 1e3:.3f} ms "
              f"traced, {t.untraced_s * 1e3:.3f} ms untraced, "
              f"{t.busy_s / n * 1e3:.3f} ms busy on the device", file=log)
    result["checks"] = {k: {"value": values[k], "limit": cell.limits[k]}
                        for k in check.NUMBERS}
    if readings:
        print(f"reference frame values outside [-1, 1]: a share of at most "
              f"{max(r[check.CLIPPED] for r in readings)!r}", file=log)
    for k in check.NUMBERS:
        print(f"check {k}: {values[k]!r} (limit {cell.limits[k]!r}, "
              f"{len(readings)} requests)", file=log)
    return result
