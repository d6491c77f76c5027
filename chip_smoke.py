#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout, on a machine with one CUDA device, the
CUDA toolkit (nvcc) and PyTorch.  It imports no JAX.  Phases:

1. the card: its name and power limit;
2. the build of every CUDA kernel of the serving path from ``csrc/``, with
   nvcc's register, shared-memory and spill report;
3. each kernel against its plain PyTorch version at the serving path's
   shapes, both timed with CUDA events;
4. the full-width serving slice at ``bench.py``'s shapes (B=20, T=50,
   256 px, HID 1024, 48 of 51 keypoints, a 15-flow LatentFlow of mid width
   2048 in f32, VUNet-alter nf 32->128 in bf16) on seeded random weights
   made on the device: generate (sample mode, with the flow), reenact, and
   generate at B=3; every request must launch the rollout kernel once;
5. the serving CLI in-process at a small width, from .npz parameter files
   and a request file written here from a numpy seed;
6. the port at small width against ``tests/golden/torch_port_slice_small.npz``
   (outputs of the JAX package), in f32 with TF32 off.

The last two lines are a JSON object of kernel results and
``{"ok": true, "device": {...}}``; any failure exits non-zero before them.
All measured values also go to a JSON file, ``build/chip_smoke.json`` unless
``--out PATH`` names another.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the script's directory, the checkout's root, is first on sys.path
from behavior_driven_video_synthesis_tpu_torch import generate as cli
from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
    detailed_joint_model)
from behavior_driven_video_synthesis_tpu_torch.geometry.stickman import (
    render_stickman)
from behavior_driven_video_synthesis_tpu_torch.models import convert
from behavior_driven_video_synthesis_tpu_torch.models.behavior import (
    ResidualBehaviorNet, decoder_rollout_kernel)
from behavior_driven_video_synthesis_tpu_torch.models.flows import LatentFlow
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.vunet import VUNet
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import rollout
from behavior_driven_video_synthesis_tpu_torch.ops.cuda.build import (
    build_log, load_library)
from behavior_driven_video_synthesis_tpu_torch.pipeline import (
    BehaviorTransferPipeline)

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda")
# the serving slice of bench.py:202-236
SLICE = dict(B=20, T=50, S=256, HID=1024, K_FULL=51, K_USE=48, NF_START=32,
             NF_MAX=128, N_FLOWS=15)
ROLLOUT_SHAPES = [(20, 48, 1024, 50), (1, 48, 1024, 50), (3, 51, 1024, 7)]
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_slice_small.npz")
RESULTS = {}


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def cuda_ms(fn, iters):
    """Mean device time of fn over iters warm calls, by CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def on_device(module, g):
    """A module built on the meta device, materialized on the card and
    filled with seeded values there."""
    return init_random_(module.to_empty(device=DEV), g).eval()


# -- 1. the card --------------------------------------------------------------
def phase_card():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {name}; {torch.cuda.device_count()} device(s)")
    log(card)
    RESULTS["card"] = card
    return name


# -- 2. the build -------------------------------------------------------------
def phase_build():
    t0 = time.perf_counter()
    load_library("rollout")
    log(f"[2] csrc/rollout.cu built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    log(build_log("rollout").strip())
    cfg = rollout.rollout_config(20, 48, 1024)
    log(f"    launch at (B, K, H) = (20, 48, 1024): {cfg}")
    RESULTS["rollout_config"] = cfg


# -- 3. kernel against its plain version --------------------------------------
def rollout_args(B, K, H, seed=0):
    g = torch.Generator(device=DEV).manual_seed(seed)

    def u(*shape, scale):
        return (torch.rand(*shape, generator=g, device=DEV) * 2 - 1) * scale
    bound = H ** -0.5
    return (u(B, H, scale=1.0), u(B, K, scale=0.5), u(4 * H, K, scale=bound),
            u(4 * H, H, scale=bound), u(4 * H, scale=bound),
            u(4 * H, scale=bound), u(K, H, scale=bound), u(K, scale=bound))


def phase_kernel():
    log("[3] rollout kernel vs plain PyTorch (bf16 operands: atol 1e-2, "
        "rtol 1e-2; f32 operands: reported, the JAX kernel test allows "
        "atol 5e-2, rtol 1e-2)")
    errs = []
    for B, K, H, T in ROLLOUT_SHAPES:
        args = rollout_args(B, K, H)
        with torch.no_grad():
            out = rollout.residual_lstm_rollout(*args, T)
            torch.cuda.synchronize()
            ref16 = rollout.residual_lstm_rollout_plain(
                *args, T, operand_dtype=torch.bfloat16)
            ref32 = rollout.residual_lstm_rollout_plain(*args, T)
        check(out.shape == (B, T, K) and bool(torch.isfinite(out).all()),
              f"rollout output at {(B, K, H, T)}")
        e16 = float((out - ref16).abs().max())
        e32 = float((out - ref32).abs().max())
        ok16 = torch.allclose(out, ref16, atol=1e-2, rtol=1e-2)
        ok32 = torch.allclose(out, ref32, atol=5e-2, rtol=1e-2)
        log(f"    (B,K,H,T)={(B, K, H, T)}: max|kernel-plain_bf16| {e16:.3e}"
            f" ({'ok' if ok16 else 'FAIL'}), max|kernel-plain_f32| "
            f"{e32:.3e} (within JAX test tolerance: {ok32}), "
            f"max|out| {float(out.abs().max()):.3f}")
        RESULTS.setdefault("rollout_vs_plain", []).append(
            dict(shape=[B, K, H, T], max_abs_err_bf16=e16,
                 max_abs_err_f32=e32, within_jax_tol_f32=bool(ok32)))
        check(ok16, f"kernel disagrees with its plain version at "
              f"{(B, K, H, T)}")
        errs.append(e16)
    args = rollout_args(*ROLLOUT_SHAPES[0][:3])
    T = ROLLOUT_SHAPES[0][3]

    def kernel():
        rollout.residual_lstm_rollout(*args, T)

    def plain():
        rollout.residual_lstm_rollout_plain(*args, T,
                                            operand_dtype=torch.bfloat16)
    with torch.no_grad():
        order = [("plain", plain, 5), ("kernel", kernel, 50),
                 ("kernel", kernel, 50), ("plain", plain, 5)]
        times = [(name, cuda_ms(fn, n)) for name, fn, n in order]
        plain32 = cuda_ms(lambda: rollout.residual_lstm_rollout_plain(
            *args, T), 5)
    ms = float(np.mean([t for n, t in times if n == "kernel"]))
    plain_ms = float(np.mean([t for n, t in times if n == "plain"]))
    log(f"    time at {ROLLOUT_SHAPES[0]} (plain, kernel, kernel, plain): "
        + ", ".join(f"{n} {t:.4f} ms" for n, t in times)
        + f"; plain f32 {plain32:.4f} ms")
    RESULTS["rollout_times_ms"] = dict(order=times, plain_f32=plain32)
    return max(errs), ms, plain_ms


# -- 4. the full-width slice --------------------------------------------------
def full_width_slice():
    HID, K_FULL, K_USE, S = (SLICE[k] for k in ("HID", "K_FULL", "K_USE",
                                                 "S"))
    g = torch.Generator(device=DEV).manual_seed(0)
    behavior = on_device(ResidualBehaviorNet(
        K_USE, HID, dtype=torch.bfloat16, device="meta"), g)
    flow = on_device(LatentFlow(HID, 2 * HID, n_flows=SLICE["N_FLOWS"],
                                device="meta"), g)
    vunet = on_device(VUNet(spatial_size=S, nf_start=SLICE["NF_START"],
                            nf_max=SLICE["NF_MAX"], dtype=torch.bfloat16,
                            device="meta"), g)
    rng = np.random.RandomState(0)
    mean = rng.randn(K_FULL).astype(np.float32)
    std = (np.abs(rng.rand(K_FULL)) + 0.5).astype(np.float32)
    dim_to_use = np.arange(K_FULL)[np.arange(K_FULL) % 17 != 0][:K_USE]
    pipe = BehaviorTransferPipeline(
        behavior, vunet, detailed_joint_model(world_coords=True), mean, std,
        dim_to_use, spatial_size=S, flow_model=flow)
    counts = {n: sum(p.numel() for p in m.parameters())
              for n, m in (("behavior", behavior), ("flow", flow),
                           ("vunet", vunet))}
    return pipe, g, counts


def request_inputs(B, g):
    HID, K, S = SLICE["HID"], SLICE["K_USE"], SLICE["S"]
    extr = torch.tensor(np.hstack([np.eye(3), [[0], [0], [4.0]]]),
                        dtype=torch.float32, device=DEV).expand(B, 3, 4)
    intr = torch.tensor([1145.0, 500.0, 1143.0, 500.0],
                        device=DEV).expand(B, 4)
    return dict(
        z=torch.randn(B, HID, generator=g, device=DEV),
        x_start=torch.zeros(B, K, device=DEV),
        app_img=torch.rand(B, S, S, 3, generator=g, device=DEV) * 2 - 1,
        extrinsics=extr, intrinsics=intr,
        image_size=torch.full((B, 2), 1000.0, device=DEV))


def phase_slice():
    pipe, g, counts = full_width_slice()
    log(f"[4] full-width slice: parameters {counts}; "
        f"memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    RESULTS["slice_params"] = counts
    B, T, S = SLICE["B"], SLICE["T"], SLICE["S"]
    reqs = [("generate", B, T, "warm-up"), ("generate", B, T, "timed"),
            ("generate", B, T, "timed"), ("reenact", 4, T, ""),
            ("generate", 3, T, f"n={3 * T}"),
            ("generate", 3, 43, "n=129: zero-padded to two chunks of 128")]
    inputs = {b: request_inputs(b, g) for b in (B, 4, 3)}
    source = torch.randn(4, T, SLICE["K_USE"], generator=g,
                         device=DEV) * 0.3
    times = []
    rollout.rollout_launches = 0          # counts start here: the main path
    for kind, b, length, note in reqs:
        x = inputs[b]
        before = rollout.rollout_launches
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "generate":
            out = pipe.generate(x["z"], x["x_start"], x["app_img"],
                                x["extrinsics"], x["intrinsics"],
                                x["image_size"], length=length, generator=g)
        else:
            out = pipe.reenact(source, x["x_start"], x["app_img"],
                               x["extrinsics"], x["intrinsics"],
                               x["image_size"], length=length, generator=g)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        frames = out["frames"]
        check(frames.shape == (b, length, S, S, 3),
              f"{kind} frames shape {tuple(frames.shape)}")
        check(bool(torch.isfinite(frames.float()).all())
              and bool(torch.isfinite(out["stickman"].float()).all())
              and bool(torch.isfinite(out["poses_3d"]).all()),
              f"{kind} B={b}: non-finite output")
        check(rollout.rollout_launches == before + 1,
              f"{kind} B={b} launched the rollout kernel "
              f"{rollout.rollout_launches - before} times")
        fps = b * length / dt
        log(f"    {kind:8s} B={b:2d} T={length}: {dt * 1e3:9.2f} ms, "
            f"{fps:8.1f} frames/s, peak {peak / 2**30:.2f} GiB  {note}")
        times.append(dict(kind=kind, B=b, T=length, ms=dt * 1e3, fps=fps,
                          peak_gib=peak / 2**30, note=note))
    launches = rollout.rollout_launches
    check(launches == len(reqs), f"rollout launches {launches}")
    RESULTS["slice_requests"] = times
    stage_breakdown(pipe, inputs[B], g)
    return launches


def stage_breakdown(pipe, x, g):
    """Host-clock time of each stage of one full-batch request."""
    B, length, S = SLICE["B"], SLICE["T"], SLICE["S"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        b, t_flow = timed(lambda: pipe.flow_model.reverse(x["z"]))
        xs, t_roll = timed(lambda: decoder_rollout_kernel(
            pipe.behavior_model.decoder, b, x["x_start"], length))
        world = pipe._unnormalize(xs).reshape(B, length, -1, 3)
        px, t_proj = timed(lambda: pipe._project(
            world, x["extrinsics"], x["intrinsics"], x["image_size"]))
        stick, t_raster = timed(lambda: render_stickman(
            px, pipe.joint_model, S, pipe.thickness))
        flat = (stick / 127.5 - 1.0).to(torch.bfloat16).reshape(
            (B * length,) + stick.shape[2:])
        means, t_enc = timed(lambda: pipe.vunet.encode_means(
            x["app_img"], generator=g)[0])
        tiled = [torch.repeat_interleave(m, length, 0) for m in means]
        cs, _ = pipe._chunk_size(B * length)
        _, t_vunet = timed(lambda: [pipe.vunet.transfer_cached(
            [m[s:s + cs] for m in tiled], flat[s:s + cs])
            for s in range(0, B * length, cs)])
    stages = dict(flow_reverse=t_flow, rollout_kernel=t_roll,
                  camera=t_proj, stickman_raster=t_raster,
                  vunet_encode_means=t_enc, vunet_transfer_cached=t_vunet)
    log(f"    stages of one B={B} request (ms, host clock, synchronized): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    RESULTS["slice_stages_ms"] = stages


# -- 5. the CLI ---------------------------------------------------------------
def phase_cli():
    rng = np.random.RandomState(0)
    K, HID, S = 48, 64, 64
    net = init_random_(ResidualBehaviorNet(K, HID), rng)
    flow = init_random_(LatentFlow(HID, 2 * HID, n_flows=3), rng)
    vunet = init_random_(VUNet(spatial_size=S, nf_start=8, nf_max=16), rng)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    convert.save_flax_npz(os.path.join(tmp, "behavior.npz"), {
        "net": convert.behavior_net_to_flax(net.state_dict()),
        "flow": convert.latent_flow_to_flax(flow.state_dict())})
    convert.save_flax_npz(os.path.join(tmp, "synth.npz"), {
        "vunet": convert.vunet_alter_to_flax(vunet.state_dict())})
    with open(os.path.join(tmp, "behavior.json"), "w") as f:
        json.dump({"architecture": {"dim_hidden_b": HID, "n_flows": 3}}, f)
    with open(os.path.join(tmp, "synth.json"), "w") as f:
        json.dump({"data": {"spatial_size": S}, "architecture": {
            "nf_start": 8, "nf_max": 16}}, f)
    req = os.path.join(tmp, "request.npz")
    np.savez(req, x_start=(rng.randn(2, K) * 0.1).astype(np.float32),
             source=(rng.randn(2, 8, K) * 0.1).astype(np.float32))
    for mode in ("sample", "transfer"):
        out = os.path.join(tmp, mode)
        man = cli.main(["--behavior_params", os.path.join(tmp, "behavior.npz"),
                        "--synth_params", os.path.join(tmp, "synth.npz"),
                        "--request", req, "--mode", mode, "--length", "8",
                        "--out", out, "--device", "cuda"])
        check(os.path.exists(os.path.join(out, "manifest.json")),
              f"CLI {mode}: no manifest")
        check(len(man["videos"]) == 2 and all(
            os.path.getsize(p) > 0 for p in man["videos"].values()),
            f"CLI {mode}: videos {man['videos']}")
        log(f"[5] CLI {mode}: {len(man['videos'])} videos "
            f"({man['video_format']}) on {man['device']}")


# -- 6. against the JAX package's golden ---------------------------------------
def phase_golden():
    # the slice of tests/torch_port_slice.py
    S, HID, T, NF_START, NF_MAX, FLOW_MID, N_FLOWS = 32, 32, 6, 8, 16, 64, 2
    with np.load(GOLDEN) as data:
        g = convert.unflatten_tree({k: data[k] for k in data.files})
    # the weights are stored as float16, which holds them exactly
    params = {k: convert.unflatten_tree({
        n: v.astype(np.float32) if v.dtype == np.float16 else v
        for n, v in convert.flatten_tree(tree).items()})
        for k, tree in g["params"].items()}
    inputs = g["inputs"]
    eps = [torch.from_numpy(g["noise"][str(i)]).to(DEV)
           for i in range(len(g["noise"]))]
    behavior = ResidualBehaviorNet(inputs["x_start"].shape[1], HID,
                                   device=DEV).eval()
    behavior.load_state_dict(convert.behavior_net_from_flax(
        params["behavior"]))
    vunet = VUNet(spatial_size=S, nf_start=NF_START, nf_max=NF_MAX,
                  device=DEV).eval()
    vunet.load_state_dict(convert.vunet_alter_from_flax(params["vunet"]))
    flow = LatentFlow(HID, FLOW_MID, n_flows=N_FLOWS, device=DEV).eval()
    flow.load_state_dict(convert.latent_flow_from_flax(params["flow"]))

    def pipeline(use_kernel):
        return BehaviorTransferPipeline(
            behavior, vunet, detailed_joint_model(world_coords=True),
            inputs["norm_mean"], inputs["norm_std"], inputs["dim_to_use"],
            spatial_size=S, flow_model=flow, use_rollout_kernel=use_kernel)

    cam = (inputs["app_img"], inputs["extrinsics"], inputs["intrinsics"],
           inputs["image_size"])
    plain = pipeline(False)
    for name, out in (
            ("generate", plain.generate(inputs["z"], inputs["x_start"], *cam,
                                        length=T, eps=eps)),
            ("reenact", plain.reenact(inputs["x_source"], inputs["x_start"],
                                      *cam, length=T, eps=eps))):
        ref = g[name]
        d_pose = float(np.abs(out["poses_3d"].cpu().numpy()
                              - ref["poses_3d"]).max())
        d_px = float(np.abs(out["keypoints_2d"].cpu().numpy()
                            - ref["keypoints_2d"]).max())
        stick = out["stickman"].float().cpu().numpy()
        mism = float(np.mean(np.any(stick != ref["stickman"], axis=-1)))
        with torch.inference_mode():
            means, _ = vunet.encode_means(
                torch.from_numpy(inputs["app_img"]).to(DEV), eps)
            on_ref_stick = vunet.transfer_cached(
                [torch.repeat_interleave(m, T, 0) for m in means],
                torch.from_numpy(ref["stickman"].reshape(
                    (-1, S, S, 3))).to(DEV))
        frames_ref = ref["frames"]
        d_vunet = float(np.abs(on_ref_stick.cpu().numpy().reshape(
            frames_ref.shape) - frames_ref).max())
        tol_vunet = 1e-4 * (1 + float(np.abs(frames_ref).max()))
        d_frames = float(np.mean(np.abs(out["frames"].cpu().numpy()
                                        - frames_ref)))
        log(f"[6] golden {name}: poses {d_pose:.2e} (<=1e-4), keypoints "
            f"{d_px:.2e} px (<=1e-2), stickman mismatch {mism:.2e} "
            f"(<=1e-3), VUNet on golden stickman {d_vunet:.2e} "
            f"(<={tol_vunet:.2e}), frames mean abs {d_frames:.2e} (<=1e-3)")
        RESULTS[f"golden_{name}"] = dict(
            poses=d_pose, keypoints=d_px, stickman_mismatch=mism,
            vunet=d_vunet, vunet_tol=tol_vunet, frames_mean_abs=d_frames)
        check(d_pose <= 1e-4 and d_px <= 1e-2 and mism <= 1e-3
              and d_vunet <= tol_vunet and d_frames <= 1e-3,
              f"golden {name} out of tolerance")
    with torch.inference_mode():
        b = flow.reverse(torch.from_numpy(inputs["z"]).to(DEV))
        xs = decoder_rollout_kernel(
            behavior.decoder, torch.from_numpy(g["rollout"]["b"]).to(DEV),
            torch.from_numpy(inputs["x_start"]).to(DEV), T)
    d_b = float(np.abs(b.cpu().numpy() - g["rollout"]["b"]).max())
    xs_ref = torch.from_numpy(g["rollout"]["xs"])
    d_xs = float((xs.cpu() - xs_ref).abs().max())
    ok_xs = torch.allclose(xs.cpu(), xs_ref, atol=5e-2, rtol=1e-2)
    log(f"[6] golden flow reverse {d_b:.2e}; rollout kernel vs JAX f32 scan "
        f"{d_xs:.2e} (atol 5e-2, rtol 1e-2: {ok_xs})")
    RESULTS["golden_rollout"] = dict(flow_reverse=d_b, kernel_vs_scan=d_xs)
    check(d_b <= 1e-4 * (1 + float(np.abs(g["rollout"]["b"]).max()))
          and ok_xs, "golden flow/rollout out of tolerance")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch "
                                 "port on one NVIDIA GPU")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "chip_smoke.json"),
                    help="where to write every measured value as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_card()
    phase_build()
    max_err, ms, plain_ms = phase_kernel()
    launches = phase_slice()
    phase_cli()
    phase_golden()
    kernels = {"kernels": [{
        "name": "residual_lstm_rollout", "route": "cuda",
        "source": "behavior_driven_video_synthesis_tpu_torch/csrc/rollout.cu",
        "replaces": "behavior_driven_video_synthesis_tpu/ops/pallas/"
                    "rollout.py:26",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms}]}
    RESULTS.update(kernels)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(RESULTS, f, indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
