#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout, on a machine with one CUDA device, the
CUDA toolkit (nvcc) and PyTorch.  It imports no JAX.  Phases:

1. the card: its name and power limit;
2. the build of every CUDA kernel from ``csrc/`` (one nvcc per source, all
   started together), with nvcc's register, shared-memory and spill report;
3. each kernel against its plain PyTorch version at its main path's
   shapes, both timed with CUDA events: the rollout at the serving path's
   and at B=256 (bulk sampling), on prepared operands, beside the
   ``decoder_rollout_kernel`` call with cached operands (the route), T grid
   barriers alone on the kernel's grid (the floor of any serial rollout),
   its bound, launch configuration and nvcc's registers and spills;
   the ELU+dropout forward and backward at the VUNet's largest dropout
   site (12, 256, 256, 32) bf16 and at a ragged f32 size, with
   ``F.dropout(F.elu(x))`` timed beside them as a yardstick; the fused RNB
   checked at the VUNet's 125-frame chunk sites (256/128/64/32/4 px) and a
   ragged shape, its nvcc report (registers, spills) and launch plan
   (shared memory, blocks an SM) for each instantiation, and timed at
   every site of an org request (7 chunk sites, 5 ``encode_means`` sites)
   on prepared operands, beside the ``VunetRNB`` call under ``fused`` (the
   route) and the default eval forward (cuDNN conv and eager elementwise
   ops), with the request's sum of launches x time against launches x
   bound;
4. the full-width serving slice at ``bench.py``'s shapes (B=20, T=50,
   256 px, HID 1024, 48 of 51 keypoints, a 15-flow LatentFlow of mid width
   2048 in f32, VUNet-alter nf 32->128 in bf16) on seeded random weights
   made on the device: generate (sample mode, with the flow), reenact, and
   generate at B=3; every request must launch the rollout kernel once;
   then one B=20 request with ``rnb_impl="fused"`` (126 fused RNB
   launches);
5. the serving CLI in-process at a small width, from .npz parameter files
   and a request file written here from a numpy seed; also an org
   synthesis run (experiment "vunet") with ``--rnb_impl fused``;
6. the port at small width against ``tests/golden/torch_port_slice_small.npz``
   (outputs of the JAX package), in f32 with TF32 off, and the small org
   VUNet against ``tests/golden/torch_port_org_small.npz``;
7. cvbae VUNet training at full width through ``bdvs-train-torch``'s
   ``main`` in-process: ``configs/shape_and_pose_net.yaml`` (256 px, B=12,
   nf 32->128, regressor on, dropout 0.05, bf16) with
   ``dropout_impl: pallas`` and 6 steps; every step must be finite and
   launch each ELU+dropout kernel once per dropout site; the written
   ``synth.npz`` then serves one ``transfer_cached`` call;
8. the port's cvbae step at small width against
   ``tests/golden/torch_port_train_small.npz`` (two JAX steps), in f32 with
   TF32 off;
9. org-VUNet serving at full width: ``configs/vunet.yaml``'s VUNet (256 px,
   nf 32->128, a 30-channel 64x64 part-stack appearance, box_factor 2,
   bf16) behind phase 4's behavior net and flow, B=20, T=50, a warm-up and
   two timed requests under each ``rnb_impl``; the fused route must launch
   the fused RNB kernel 122 times a request and stay within a relative L2
   of 2e-2 of the same request through the kernel's plain version; one
   org ``test_forward`` chunk (the autoregressive prior);
10. behavior_net training at full width through ``bdvs-train-torch``'s
    ``main`` in-process with ``--debug``: ``configs/behavior_net.yaml``
    otherwise unchanged (B=64, T=50, 51 keypoints, ``dim_hidden_b`` 1024,
    LSTM decoder, 15 flows of mid width 2048, f32), 16 cVAE steps over 2
    epochs and 8 flow steps, each between two synchronizations; every
    metric finite, ``metrics.jsonl`` with train/, eval/ and flow/ lines;
    one profiled step of each stage; a second ``main`` with ``-r`` runs no
    step; then the written ``behavior.npz`` behind phase 4's alter VUNet
    serves one B=20, T=50 sample request, which must launch the rollout
    kernel once and match the decoder's plain loop;
11. the port's behavior cVAE and flow steps at small width against
    ``tests/golden/torch_port_behavior_small.npz`` (two JAX steps of
    each, with their draws), in f32 with TF32 off.

The last two lines are a JSON object of kernel results and
``{"ok": true, "device": {...}}``; any failure exits non-zero before them.
All measured values also go to a JSON file, ``build/chip_smoke.json`` unless
``--out PATH`` names another.
"""
import argparse
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
import yaml

# the script's directory, the checkout's root, is first on sys.path
from behavior_driven_video_synthesis_tpu_torch import generate as cli
from behavior_driven_video_synthesis_tpu_torch import main as train_cli
from behavior_driven_video_synthesis_tpu_torch.core.config import (
    deep_merge, load_config)
from behavior_driven_video_synthesis_tpu_torch.core.precision import (
    disable_tf32)
from behavior_driven_video_synthesis_tpu_torch.experiments import (
    behavior_net, shape_and_pose_net)
from behavior_driven_video_synthesis_tpu_torch.experiments.data_factory import (
    build_sequence_data)
from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
    flatten_tree, unflatten_tree)
from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
    detailed_joint_model)
from behavior_driven_video_synthesis_tpu_torch.geometry.stickman import (
    render_stickman)
from behavior_driven_video_synthesis_tpu_torch.models import convert
from behavior_driven_video_synthesis_tpu_torch.models.behavior import (
    ResidualBehaviorNet, ResidualDecoder, decoder_rollout_kernel)
from behavior_driven_video_synthesis_tpu_torch.models.flows import LatentFlow
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.discriminators import (
    SequenceDiscMichael)
from behavior_driven_video_synthesis_tpu_torch.models.perceptual import (
    LaplacianPyramidFeatures)
from behavior_driven_video_synthesis_tpu_torch.models.probes import (
    ClassifierAction, ClassifierActionBeta, RegressorFly)
from behavior_driven_video_synthesis_tpu_torch.models.vunet import (
    VUNet, VunetRegressor, latent_widths, vunet_from_config)
from behavior_driven_video_synthesis_tpu_torch.ops import nn as ops_nn
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import elu_dropout
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import fused_rnb
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import rollout
from behavior_driven_video_synthesis_tpu_torch.ops.cuda.build import (
    build_log, load_library)
from behavior_driven_video_synthesis_tpu_torch.pipeline import (
    BehaviorTransferPipeline)
from behavior_driven_video_synthesis_tpu_torch.train.behavior import (
    BehaviorTrainState, StepDraws, make_behavior_train_step)
from behavior_driven_video_synthesis_tpu_torch.train.flow import (
    FlowTrainState, make_flow_train_step)
from behavior_driven_video_synthesis_tpu_torch.train.state import (
    make_behavior_optimizers, make_flow_optimizer, make_vunet_optimizers)
from behavior_driven_video_synthesis_tpu_torch.train.vunet_exp import (
    VunetTrainState, make_cvbae_train_step)

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda")
# the serving slice of bench.py:202-236
SLICE = dict(B=20, T=50, S=256, HID=1024, K_FULL=51, K_USE=48, NF_START=32,
             NF_MAX=128, N_FLOWS=15)
ROLLOUT_SHAPES = [(20, 48, 1024, 50), (1, 48, 1024, 50), (3, 51, 1024, 7),
                  (256, 48, 1024, 50)]
# the rollout timed: the serving request's shape and bulk sampling's batch
ROLLOUT_TIMED = [(20, 48, 1024, 50), (256, 48, 1024, 50)]
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_slice_small.npz")
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "golden",
                            "torch_port_train_small.npz")
ORG_GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_org_small.npz")
TRAIN_CONFIG = os.path.join(ROOT, "configs", "shape_and_pose_net.yaml")
ORG_CONFIG = os.path.join(ROOT, "configs", "vunet.yaml")
BEHAVIOR_CONFIG = os.path.join(ROOT, "configs", "behavior_net.yaml")
BEHAVIOR_GOLDEN = os.path.join(ROOT, "tests", "golden",
                               "torch_port_behavior_small.npz")
# --debug: 2 epochs and 1 flow epoch of 8 batches of 64 sequences
BEHAVIOR_STEPS, BEHAVIOR_FLOW_STEPS = 16, 8
TRAIN_STEPS = 6
# the VUNet's dropout sites at 256 px, 7 scales, 2 latent scales: 14 RNBs
# in each EncUp (one site each), 5 residual RNBs in EncDown and 16 in
# DecDown (two sites each)
DROPOUT_SITES = 14 + 14 + 2 * 5 + 2 * 16
# sites whose output reaches no loss term, so autograd never runs their
# backward (nor does XLA, which drops them as dead code): EncDown's last
# two residual blocks (the second block of the last latent scale and
# fin_block) feed only EncDown's returned features
DEAD_BACKWARD_SITES = 2 * 2
ELU_DROPOUT_SHAPES = [((12, 256, 256, 32), torch.bfloat16),
                      ((1000003,), torch.float32)]
ELU_DROPOUT_RATES = (0.05, 0.5)
# the fused RNB kernel held against its plain version: sites of a
# 125-frame chunk (B=20, T=50 is 8 chunks of 125) and a ragged shape
FUSED_RNB_SHAPES = [(125, 256, 256, 32), (125, 128, 128, 64),
                    (125, 64, 64, 128), (125, 32, 32, 128),
                    (125, 4, 4, 128), (3, 37, 53, 64)]
# the fused RNB's sites in one org B=20, T=50 request and its launches at
# each: the two RNBs of each EncUp scale, once a 125-frame chunk in du (7
# scales from 256 px at nf 32 to 4 px at 128, 8 chunks) and once a video in
# eu (5 scales of the 64x64 part stack)
CHUNK_RNB_SITES = [(125, s, s, min(32 * 256 // s, 128))
                   for s in (256, 128, 64, 32, 16, 8, 4)]
ORG_RNB_SITES = {**{site: 2 * 8 for site in CHUNK_RNB_SITES},
                 **{(20, s, s, min(32 * 64 // s, 128)): 2
                    for s in (64, 32, 16, 8, 4)}}
ORG_RNB_LAUNCHES = sum(ORG_RNB_SITES.values())      # 2 * 5 + 2 * 7 * 8
ALTER_RNB_LAUNCHES = 2 * 7 + 2 * 7 * 8
# one org test_forward chunk: du's 14 and the prior's two pre blocks
ORG_PRIOR_RNB_LAUNCHES = 2 * 7 + 2
# NVIDIA's H100 SXM data sheet: HBM rate, bf16 dense tensor-core and f32
# (outside the tensor cores) peaks, at 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
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
KERNEL_SOURCES = ("rollout", "elu_dropout", "fused_rnb")


def phase_build():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for lib in pool.map(load_library, KERNEL_SOURCES):
            check(lib is not None, "a kernel library did not load")
    log(f"[2] csrc/{{{','.join(KERNEL_SOURCES)}}}.cu built in parallel and "
        f"loaded in {time.perf_counter() - t0:.1f} s")
    for name in KERNEL_SOURCES:
        log(f"    csrc/{name}.cu:")
        log(build_log(name).strip())
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


def rollout_decoder(args):
    """A ResidualDecoder on the card holding rollout_args' weights."""
    (_, H), K = args[0].shape, args[1].shape[1]
    decoder = ResidualDecoder(K, H, device="meta").to_empty(device=DEV)
    names = ("rnn.weight_ih", "rnn.weight_hh", "rnn.bias_ih", "rnn.bias_hh",
             "n_out.weight", "n_out.bias")
    decoder.load_state_dict(dict(zip(names, args[2:])))
    return decoder.eval()


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
    for name, (regs, st, ld) in sorted(
            ptxas_report(build_log("rollout"), "rollout_kernel").items()):
        log(f"    rollout_kernel<weights in smem={bool(name)}>: {regs} "
            f"registers, spill stores {st} B, spill loads {ld} B")
        RESULTS.setdefault("rollout_registers", {})[name] = dict(
            registers=regs, spill_stores=st, spill_loads=ld)
    log("    times: the kernel on prepared operands (CUDA events), the "
        "decoder_rollout_kernel call with its operands cached (route), T "
        "grid barriers alone on the same grid (floor)")
    timed = {}
    for B, K, H, T in ROLLOUT_TIMED:
        args = rollout_args(B, K, H)
        decoder = rollout_decoder(args)
        b, x0 = args[:2]
        cfg = rollout.rollout_config(B, K, H)
        with torch.no_grad():
            operands = rollout.prepared_operands(decoder)

            def kernel():
                return rollout.residual_lstm_rollout_prepared(b, x0,
                                                              operands, T)

            def plain():
                return rollout.residual_lstm_rollout_plain(
                    *args, T, operand_dtype=torch.bfloat16)

            def route():
                return decoder_rollout_kernel(decoder, b, x0, T)
            out = kernel()
            ref = rollout.residual_lstm_rollout_prepared_plain(
                b, x0, operands, T)
            e = float((out - ref).abs().max())
            check(torch.allclose(out, ref, atol=1e-2, rtol=1e-2),
                  f"kernel on prepared operands disagrees with its plain "
                  f"version at {(B, K, H, T)}: {e:.3e}")
            if B <= 32:
                order = [("plain", plain, 5), ("kernel", kernel, 50),
                         ("kernel", kernel, 50), ("plain", plain, 5)]
            else:
                order = [("kernel", kernel, 20), ("kernel", kernel, 20),
                         ("plain", plain, 1)]
            times = [(name, cuda_ms(fn, n)) for name, fn, n in order]
            builds = rollout.operand_builds
            route_ms = cuda_ms(route, 20)
            check(rollout.operand_builds == builds,
                  "decoder_rollout_kernel rebuilt cached operands")
            floor_ms = cuda_ms(
                lambda: rollout.barrier_floor(B, K, H, T, DEV), 20)
        ms = float(np.mean([t for n, t in times if n == "kernel"]))
        plain_ms = float(np.mean([t for n, t in times if n == "plain"]))
        bound, bound_by = rollout_bound_ms(B, K, H, T)
        log(f"    {(B, K, H, T)}: launch {cfg}; "
            + ", ".join(f"{n} {t:.4f} ms" for n, t in times)
            + f"; route {route_ms:.4f} ms; floor of {T} barriers "
            f"{floor_ms:.4f} ms; bound {bound:.5f} ms ({bound_by}); "
            f"{ms / T * 1e3:.2f} us a step, {floor_ms / T * 1e3:.2f} of "
            f"them the barrier; max|kernel-plain| {e:.3e}")
        timed[(B, K, H, T)] = dict(
            config=cfg, order=times, ms=ms, plain_ms=plain_ms,
            route_ms=route_ms, floor_ms=floor_ms, bound_ms=bound,
            bound_by=bound_by, max_abs_err=e)
    RESULTS["rollout_times_ms"] = [dict(shape=list(k), **v)
                                   for k, v in timed.items()]
    serving = timed[ROLLOUT_TIMED[0]]
    return max(errs), serving["ms"], serving["plain_ms"]


def rollout_bound_ms(B, K, H, T):
    """Least time of the rollout at (B, K, H, T): its bytes (bf16 weights
    and f32 inputs read once, the f32 output written once) over the HBM
    rate, against its gate and output products at the bf16 tensor-core
    peak.  (The T steps depend on each other, which this bound ignores.)"""
    weights = 2 * (4 * H * K + 4 * H * H + K * H)
    vectors = 4 * (2 * 4 * H + K + B * H + B * K) + 4 * B * T * K
    flops = T * (2 * B * (K + H) * 4 * H + 2 * B * H * K)
    t_bytes = (weights + vectors) / HBM_BYTES_PER_S
    t_ops = flops / BF16_TENSOR_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def elu_dropout_bound_ms(n, dtype, backward):
    """Least time of one ELU+dropout pass over n elements: x (and ct) read
    once, out written once, against ~4 f32 operations an element (the
    compare, exp, product and select) at the f32 peak outside the tensor
    cores; Philox's integer work has no entry in the data sheet's table
    and is left out."""
    size = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (3 if backward else 2) * n * size / HBM_BYTES_PER_S
    t_ops = 4 * n / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ulp_ok(out, ref):
    """|out - ref| within one ulp of ref in bf16, within 1e-6 in f32."""
    if out.dtype == torch.bfloat16:
        ulp = torch.finfo(torch.bfloat16).eps * ref.float().abs().clamp(
            min=torch.finfo(torch.bfloat16).tiny)
        return bool(((out.float() - ref.float()).abs() <= ulp).all())
    return bool(((out - ref).abs() <= 1e-6).all())


def phase_elu_dropout():
    log("[3] ELU+dropout kernels vs plain PyTorch (the same Philox stream: "
        "0 keep-decision mismatches; values within 1 bf16 ulp, or 1e-6 in "
        "f32; drop fraction within 5 sigma of the rate)")
    g = torch.Generator(device=DEV).manual_seed(0)
    errs = {"fwd": 0.0, "bwd": 0.0}
    for shape, dtype in ELU_DROPOUT_SHAPES:
        x = torch.randn(shape, generator=g, device=DEV).to(dtype)
        ct = torch.randn(shape, generator=g, device=DEV).to(dtype)
        for rate in ELU_DROPOUT_RATES:
            seed = elu_dropout.draw_seed(DEV, g)
            y = elu_dropout.elu_dropout_forward(x, seed, rate)
            dx = elu_dropout.elu_dropout_backward(x, ct, seed, rate)
            torch.cuda.synchronize()
            y_ref = elu_dropout.elu_dropout_plain(x, seed, rate)
            dx_ref = elu_dropout.elu_dropout_backward_plain(x, ct, seed,
                                                            rate)
            thresh, _ = elu_dropout.keep_params(rate)
            keep = (elu_dropout.dropout_bits(seed, x.numel()) < thresh
                    ).reshape(shape)
            # an element is dropped iff it is 0 where ELU is not 0
            live = F.elu(x.float()) != 0
            mism = int(((y != 0) != keep)[live].sum()
                       + ((y_ref != 0) != keep)[live].sum()
                       + ((dx != 0) != keep)[live & (ct != 0)].sum())
            drop = 1.0 - float(keep.float().mean())
            sigma = (rate * (1 - rate) / x.numel()) ** 0.5
            e_fwd = float((y.float() - y_ref.float()).abs().max())
            e_bwd = float((dx.float() - dx_ref.float()).abs().max())
            ok = (mism == 0 and abs(drop - rate) <= 5 * sigma
                  and ulp_ok(y, y_ref) and ulp_ok(dx, dx_ref)
                  and y.dtype == dtype and dx.dtype == dtype)
            log(f"    {tuple(shape)} {str(dtype)[6:]} rate {rate}: keep "
                f"mismatches {mism}, drop fraction {drop:.6f} "
                f"({(drop - rate) / sigma:+.2f} sigma), max|fwd-plain| "
                f"{e_fwd:.3e}, max|bwd-plain| {e_bwd:.3e} "
                f"({'ok' if ok else 'FAIL'})")
            RESULTS.setdefault("elu_dropout_vs_plain", []).append(dict(
                shape=list(shape), dtype=str(dtype), rate=rate,
                keep_mismatches=mism, drop_fraction=drop,
                max_abs_err_fwd=e_fwd, max_abs_err_bwd=e_bwd))
            check(ok, f"ELU+dropout kernels disagree with their plain "
                  f"versions at {tuple(shape)} {dtype} rate {rate}")
            errs["fwd"] = max(errs["fwd"], e_fwd)
            errs["bwd"] = max(errs["bwd"], e_bwd)
    # time at the largest dropout site of the training path
    shape, dtype = ELU_DROPOUT_SHAPES[0]
    rate = 0.05
    x = torch.randn(shape, generator=g, device=DEV).to(dtype)
    ct = torch.randn(shape, generator=g, device=DEV).to(dtype)
    seed = elu_dropout.draw_seed(DEV, g)
    xg = x.clone().requires_grad_(True)
    y_lib = F.dropout(F.elu(xg), rate)
    fns = {
        "fwd": (lambda: elu_dropout.elu_dropout_forward(x, seed, rate),
                lambda: elu_dropout.elu_dropout_plain(x, seed, rate),
                lambda: F.dropout(F.elu(x), rate)),
        "bwd": (lambda: elu_dropout.elu_dropout_backward(x, ct, seed, rate),
                lambda: elu_dropout.elu_dropout_backward_plain(x, ct, seed,
                                                               rate),
                lambda: torch.autograd.grad(y_lib, xg, ct,
                                            retain_graph=True)),
    }
    out = {}
    for d, (kernel, plain, library) in fns.items():
        order = [("plain", plain, 5), ("kernel", kernel, 50),
                 ("kernel", kernel, 50), ("plain", plain, 5)]
        times = [(n, cuda_ms(fn, it)) for n, fn, it in order]
        lib_ms = cuda_ms(library, 50)
        ms = float(np.mean([t for n, t in times if n == "kernel"]))
        plain_ms = float(np.mean([t for n, t in times if n == "plain"]))
        bound, bound_by = elu_dropout_bound_ms(x.numel(), dtype, d == "bwd")
        log(f"    {d} at {shape} bf16 rate {rate} (plain, kernel, kernel, "
            f"plain): " + ", ".join(f"{n} {t:.4f} ms" for n, t in times)
            + f"; library {lib_ms:.4f} ms; bound {bound:.4f} ms "
            f"({bound_by})")
        RESULTS[f"elu_dropout_{d}_times_ms"] = dict(
            order=times, library=lib_ms, bound=bound)
        out[d] = dict(max_abs_err=errs[d], ms=ms, plain_ms=plain_ms,
                      library_ms=lib_ms, bound_ms=bound, bound_by=bound_by)
    return out


def fused_rnb_bound_ms(B, H, W, C):
    """Least time of one fused RNB at (B, H, W, C) bf16: x read and out
    written once, the bf16 W and the f32 scale and shift read once, against
    the 3x3 conv's 2 * 9 * C * C operations a pixel at the bf16
    tensor-core peak."""
    n = B * H * W * C
    t_bytes = (2 * n * 2 + 9 * C * C * 2 + 2 * C * 4) / HBM_BYTES_PER_S
    t_ops = 2 * 9 * C * n / BF16_TENSOR_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ptxas_report(log_text, kernel):
    """{template argument: (registers, spill store bytes, spill load
    bytes)} of each instantiation of ``kernel`` in an nvcc -Xptxas -v
    log."""
    out, cur, spills = {}, None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            a = re.search(kernel + r"IL[a-z](\d+)E", m.group(1))
            cur = int(a.group(1)) if a else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur] = (int(m.group(1)),) + spills
            cur, spills = None, (0, 0)
    return out


def device_ms_per_launch(fn, n, name):
    """Mean device time of the kernels whose name holds ``name`` over n
    calls of fn, from torch.profiler; None where it saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.key and e.self_device_time_total > 0]
    count = sum(e.count for e in events)
    if count == 0:
        return None
    return sum(e.self_device_time_total for e in events) / count / 1e3


def fused_twin(block, C):
    """A VunetRNB under rnb_impl "fused" with block's weights."""
    twin = ops_nn.VunetRNB(C, dtype=torch.bfloat16, rnb_impl="fused",
                           device="meta").to_empty(device=DEV)
    twin.load_state_dict(block.state_dict())
    return twin.eval()


def phase_fused_rnb():
    log("[3] fused RNB kernel vs plain PyTorch (bf16: atol 1e-2, rtol 1e-2)")
    report = ptxas_report(build_log("fused_rnb"), "fused_rnb_kernel")
    for CP in sorted(report):
        plan = fused_rnb.kernel_plan(CP, DEV)
        regs, st, ld = report[CP]
        log(f"    instantiation CP={CP}: {regs} registers, spill stores "
            f"{st} B, spill loads {ld} B; dynamic shared memory "
            f"{plan['smem_bytes']:,} B, {plan['tap_slots']} tap slots, "
            f"{plan['halo_buffers']} halo buffer(s), a warp {plan['warp_rows']}"
            f" rows x {plan['warp_channels']} channels, "
            f"{plan['blocks_per_sm']} block(s) an SM, grid cap "
            f"{plan['grid_cap']}")
        RESULTS.setdefault("fused_rnb_instantiations", {})[CP] = dict(
            registers=regs, spill_stores=st, spill_loads=ld, **plan)
    check(len(report) == 8, f"ptxas reported {sorted(report)}")
    check(not any(st or ld for _, st, ld in report.values()),
          "a fused RNB instantiation spills registers")
    g = torch.Generator(device=DEV).manual_seed(0)
    blocks, err = {}, 0.0

    def block_of(C):
        if C not in blocks:
            blocks[C] = on_device(ops_nn.VunetRNB(
                C, dtype=torch.bfloat16, device="meta"), g)
        return blocks[C]
    for shape in FUSED_RNB_SHAPES:
        block = block_of(shape[-1])
        x = (torch.randn(shape, generator=g, device=DEV) * 0.5).bfloat16()
        with torch.inference_mode():
            out = fused_rnb.fused_rnb(x, block)
            torch.cuda.synchronize()
            ref = fused_rnb.fused_rnb_plain(x, block)
        e = float((out.float() - ref.float()).abs().max())
        ok = (out.shape == x.shape and out.dtype == torch.bfloat16
              and torch.allclose(out.float(), ref.float(), atol=1e-2,
                                 rtol=1e-2))
        log(f"    {shape}: max|kernel-plain| {e:.3e} "
            f"({'ok' if ok else 'FAIL'}), max|out| "
            f"{float(out.float().abs().max()):.3f}")
        RESULTS.setdefault("fused_rnb_vs_plain", []).append(
            dict(shape=list(shape), max_abs_err=e))
        check(ok, f"fused RNB kernel disagrees with its plain version at "
              f"{shape}")
        err = max(err, e)
    log("    times at the org request's sites: the kernel on prepared "
        "operands (CUDA events; device time per launch from "
        "torch.profiler), the VunetRNB call under rnb_impl fused (route), "
        "the default VunetRNB eval forward (library: cuDNN conv and eager "
        "ELU, affine, residual)")
    timed, rows = {}, []
    for shape in ORG_RNB_SITES:
        C = shape[-1]
        block = block_of(C)
        twin = fused_twin(block, C)
        x = (torch.randn(shape, generator=g, device=DEV) * 0.5).bfloat16()
        n = 20 if shape[1] >= 64 else 100
        with torch.inference_mode():
            operands = fused_rnb.prepared_operands(block)

            def kernel():
                return fused_rnb.fused_rnb_prepared(x, operands)

            def plain():
                return fused_rnb.fused_rnb_plain(x, block)
            out, ref = kernel().float(), plain().float()
            e = float((out - ref).abs().max())
            close = torch.allclose(out, ref, atol=1e-2, rtol=1e-2)
            order = [("plain", plain, 3), ("kernel", kernel, n),
                     ("kernel", kernel, n), ("plain", plain, 3)]
            times = [(name, cuda_ms(fn, it)) for name, fn, it in order]
            route_ms = cuda_ms(lambda: twin(x), n)
            lib_ms = cuda_ms(lambda: block(x), n)
            dev_ms = device_ms_per_launch(kernel, n, "fused_rnb_kernel")
        ms = float(np.mean([t for name, t in times if name == "kernel"]))
        plain_ms = float(np.mean([t for name, t in times
                                  if name == "plain"]))
        bound, bound_by = fused_rnb_bound_ms(*shape)
        launches = ORG_RNB_SITES[shape]
        kernel_ms = dev_ms if dev_ms is not None else ms
        log(f"    {shape}: (plain, kernel, kernel, plain) "
            + ", ".join(f"{name} {t:.4f}" for name, t in times)
            + " ms; device "
            + ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms")
            + f"; route {route_ms:.4f} ms; library {lib_ms:.4f} ms; bound "
            f"{bound:.4f} ms ({bound_by}), kernel at {bound / kernel_ms:.1%}"
            f" of it; {lib_ms / kernel_ms:.2f}x the library; "
            f"{launches} launches an org request; max|kernel-plain| "
            f"{e:.3e}")
        check(close, f"fused RNB kernel disagrees with its plain version "
              f"at {shape}")
        rows.append(dict(shape=list(shape), order=times, ms=ms,
                         device_ms=dev_ms, route_ms=route_ms, library=lib_ms,
                         bound=bound, bound_by=bound_by, launches=launches,
                         max_abs_err=e))
        timed[shape] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound, bound_by=bound_by)
    total = {k: sum(r["launches"] * v for r, v in zip(rows, vals))
             for k, vals in (
                 ("kernel", [r["device_ms"] if r["device_ms"] is not None
                             else r["ms"] for r in rows]),
                 ("route", [r["route_ms"] for r in rows]),
                 ("library", [r["library"] for r in rows]),
                 ("bound", [r["bound"] for r in rows]))}
    log(f"    an org B=20, T=50 request ({ORG_RNB_LAUNCHES} launches): "
        f"sum of launches x kernel {total['kernel']:.3f} ms, x route "
        f"{total['route']:.3f} ms, x library {total['library']:.3f} ms, "
        f"x bound {total['bound']:.3f} ms (kernel at "
        f"{total['bound'] / total['kernel']:.1%} of its bound)")
    RESULTS["fused_rnb_sites"] = rows
    RESULTS["fused_rnb_org_request_ms"] = total
    # the kernels line carries the largest site, 256 px at C=32
    return dict(max_abs_err=err, **timed[CHUNK_RNB_SITES[0]])


# -- 4. the full-width slice --------------------------------------------------
def serving_vunet(variant, **kw):
    """The serving VUNet on the meta device: bench.py's alter VUNet, or
    configs/vunet.yaml's org VUNet (30-channel part stack, box_factor 2)."""
    if variant == "org":
        return vunet_from_config(load_config(ORG_CONFIG), "org",
                                 dtype=torch.bfloat16, device="meta", **kw)
    return VUNet(spatial_size=SLICE["S"], nf_start=SLICE["NF_START"],
                 nf_max=SLICE["NF_MAX"], dtype=torch.bfloat16,
                 device="meta", **kw)


def with_rnb_impl(vunet, variant, rnb_impl):
    """A copy of a serving VUNet, its weights included, under rnb_impl."""
    other = serving_vunet(variant, rnb_impl=rnb_impl).to_empty(device=DEV)
    other.load_state_dict(vunet.state_dict())
    return other.eval()


def full_width_slice(variant="alter"):
    HID, K_FULL, K_USE, S = (SLICE[k] for k in ("HID", "K_FULL", "K_USE",
                                                 "S"))
    g = torch.Generator(device=DEV).manual_seed(0)
    behavior = on_device(ResidualBehaviorNet(
        K_USE, HID, dtype=torch.bfloat16, device="meta"), g)
    flow = on_device(LatentFlow(HID, 2 * HID, n_flows=SLICE["N_FLOWS"],
                                device="meta"), g)
    vunet = on_device(serving_vunet(variant), g)
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


def request_inputs(B, g, app_shape=None):
    """A request of B videos; the appearance is (B,) + app_shape, by
    default an RGB image at the slice's size."""
    HID, K, S = SLICE["HID"], SLICE["K_USE"], SLICE["S"]
    app_shape = app_shape or (S, S, 3)
    extr = torch.tensor(np.hstack([np.eye(3), [[0], [0], [4.0]]]),
                        dtype=torch.float32, device=DEV).expand(B, 3, 4)
    intr = torch.tensor([1145.0, 500.0, 1143.0, 500.0],
                        device=DEV).expand(B, 4)
    return dict(
        z=torch.randn(B, HID, generator=g, device=DEV),
        x_start=torch.zeros(B, K, device=DEV),
        app_img=torch.rand((B,) + tuple(app_shape), generator=g,
                           device=DEV) * 2 - 1,
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
    stage_breakdown(pipe, inputs[B], g, "slice_stages_ms")
    alter_fused_request(pipe, inputs[B])
    return launches


def serve(pipe, x, seed=1):
    """One generate request, its posterior noise drawn from a generator
    seeded with ``seed`` (so that two calls make the same request):
    (outputs, host ms, peak device bytes)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.generate(x["z"], x["x_start"], x["app_img"], x["extrinsics"],
                        x["intrinsics"], x["image_size"],
                        length=SLICE["T"], generator=g)
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated())


def rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def alter_fused_request(pipe, x):
    """One B=20 alter request under rnb_impl "fused" beside the same
    request under the default route."""
    B, T = SLICE["B"], SLICE["T"]
    cudnn_vunet = pipe.vunet
    ref, _, _ = serve(pipe, x)
    pipe.vunet = with_rnb_impl(cudnn_vunet, "alter", "fused")
    try:
        fused_rnb.fused_rnb_launches = 0    # counts start here: the alter
        out, ms, peak = serve(pipe, x)      # fused route
        launches = fused_rnb.fused_rnb_launches
    finally:
        pipe.vunet = cudnn_vunet
    frames = out["frames"]
    check(frames.shape == ref["frames"].shape
          and bool(torch.isfinite(frames.float()).all()),
          "alter fused request: frames")
    check(launches == ALTER_RNB_LAUNCHES,
          f"the alter B={B} request launched the fused RNB kernel "
          f"{launches} times, not {ALTER_RNB_LAUNCHES}")
    rel = rel_l2(frames, ref["frames"])
    log(f"    generate B={B} T={T} rnb_impl=fused: {ms:9.2f} ms, "
        f"{B * T * 1e3 / ms:8.1f} frames/s, peak {peak / 2**30:.2f} GiB; "
        f"{launches} fused RNB launches; rel-L2 to the cudnn route "
        f"{rel:.3e} (reported)")
    RESULTS["slice_alter_fused"] = dict(ms=ms, fps=B * T * 1e3 / ms,
                                        peak_gib=peak / 2**30,
                                        launches=launches, rel_l2_cudnn=rel)


def stage_breakdown(pipe, x, g, key):
    """Host-clock time of each stage of one full-batch request, kept in
    RESULTS[key]."""
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
    RESULTS[key] = stages


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
    # an org synthesis run (experiment "vunet": a 30-channel part stack at
    # S/4 = 16 px, box_factor 2) through the fused RNB kernel
    org = init_random_(VUNet(spatial_size=S, n_channels_x=30, nf_start=8,
                             nf_max=16, box_factor=2, variant="org"), rng)
    convert.save_flax_npz(os.path.join(tmp, "synth_org.npz"), {
        "vunet": convert.vunet_org_to_flax(org.state_dict())})
    with open(os.path.join(tmp, "synth_org.json"), "w") as f:
        json.dump({"data": {"spatial_size": S, "inplane_normalize": True,
                            "box_factor": 2},
                   "architecture": {"nf_start": 8, "nf_max": 16},
                   "general": {"experiment": "vunet"}}, f)
    req_org = os.path.join(tmp, "request_org.npz")
    np.savez(req_org, x_start=(rng.randn(2, K) * 0.1).astype(np.float32),
             app_img=(rng.rand(2, S // 4, S // 4, 30) * 2 - 1).astype(
                 np.float32))
    out = os.path.join(tmp, "org")
    before = fused_rnb.fused_rnb_launches
    man = cli.main(["--behavior_params", os.path.join(tmp, "behavior.npz"),
                    "--synth_params", os.path.join(tmp, "synth_org.npz"),
                    "--request", req_org, "--length", "8", "--out", out,
                    "--rnb_impl", "fused", "--device", "cuda"])
    # eu: 3 scales on the 16x16 part stack; du: 5 scales, one chunk
    launches = fused_rnb.fused_rnb_launches - before
    check((man["variant"], man["rnb_impl"]) == ("org", "fused")
          and len(man["videos"]) == 2 and all(
              os.path.getsize(p) > 0 for p in man["videos"].values()),
          f"CLI org: manifest {man}")
    check(launches == 2 * 3 + 2 * 5,
          f"CLI org: {launches} fused RNB launches")
    log(f"[5] CLI sample, org synthesis run, --rnb_impl fused: "
        f"{len(man['videos'])} videos on {man['device']}, {launches} fused "
        f"RNB launches")


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


def phase_org_golden():
    """The small org VUNet (tests/make_torch_port_org_golden.py) in f32:
    posterior means, transfer_cached and test_forward against the JAX
    package's, each within 1e-4 * (1 + max|ref|)."""
    with np.load(ORG_GOLDEN) as data:
        g = unflatten_tree({k: data[k] for k in data.files})
    arch = json.loads(bytes(g["config"]).decode())
    vunet = VUNet(**arch, device=DEV).eval()
    vunet.load_state_dict(convert.vunet_org_from_flax(
        unflatten_tree({k: v.astype(np.float32) for k, v in
                        flatten_tree(g["params"]["vunet"]).items()})))

    def dev(a):
        return torch.from_numpy(a).to(DEV)
    noise = g["noise"]
    post = [dev(noise["posterior"][str(i)]) for i in range(2)]
    prior = [[dev(noise["prior"][str(i)][str(l)]) for l in range(4)]
             for i in range(2)]
    c = dev(g["inputs"]["c"])
    with torch.inference_mode():
        means, _ = vunet.encode_means(dev(g["inputs"]["x"]), post)
        got = {f"means/{i}": m for i, m in enumerate(means)}
        got["transfer_cached"] = vunet.transfer_cached(means, c)
        got["test_forward"] = vunet.test_forward(c, prior)
    ref = flatten_tree(g["outputs"])
    worst = 0.0
    for k, v in got.items():
        err = float(np.abs(v.cpu().numpy() - ref[k]).max())
        worst = max(worst, err / (1e-4 * (1 + float(np.abs(ref[k]).max()))))
    log(f"[6] golden org VUNet (f32, TF32 off): worst error / tolerance "
        f"{worst:.3f} over {sorted(got)}")
    RESULTS["golden_org"] = dict(err_over_tol=worst)
    check(worst <= 1.0, "golden org VUNet out of tolerance")


# -- 7. cvbae training at full width -----------------------------------------
class StepRecorder:
    """Wraps the training step that ``make_cvbae_train_step`` returns:
    each step runs between two ``torch.cuda.synchronize()`` calls and is
    recorded with its metrics, its ELU+dropout launches and the host time
    since the previous step ended (the data pipeline's share)."""

    def __init__(self):
        self.steps, self.last, self._end = [], None, None

    def make(self, *args, **kwargs):
        step = make_cvbae_train_step(*args, **kwargs)

        def recorded(state, batch, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data_ms = (t0 - self._end) * 1e3 if self._end else None
            fwd0 = elu_dropout.elu_dropout_fwd_launches
            bwd0 = elu_dropout.elu_dropout_bwd_launches
            metrics = step(state, batch, **kw)
            torch.cuda.synchronize()
            self._end = time.perf_counter()
            self.steps.append(dict(
                step=state.step, ms=(self._end - t0) * 1e3, data_ms=data_ms,
                fwd_launches=elu_dropout.elu_dropout_fwd_launches - fwd0,
                bwd_launches=elu_dropout.elu_dropout_bwd_launches - bwd0,
                **{k: float(v) for k, v in metrics.items()}))
            self.last = (step, state, batch, kw)
            return metrics
        return recorded


def train_config(base_dir):
    cfg = load_config(TRAIN_CONFIG)
    return deep_merge(cfg, {
        "general": {"base_dir": base_dir, "project_name": "chip_smoke"},
        "training": {"dropout_impl": "pallas",
                     "end_iteration": TRAIN_STEPS}})


def site_shapes(recorder):
    """(numel, dtype) of every forward and every backward launch of one
    training step."""
    step, state, batch, kw = recorder.last
    shapes = {"fwd": [], "bwd": []}
    fwd, bwd = elu_dropout._launch_fwd, elu_dropout._launch_bwd

    def spy_fwd(x, seed, rate):
        shapes["fwd"].append((x.numel(), x.dtype))
        return fwd(x, seed, rate)

    def spy_bwd(x, ct, seed, rate):
        shapes["bwd"].append((x.numel(), x.dtype))
        return bwd(x, ct, seed, rate)
    elu_dropout._launch_fwd, elu_dropout._launch_bwd = spy_fwd, spy_bwd
    try:
        step(state, batch, **kw)
    finally:
        elu_dropout._launch_fwd, elu_dropout._launch_bwd = fwd, bwd
    return shapes


def per_step_bound_ms(shapes):
    """Bound of a step's ELU+dropout work, launch by launch."""
    return sum(elu_dropout_bound_ms(n, dtype, d == "bwd")[0]
               for d, launches in shapes.items() for n, dtype in launches)


def profile_step(recorder, step_ms):
    """Device busy time and the costliest kernels of one training step
    under torch.profiler; the idle share is taken against the profiled
    step's wall time and against ``step_ms``, the unprofiled median step.
    None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    step, state, batch, kw = recorder.last
    step(state, batch, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the kernels themselves: an operator's entry, or a range annotated on
    # the device's timeline (Optimizer.step), would count kernels twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        return None
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    elu = {d: [(e.self_device_time_total / 1e3, e.count) for e in events
               if "elu_dropout_kernel" in e.key and f"::{op}," in e.key]
           for d, op in (("fwd", "Fwd"), ("bwd", "Bwd"))}
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                elu_dropout_ms={d: sum(t for t, _ in v)
                                for d, v in elu.items()},
                elu_dropout_launches={d: sum(c for _, c in v)
                                      for d, v in elu.items()},
                idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                idle_share_unprofiled=max(0.0, 1.0 - busy_ms / step_ms),
                top=[(e.key[:90], e.self_device_time_total / 1e3, e.count)
                     for e in top])


def phase_train():
    base = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cfg = train_config(base)
    path = os.path.join(base, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    recorder = StepRecorder()
    made = shape_and_pose_net.make_cvbae_train_step
    shape_and_pose_net.make_cvbae_train_step = recorder.make
    elu_dropout.elu_dropout_fwd_launches = 0   # counts start here: the
    elu_dropout.elu_dropout_bwd_launches = 0   # main path of training
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = train_cli.main(["-c", path, "--device", "cuda"])
    finally:
        shape_and_pose_net.make_cvbae_train_step = made
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (elu_dropout.elu_dropout_fwd_launches,
                elu_dropout.elu_dropout_bwd_launches)
    peak = torch.cuda.max_memory_allocated()
    steps = recorder.steps
    batch = int(cfg["training"]["batch_size"])
    log(f"[7] cvbae training, {TRAIN_STEPS} steps at full width through "
        f"bdvs-train-torch's main: {wall:.1f} s in all; VUNet "
        f"{out['n_params']:,} parameters")
    for r in steps:
        log(f"    step {r['step']}: loss {r['loss']:.6g} (likelihood "
            f"{r['likelihood_loss']:.6g}, kl {r['kl_loss']:.6g}, gamma "
            f"{r['gamma']:.3g}, loss_reg {r['loss_reg']:.4g}, grad_norm "
            f"{r['grad_norm']:.4g}); {r['ms']:.2f} ms; data "
            + ("-" if r["data_ms"] is None else f"{r['data_ms']:.2f}")
            + f" ms; launches fwd {r['fwd_launches']} bwd "
            f"{r['bwd_launches']}")
    accum = int(cfg["training"].get("grad_accum", 1))
    per_step = DROPOUT_SITES * accum
    per_step_bwd = (DROPOUT_SITES - DEAD_BACKWARD_SITES) * accum
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} training steps")
    check(all(np.isfinite(r[k]) for r in steps
              for k in ("loss", "likelihood_loss", "kl_loss", "grad_norm")),
          "a training step's loss is not finite")
    check(all(r["fwd_launches"] == per_step
              and r["bwd_launches"] == per_step_bwd for r in steps),
          f"a training step did not launch the ELU+dropout kernels "
          f"{per_step} (forward) and {per_step_bwd} (backward) times")
    check(launches == (per_step * TRAIN_STEPS, per_step_bwd * TRAIN_STEPS),
          f"ELU+dropout launches {launches}")
    check(steps[-1]["gamma"] >= 0 and any(r["kl_loss"] > 0 for r in steps),
          "the KL term never opened")
    step_ms = float(np.median([r["ms"] for r in steps[1:]]))
    data_ms = float(np.median([r["data_ms"] for r in steps[1:]]))
    log(f"    median step after the first {step_ms:.2f} ms, "
        f"{batch * 1e3 / step_ms:.1f} img/s; median host data time "
        f"{data_ms:.2f} ms a step; peak memory {peak / 2**30:.2f} GiB")
    shapes = site_shapes(recorder)
    check(len(shapes["fwd"]) == per_step and len(shapes["bwd"])
          == per_step_bwd, f"sites in one step: {shapes}")
    bound_ms = per_step_bound_ms(shapes)
    elems = sum(n for n, _ in shapes["fwd"])
    prof = profile_step(recorder, step_ms)
    if prof is None:
        log(f"    ELU+dropout per step: {per_step} sites, {elems:,} "
            f"elements, bound {bound_ms:.3f} ms; profiler: no device time "
            f"seen, so kernel time and idle share not measured")
    else:
        log(f"    ELU+dropout per step: {per_step} sites, {elems:,} "
            f"elements; device time (profiler) fwd "
            f"{prof['elu_dropout_ms']['fwd']:.3f} ms in "
            f"{prof['elu_dropout_launches']['fwd']} launches + bwd "
            f"{prof['elu_dropout_ms']['bwd']:.3f} ms in "
            f"{prof['elu_dropout_launches']['bwd']}; bound {bound_ms:.3f} ms")
        log(f"    profiled step: wall {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['device_busy_ms']:.2f} ms, idle share "
            f"{prof['idle_share']:.3f} ({prof['idle_share_unprofiled']:.3f} "
            f"of the unprofiled median step); top kernels (ms, calls):")
        for name, ms, count in prof["top"]:
            log(f"      {ms:9.3f} {count:5d}  {name}")
    RESULTS["train"] = dict(
        steps=steps, step_ms_median=step_ms, img_per_s=batch * 1e3 / step_ms,
        data_ms_median=data_ms, peak_gib=peak / 2**30, wall_s=wall,
        launches=list(launches), sites=per_step, site_elements=elems,
        kernel_bound_ms_per_step=bound_ms, profile=prof,
        vunet_params=out["n_params"])
    serve_trained(out["synth_params"])
    return launches


def serve_trained(synth_params):
    """The run's synth.npz, strictly into a serving VUNet, and one
    transfer_cached call."""
    tree, cfg = cli._load_params(synth_params)
    vunet = vunet_from_config(cfg, "alter", dtype=torch.bfloat16,
                              remat=False, device=DEV).eval()
    vunet.load_state_dict(convert.vunet_alter_from_flax(tree["vunet"]),
                          strict=True)
    S = vunet.spatial_size
    g = torch.Generator(device=DEV).manual_seed(3)
    app = torch.rand(2, S, S, 3, generator=g, device=DEV) * 2 - 1
    stick = torch.rand(2, S, S, 3, generator=g, device=DEV) * 2 - 1
    with torch.inference_mode():
        means, _ = vunet.encode_means(app, generator=g)
        frames = vunet.transfer_cached(means, stick)
    check(frames.shape == (2, S, S, 3)
          and bool(torch.isfinite(frames.float()).all()),
          "the trained synth.npz does not serve")
    log(f"    synth.npz loaded strictly and served: frames "
        f"{tuple(frames.shape)}, mean |frame| "
        f"{float(frames.float().abs().mean()):.4f}")


# -- 8. the training step against the JAX package's golden -------------------
def phase_train_golden():
    with np.load(TRAIN_GOLDEN) as data:
        g = unflatten_tree({k: data[k] for k in data.files})
    cfg = json.loads(bytes(g["config"]).decode())
    tr, arch = cfg["training"], cfg["architecture"]
    S = int(cfg["data"]["spatial_size"])
    vunet = vunet_from_config(cfg, "alter", device=DEV)
    vunet.load_state_dict(convert.vunet_alter_from_flax(
        g["params"]["vunet"]))
    reg = g["params"]["regressor"]
    n_linear = sum(1 for k in reg if k.startswith("Dense_"))
    regressor = VunetRegressor(
        reg[f"Dense_{n_linear - 1}"]["bias"].shape[0],
        latent_widths(S, n_latent_scales=int(arch["n_latent_scales"])),
        nf_max=int(arch["nf_max"]), n_linear=n_linear, device=DEV)
    regressor.load_state_dict(convert.vunet_regressor_from_flax(reg))
    vunet.train()
    step = make_cvbae_train_step(
        vunet, regressor, LaplacianPyramidFeatures(),
        make_vunet_optimizers(vunet, regressor, tr), cfg)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in g["batch"].items()}
    B, R = batch["pose_img"].shape[0], batch["reg_imgs"].shape[1]
    noise = [torch.from_numpy(g["noise"][str(B)][str(i)]).to(DEV)
             for i in range(len(g["noise"][str(B)]))]
    state = VunetTrainState(gamma=torch.zeros((), device=DEV))
    worst = {}
    for i in sorted(g["metrics"]):
        m = step(state, batch, eps=[noise], reg_eps=[noise] * R)
        for k, ref in g["metrics"][i].items():
            ref = float(ref)
            err = abs(float(m[k]) - ref)
            tol = 1e-4 * abs(ref) + (1e-5 if k == "loss" else 0.0)
            worst[k] = max(worst.get(k, 0.0), err / tol if tol else err)
    after = {"vunet": convert.vunet_alter_to_flax(vunet.state_dict()),
             "regressor": convert.vunet_regressor_to_flax(
                 regressor.state_dict())}
    ref_after = flatten_tree(g["after"])
    d_params = max(float(np.abs(v - ref_after[k]).max())
                   for k, v in flatten_tree(after).items())
    log(f"[8] golden cvbae step x{len(g['metrics'])} (f32, TF32 off): worst "
        f"metric error / tolerance " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(worst.items()))
        + f"; max |param - JAX| after Adam {d_params:.2e} (<= 1e-4)")
    RESULTS["golden_train"] = dict(err_over_tol=worst, params=d_params)
    check(all(v <= 1.0 for k, v in worst.items())
          and d_params <= 1e-4, "golden training step out of tolerance")


# -- 9. org-VUNet serving at full width ---------------------------------------
def phase_org():
    pipe, g, counts = full_width_slice("org")
    B, T, S = SLICE["B"], SLICE["T"], SLICE["S"]
    app = (S // 4, S // 4, 30)
    log(f"[9] org-VUNet serving (configs/vunet.yaml, appearance "
        f"{app}): parameters {counts}")
    x = request_inputs(B, g, app)
    vunets = {"cudnn": pipe.vunet,
              "fused": with_rnb_impl(pipe.vunet, "org", "fused")}
    frames, launches, rows = {}, None, []
    for impl, vunet in vunets.items():
        pipe.vunet = vunet
        if impl == "fused":
            fused_rnb.fused_rnb_launches = 0   # counts start here: the
        for note in ("warm-up", "timed", "timed"):   # org main path
            before = fused_rnb.fused_rnb_launches
            out, ms, peak = serve(pipe, x)
            n = fused_rnb.fused_rnb_launches - before
            check(out["frames"].shape == (B, T, S, S, 3)
                  and bool(torch.isfinite(out["frames"].float()).all()),
                  f"org {impl} request: frames")
            check(n == (ORG_RNB_LAUNCHES if impl == "fused" else 0),
                  f"the org {impl} request launched the fused RNB kernel "
                  f"{n} times")
            log(f"    generate B={B} T={T} rnb_impl={impl:5s}: {ms:9.2f} ms, "
                f"{B * T * 1e3 / ms:8.1f} frames/s, peak "
                f"{peak / 2**30:.2f} GiB, {n} fused RNB launches  {note}")
            rows.append(dict(rnb_impl=impl, ms=ms, fps=B * T * 1e3 / ms,
                             peak_gib=peak / 2**30, launches=n, note=note))
        if impl == "fused":
            launches = fused_rnb.fused_rnb_launches
        frames[impl] = out["frames"]
    # the same request with the fused blocks' plain version
    launch = ops_nn.fused_rnb
    ops_nn.fused_rnb = fused_rnb.fused_rnb_plain
    try:
        plain, _, _ = serve(pipe, x)
    finally:
        ops_nn.fused_rnb = launch
    rel_plain = rel_l2(frames["fused"], plain["frames"])
    rel_cudnn = rel_l2(frames["fused"], frames["cudnn"])
    log(f"    fused route vs its plain version: rel-L2 {rel_plain:.3e} "
        f"(<= 2e-2); vs the cudnn route {rel_cudnn:.3e} (reported)")
    check(rel_plain <= 2e-2, "org fused route disagrees with the plain "
          "version of its blocks")
    RESULTS["org_requests"] = rows
    RESULTS["org_rel_l2"] = dict(fused_vs_plain=rel_plain,
                                 fused_vs_cudnn=rel_cudnn)
    for impl, vunet in vunets.items():
        pipe.vunet = vunet
        stage_breakdown(pipe, x, g, f"org_stages_ms_{impl}")
    # one test_forward chunk: the autoregressive prior runs for real
    cs, _ = pipe._chunk_size(B * T)
    stick = plain["stickman"].reshape((B * T, S, S, 3))[:cs]
    with torch.inference_mode():
        before = fused_rnb.fused_rnb_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample = vunets["fused"].test_forward(stick, generator=g)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = fused_rnb.fused_rnb_launches - before
    check(sample.shape == (cs, S, S, 3)
          and bool(torch.isfinite(sample.float()).all())
          and n == ORG_PRIOR_RNB_LAUNCHES,
          f"org test_forward: shape {tuple(sample.shape)}, {n} launches")
    log(f"    test_forward, {cs} frames, rnb_impl=fused: {ms:.2f} ms, {n} "
        f"fused RNB launches")
    RESULTS["org_test_forward"] = dict(frames=cs, ms=ms, launches=n)
    return launches


# -- 10. behavior_net training at full width ----------------------------------
class BehaviorRecorder:
    """Wraps the cVAE and flow steps that ``experiments/behavior_net.py``
    makes: each step runs between two ``torch.cuda.synchronize()`` calls
    and is recorded with its metrics; the last call of each stage is kept
    for the profiler."""

    def __init__(self):
        self.steps = {"cvae": [], "flow": []}
        self.last = {}
        self._made = {}

    def install(self):
        for name, stage in (("make_behavior_train_step", "cvae"),
                            ("make_flow_train_step", "flow")):
            self._made[name] = make = getattr(behavior_net, name)
            setattr(behavior_net, name, self._wrap(make, stage))

    def uninstall(self):
        for name, make in self._made.items():
            setattr(behavior_net, name, make)

    def _wrap(self, make, stage):
        def recorded_make(*args, **kwargs):
            step = make(*args, **kwargs)

            def recorded(state, *a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = step(state, *a, **kw)
                torch.cuda.synchronize()
                self.steps[stage].append(dict(
                    step=state.step, ms=(time.perf_counter() - t0) * 1e3,
                    **{k: float(v.float().mean())
                       for k, v in metrics.items()}))
                self.last[stage] = (step, state, a, kw)
                return metrics
            return recorded
        return recorded_make


def profile_call(fn, wall_ms_of=None, top_n=5):
    """Device busy time, idle share and the top kernels of one call of fn
    under torch.profiler (None where it saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        return None
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:top_n]
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               busy_share=min(1.0, busy_ms / wall_ms),
               top=[(e.key[:90], e.self_device_time_total / 1e3, e.count)
                    for e in top])
    if wall_ms_of:
        out["busy_share_unprofiled"] = min(1.0, busy_ms / wall_ms_of)
    return out


def profile_stages(recorder, median_ms):
    """One more step of each stage, profiled, after the run; the
    recorder's references to the run's state go with it."""
    profiles = {}
    for stage, ms in median_ms.items():
        step, state, a, kw = recorder.last.pop(stage)
        prof = profile_call(lambda: step(state, *a, **kw), ms)
        profiles[stage] = prof
        if prof is None:
            log(f"    profiled {stage} step: no device time seen; busy "
                f"share not measured")
            continue
        log(f"    profiled {stage} step: wall {prof['wall_ms']:.2f} ms, "
            f"device busy {prof['device_busy_ms']:.2f} ms, busy share "
            f"{prof['busy_share']:.3f} ({prof['busy_share_unprofiled']:.3f} "
            f"of the unprofiled median step); top kernels (ms, calls):")
        for name, kms, count in prof["top"]:
            log(f"      {kms:9.3f} {count:5d}  {name}")
    return profiles


def behavior_config(base_dir):
    cfg = load_config(BEHAVIOR_CONFIG)
    return deep_merge(cfg, {"general": {"base_dir": base_dir}})


def metric_lines(run_dir):
    with open(os.path.join(run_dir, "log", "debug", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_behavior():
    base = tempfile.mkdtemp(prefix="chip_smoke_behavior_")
    path = os.path.join(base, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(behavior_config(base), f)
    recorder = BehaviorRecorder()
    recorder.install()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = train_cli.main(["-c", path, "--device", "cuda", "--debug"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        steps = recorder.steps
        batch = int(behavior_config(base)["training"]["batch_size"])
        n_params = out["n_params"]
        log(f"[10] behavior_net training at full width (configs/"
            f"behavior_net.yaml, --debug) through bdvs-train-torch's main: "
            f"{len(steps['cvae'])} cVAE and {len(steps['flow'])} flow steps "
            f"in {wall:.1f} s; parameters {n_params}")
        check(len(steps["cvae"]) == BEHAVIOR_STEPS
              and len(steps["flow"]) == BEHAVIOR_FLOW_STEPS,
              f"steps {[len(v) for v in steps.values()]}")
        check(all(np.isfinite(v) for r in steps["cvae"] + steps["flow"]
                  for v in r.values()), "a behavior step metric is not "
              "finite")
        for stage in ("cvae", "flow"):
            for r in steps[stage][:2] + steps[stage][-1:]:
                log(f"    {stage} step {r['step']}: {r['ms']:.2f} ms; "
                    + ", ".join(f"{k} {v:.5g}" for k, v in r.items()
                                if k not in ("step", "ms")))
        cvae_ms = float(np.median([r["ms"] for r in steps["cvae"][1:]]))
        flow_ms = float(np.median([r["ms"] for r in steps["flow"][1:]]))
        log(f"    median cVAE step after the first {cvae_ms:.2f} ms, "
            f"{batch * 1e3 / cvae_ms:.1f} sequences/s; median flow step "
            f"after the first {flow_ms:.2f} ms; peak memory "
            f"{peak / 2**30:.2f} GiB")
        run_dir = os.path.join(base, "behavior_net")
        lines = metric_lines(run_dir)
        prefixes = {p: sum(any(k.startswith(p) for k in r) for r in lines)
                    for p in ("train/", "eval/", "flow/")}
        check(all(prefixes.values()) and all(
            np.isfinite(v) for r in lines for v in r.values()),
            f"metrics.jsonl lines {prefixes}")
        log(f"    metrics.jsonl: {prefixes}; last flow line "
            + json.dumps({k: round(v, 5) for k, v in lines[-1].items()}))
        profiles = profile_stages(recorder, {"cvae": cvae_ms,
                                             "flow": flow_ms})
        behavior_params = out["behavior_params"]
        n_lines = len(metric_lines(run_dir))
    finally:
        recorder.uninstall()
    del out
    # a second main with -r: the run is finished, so no step runs
    recorder = BehaviorRecorder()
    recorder.install()
    try:
        again = train_cli.main(["-c", path, "--device", "cuda", "--debug",
                                "-r"])
    finally:
        recorder.uninstall()
    reruns = {k: len(v) for k, v in recorder.steps.items()}
    check(reruns == {"cvae": 0, "flow": 0}
          and again["state"].step == BEHAVIOR_STEPS
          and again["flow_state"].step == BEHAVIOR_FLOW_STEPS
          and len(metric_lines(run_dir)) == n_lines,
          f"-r after the run re-ran steps {reruns}")
    log(f"    -r after the run: restored cVAE step {again['state'].step} and "
        f"flow step {again['flow_state'].step}; steps run {reruns}")
    del again
    gc.collect()
    torch.cuda.empty_cache()
    launches, served = serve_behavior(behavior_params)
    RESULTS["behavior_train"] = dict(
        cvae_steps=steps["cvae"], flow_steps=steps["flow"],
        cvae_step_ms_median=cvae_ms, sequences_per_s=batch * 1e3 / cvae_ms,
        flow_step_ms_median=flow_ms, peak_gib=peak / 2**30, wall_s=wall,
        n_params=n_params, profile=profiles, metric_lines=prefixes,
        restart_steps=reruns, served=served)
    shutil.rmtree(base, ignore_errors=True)
    return launches


def serve_behavior(behavior_params):
    """The trained behavior.npz behind phase 4's alter VUNet: one B=20,
    T=50 sample request, which must launch the rollout kernel once and
    whose rollout must match the decoder's plain f32 loop on the kernel's
    bf16 operands, at phase 3's tolerance."""
    tree, bcfg = cli._load_params(behavior_params)
    arch, data = bcfg["architecture"], bcfg["data"]
    K, HID = int(data["n_kps"]), int(arch["dim_hidden_b"])
    net = ResidualBehaviorNet(K, HID, device=DEV).eval()
    net.load_state_dict(convert.behavior_net_from_flax(tree["net"]))
    flow = LatentFlow(HID, HID * int(arch.get("flow_mid_channels_factor", 2)),
                      int(arch.get("flow_hidden_depth", 2)),
                      int(arch.get("n_flows", 15)), device=DEV).eval()
    flow.load_state_dict(convert.latent_flow_from_flax(tree["flow"]))
    del tree
    g = torch.Generator(device=DEV).manual_seed(5)
    vunet = on_device(serving_vunet("alter"), g)
    pipe = BehaviorTransferPipeline(
        net, vunet, detailed_joint_model(world_coords=True),
        np.zeros(K, np.float32), np.ones(K, np.float32), np.arange(K),
        spatial_size=SLICE["S"], flow_model=flow)
    B, T, S = SLICE["B"], SLICE["T"], SLICE["S"]
    x = request_inputs(B, g)
    loader, _ = build_sequence_data(load_config(BEHAVIOR_CONFIG), "test")
    x["x_start"] = torch.from_numpy(
        next(iter(loader))["keypoints"][:B, 0]).to(DEV)
    rollout.rollout_launches = 0          # counts start here: the trained
    out, ms, peak = serve(pipe, x)        # model's request
    launches = rollout.rollout_launches
    check(out["frames"].shape == (B, T, S, S, 3)
          and bool(torch.isfinite(out["frames"].float()).all()),
          "the trained behavior.npz request: frames")
    check(launches == 1, f"the trained behavior.npz request launched the "
          f"rollout kernel {launches} times")
    xs = out["poses_3d"].reshape(B, T, K)    # mean 0, std 1: xs itself
    d = net.decoder
    with torch.inference_mode():
        b = flow.reverse(x["z"])
        ref, _ = d(b, x["x_start"], T)
        r = d.rnn
        ref_bf16 = rollout.residual_lstm_rollout_plain(
            b, x["x_start"], r.weight_ih, r.weight_hh, r.bias_ih, r.bias_hh,
            d.n_out.weight, d.n_out.bias, T, operand_dtype=torch.bfloat16)
    err = float((xs - ref).abs().max())
    err_bf16 = float((xs - ref_bf16).abs().max())
    log(f"    served the trained behavior.npz (K={K}, flow on): B={B} T={T} "
        f"{ms:.2f} ms, {B * T * 1e3 / ms:.1f} frames/s, peak "
        f"{peak / 2**30:.2f} GiB, {launches} rollout launch; rollout vs the "
        f"decoder's plain f32 loop on its bf16 operands {err_bf16:.2e} "
        f"(atol 1e-2, rtol 1e-2, as in [3]); on its f32 weights {err:.2e} "
        f"(reported)")
    check(torch.allclose(xs, ref_bf16, atol=1e-2, rtol=1e-2),
          "the trained decoder's kernel rollout disagrees with its plain "
          "loop")
    return launches, dict(ms=ms, fps=B * T * 1e3 / ms, peak_gib=peak / 2**30,
                          launches=launches, err_plain_bf16=err_bf16,
                          err_plain_f32=err)


# -- 11. the behavior steps against the JAX package's golden ------------------
def phase_behavior_golden():
    with np.load(BEHAVIOR_GOLDEN) as data:
        g = unflatten_tree({k: data[k] for k in data.files})
    cfg = json.loads(bytes(g["config"]).decode())
    d, arch, tr = cfg["data"], cfg["architecture"], cfg["training"]
    K, A, T = int(d["n_kps"]), int(d["n_actions"]), int(d["seq_length"][0])
    H, p = int(arch["dim_hidden_b"]), g["params"]
    modules = {
        "net": ResidualBehaviorNet(K, H, device=DEV),
        "regressor": RegressorFly(H, K, T, device=DEV),
        "cls_action": ClassifierAction(
            K, A, dim=p["cls_action"]["LSTM_0"]["w_hh"].shape[0],
            device=DEV),
        "cls_action2": SequenceDiscMichael(K, T - 1, out_dim=A, device=DEV),
        "cls_beta": ClassifierActionBeta(H, A, device=DEV)}
    flow = LatentFlow(H, 2 * H, 2, int(arch["n_flows"]), device=DEV)
    names = {"net": "behavior_net", "regressor": "regressor_fly",
             "cls_action": "classifier_action",
             "cls_action2": "sequence_disc_michael",
             "cls_beta": "classifier_action_beta", "flow": "latent_flow"}
    for name, m in dict(modules, flow=flow).items():
        m.load_state_dict(getattr(convert, f"{names[name]}_from_flax")(
            p[name]))
    n_steps = len(g["metrics"]["cvae"])
    state = BehaviorTrainState(
        modules, make_behavior_optimizers(modules, tr, n_steps),
        gamma=torch.zeros((), device=DEV))
    fstate = FlowTrainState(flow, make_flow_optimizer(flow, tr))

    def dev(a):
        return torch.as_tensor(a, device=DEV)
    batch = {k: dev(v) for k, v in g["batch"].items()}
    step = make_behavior_train_step(cfg, T, total_steps=n_steps)
    fstep = make_flow_train_step(modules["net"])
    worst = {}
    for stage in ("cvae", "flow"):
        for i in range(n_steps):
            dr = g["draws"][stage][str(i)]
            if stage == "cvae":
                m = step(state, batch, True, draws=StepDraws(
                    dev(dr["t_adv"]), [dev(t) for t in dr["t_reg"]],
                    dev(dr["eps"])))
            else:
                m = fstep(fstate, batch, eps=dev(dr["eps"]))
            for k, ref in g["metrics"][stage][str(i)].items():
                err = float((m[k].cpu() - torch.from_numpy(ref)).abs().max())
                tol = float(1e-4 * np.abs(ref).max()) + (
                    1e-5 if k in ("loss", "flow_loss") else 0.0)
                key = f"{stage}/{k}"
                worst[key] = max(worst.get(key, 0.0),
                                 err / tol if tol else err)
    after = {n: getattr(convert, f"{names[n]}_to_flax")(
        m.state_dict()) for n, m in dict(modules, flow=flow).items()}
    ref_after = flatten_tree(g["after"])
    d_params = max(float(np.abs(v - ref_after[k]).max())
                   for k, v in flatten_tree(after).items())
    bad = {k: v for k, v in worst.items() if v > 1.0}
    log(f"[11] golden behavior_net steps, {n_steps} cVAE + {n_steps} flow "
        f"(f32, TF32 off): worst metric error / tolerance "
        f"{max(worst.values()):.3f} over {len(worst)} metrics"
        f"{' ' + str(bad) if bad else ''}; max |param - JAX| of all six "
        f"modules {d_params:.2e} (<= 1e-4)")
    RESULTS["golden_behavior"] = dict(err_over_tol=worst, params=d_params)
    check(not bad and d_params <= 1e-4,
          "golden behavior_net steps out of tolerance")


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
    disable_tf32()
    name = phase_card()
    phase_build()
    max_err, ms, plain_ms = phase_kernel()
    elu = phase_elu_dropout()
    rnb = phase_fused_rnb()
    launches = phase_slice()
    phase_cli()
    phase_golden()
    phase_org_golden()
    elu_launches = phase_train()
    phase_train_golden()
    rnb_launches = phase_org()
    launches += phase_behavior()
    phase_behavior_golden()
    bound, bound_by = rollout_bound_ms(*ROLLOUT_SHAPES[0])
    source = "behavior_driven_video_synthesis_tpu_torch/csrc/"
    pallas = "behavior_driven_video_synthesis_tpu/ops/pallas/"
    kernels = {"kernels": [{
        "name": "residual_lstm_rollout", "route": "cuda",
        "source": source + "rollout.cu", "replaces": pallas + "rollout.py:26",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None}] + [{
            "name": f"elu_dropout_{d}", "route": "cuda",
            "source": source + "elu_dropout.cu",
            "replaces": pallas + f"elu_dropout.py:{line}",
            "launches": n, **elu[d]}
        for d, line, n in (("fwd", 83, elu_launches[0]),
                           ("bwd", 95, elu_launches[1]))] + [{
            "name": "fused_rnb", "route": "cuda",
            "source": source + "fused_rnb.cu",
            "replaces": "attic/pallas_rnb.py:86",
            "launches": rnb_launches, **rnb}]}
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
