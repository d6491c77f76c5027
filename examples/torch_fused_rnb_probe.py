#!/usr/bin/env python3
"""Where the fused RNB kernel's time goes, on one NVIDIA GPU.

    python3 examples/torch_fused_rnb_probe.py [--out PATH]

Run it from the root of a checkout on a machine with a CUDA device and nvcc.
It builds ``csrc/fused_rnb.cu`` as it is and in variants made by text edits
of the source (each edit must apply), one nvcc per variant, all started
together, into ``build/fused_rnb_probe/``.  Ablations drop one phase of the
kernel (their outputs are wrong by design); candidates change the design
and are checked against the kernel's plain version.  Each variant is timed
with CUDA events at the org request's three largest sites on the same
inputs, in the order base, variant, variant, base, so that every
difference is read within one run.  The card's name and power limit and
every time go to standard output and to ``--out``
(``build/fused_rnb_probe.json`` by default).
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from behavior_driven_video_synthesis_tpu_torch.models.init import (  # noqa: E402
    init_random_)
from behavior_driven_video_synthesis_tpu_torch.ops import nn as ops_nn  # noqa: E402
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (  # noqa: E402
    fused_rnb)
from behavior_driven_video_synthesis_tpu_torch.ops.cuda.build import (  # noqa: E402
    CSRC, NVCC_FLAGS, _nvcc)

SITES = [(125, 256, 256, 32), (125, 128, 128, 64), (125, 64, 64, 128)]
KIND = {"ablation": "drops a phase (output wrong by design)",
        "candidate": "a design change (checked against the plain version)"}
# name: (kind, [(text in csrc/fused_rnb.cu, its replacement), ...])
VARIANTS = {
    "no_elu_math": ("ablation", [
        ("    *v = elu_bf16x8(raw);\n", "")]),
    "no_products": ("ablation", [
        ("        if (live) tap_products<CP>(acc, halo, wt, tap, row0, n0, "
         "lane);\n", ""),
        ("      if (live) resident_wgmma_products<CP>(acc, halo, taps, row0, "
         "lane);\n", "")]),
    "no_stores": ("ablation", [
        ("      if (c < C && oh < H && ow < W) {\n",
         "      if (c < 0) {\n")]),
    "no_halo_loads": ("ablation", [
        ("    if (P::kHaloBufs == 2 && next < ntiles) {",
         "    if (false) {"),
        ("    if (P::kHaloBufs == 1 && next < ntiles) {",
         "    if (false) {")]),
    "wgmma_unpipelined": ("candidate", [
        ("    if constexpr (P::kResident && P::kWgmma) {",
         "    if constexpr (false) {")]),
    "mma_sync": ("candidate", [
        ("  static constexpr bool kWgmma = CP == 64 || CP == 128;",
         "  static constexpr bool kWgmma = false;")]),
}
# variants that take W in the mma.sync layout at every C
MMA_SYNC_LAYOUT = ("mma_sync",)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def build(name, edits):
    src = (CSRC / "fused_rnb.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: edit does not apply once: "
                             f"{old!r}")
        src = src.replace(old, new)
    out = ROOT / "build" / "fused_rnb_probe" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "fused_rnb.cu").write_text(src)
    lib = out / "libfused_rnb.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib),
                           str(out / "fused_rnb.cu")],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise SystemExit(f"variant {name}: nvcc failed\n{proc.stderr}")
    regs = [line.split("Used ")[1].split(" registers")[0]
            for line in proc.stdout.splitlines() + proc.stderr.splitlines()
            if "Used " in line and " registers" in line]
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.bdvs_fused_rnb.argtypes = [p] * 4 + [i] * 4 + [p]
    dll.bdvs_fused_rnb.restype = i
    return dll, regs


def launcher(dll, x, operands, out):
    w, affine = operands
    B, H, W, C = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), w.data_ptr(), affine.data_ptr(), out.data_ptr(),
            B, H, W, C, stream)

    def run():
        err = dll.bdvs_fused_rnb(*args)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
    return run


def cuda_ms(fn, iters):
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "fused_rnb_probe.json"))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    limit = card()
    print(limit, flush=True)
    names = ["base"] + list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: build(n, VARIANTS[n][1] if n in VARIANTS else []),
            names)))
    for n in names:
        print(f"{n}: registers by instantiation (CP 128 first) "
              f"{built[n][1]}", flush=True)
    rng = np.random.RandomState(0)
    results = dict(card=limit, sites=[])
    for shape in SITES:
        C = shape[-1]
        block = init_random_(ops_nn.VunetRNB(C, dtype=torch.bfloat16), rng
                             ).to(dev).eval()
        g = torch.Generator(device=dev).manual_seed(1)
        x = (torch.randn(shape, generator=g, device=dev) * 0.5).bfloat16()
        with torch.inference_mode():
            operands = block.fused_operands()
            w, scale, shift = block.fused_weights()
            CP = fused_rnb.padded_channels(C)
            padded = torch.zeros(9, CP, CP + 8, dtype=torch.bfloat16,
                                 device=dev)
            padded[:, :C, :C] = w.bfloat16().permute(2, 3, 0, 1).reshape(
                9, C, C)
            ref = fused_rnb.fused_rnb_plain(x, w, scale, shift).float()
        row = dict(shape=list(shape), variants={})
        base_out = torch.empty_like(x)
        base = launcher(built["base"][0], x, operands, base_out)
        for n in names[1:]:
            out = torch.empty_like(x)
            run = launcher(built[n][0], x, (padded, operands[1])
                           if n in MMA_SYNC_LAYOUT else operands, out)
            order = [("base", base), (n, run), (n, run), ("base", base)]
            times = [(k, cuda_ms(fn, args.iters)) for k, fn in order]
            t_base = float(np.mean([t for k, t in times if k == "base"]))
            t_var = float(np.mean([t for k, t in times if k == n]))
            kind = VARIANTS[n][0]
            ok = None
            if kind == "candidate":
                ok = bool(torch.allclose(out.float(), ref, atol=1e-2,
                                         rtol=1e-2))
            row["variants"][n] = dict(kind=kind, base_ms=t_base, ms=t_var,
                                      saved_ms=t_base - t_var, agrees=ok)
            print(f"{tuple(shape)} {n:22s} ({kind}): base {t_base:.4f} ms, "
                  f"variant {t_var:.4f} ms, {t_base - t_var:+.4f} ms saved"
                  + ("" if ok is None else
                     f"; agrees with plain: {ok}"), flush=True)
        base()
        torch.cuda.synchronize()
        row["base_agrees"] = bool(torch.allclose(base_out.float(), ref,
                                                 atol=1e-2, rtol=1e-2))
        results["sites"].append(row)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
