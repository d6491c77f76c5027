#!/usr/bin/env python3
"""Where the int8 conv kernel's time goes, on one NVIDIA GPU.

    python3 examples/torch_conv_int8_probe.py [--out PATH] [--variants a,b]

Run it from the root of a checkout on a machine with a CUDA device and nvcc.
It builds ``csrc/conv_int8.cu`` as it is and in variants made by text edits
of the source (each edit must apply), one nvcc per variant, all started
together, into ``build/conv_int8_probe/``.  Ablations drop one phase of the
kernel (their outputs are wrong by design); candidates change the design
and are checked against the kernel's plain version.  Each variant is timed
with CUDA events at four of the VUNet's int8 sites (a 125-frame chunk,
bf16, the NormConv2d call with bias and affine) on the same inputs, in the
order base, variant, variant, base, so that every difference is read within
one run.  The card's name and power limit and every time go to standard
output and to ``--out`` (``build/conv_int8_probe.json`` by default).
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (  # noqa: E402
    conv_int8 as CI)
from behavior_driven_video_synthesis_tpu_torch.ops.cuda.build import (  # noqa: E402
    CSRC, NVCC_FLAGS, _nvcc)

# (frames, H, W, Cin, Cout, stride, aux Cin)
SITES = [(125, 128, 128, 64, 64, 1, 0), (125, 64, 64, 128, 128, 1, 0),
         (125, 256, 256, 32, 32, 1, 0), (125, 128, 128, 64, 128, 1, 0),
         (125, 256, 256, 32, 64, 2, 0), (125, 128, 128, 64, 64, 1, 64)]
KIND = {"ablation": "drops a phase (output wrong by design)",
        "candidate": "a design change (checked against the plain version)"}
# name: (kind, [(text in csrc/conv_int8.cu, its replacement), ...])
VARIANTS = {
    "no_mma": ("ablation", [
        ("      for (int nt = 0; nt < kNT; ++nt) mma_s8(acc[i][nt], af[i], "
         "bfr[nt]);", "      for (int nt = 0; nt < kNT; ++nt) "
         "acc[i][nt][0] += af[i][0] ^ bfr[nt][0];")]),
    "no_products": ("ablation", [
        ("    mma_chunk<Cfg<NP>::kTapUnroll>(acc, qa,",
         "    if (a.N < 0) mma_chunk<Cfg<NP>::kTapUnroll>(acc, qa,")]),
    "no_quantize": ("ablation", [
        ("      if (a.bf16)\n        quantize<__nv_bfloat16, NTHR>",
         "      if (false)\n        quantize<__nv_bfloat16, NTHR>"),
        ("      else\n        quantize<float, NTHR>",
         "      else if (false)\n        quantize<float, NTHR>")]),
    "no_stores": ("ablation", [
        ("            *reinterpret_cast<uint4*>(dst) = make_uint4(y[0], y[1], "
         "y[2], y[3]);", "            if (a.N < 0) *reinterpret_cast<uint4*>"
         "(dst) = make_uint4(y[0], y[1], y[2], y[3]);")]),
    "no_halo_loads": ("ablation", [
        ("    if (p == 0) {\n      if (a.bf16)\n        issue_raw",
         "    if (false) {\n      if (a.bf16)\n        issue_raw")]),
    "no_epilogue": ("ablation", [
        ("    epilogue_after(a, acc, c, p * NP + wn * kWN, b0, oh0, ow0, par, "
         "mpix,\n", "    if (a.N < 0) epilogue_after(a, acc, c, p * NP + "
         "wn * kWN, b0, oh0, ow0, par, mpix,\n")]),
}


def variant_source(edits):
    src = (CSRC / "conv_int8.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"edit does not apply: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(name, src, out_dir):
    cu = out_dir / f"{name}.cu"
    cu.write_text(src)
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    return lib


def load(path):
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bdvs_conv_int8.argtypes = [p, p, i] + [p] * 11 + [i] * 9 + [p]
    lib.bdvs_conv_int8.restype = i
    lib.bdvs_conv_int8_plan.argtypes = [i] * 11 + [p]
    lib.bdvs_conv_int8_plan.restype = i
    return lib


def site_inputs(site, seed=0):
    B, H, W, C, N, stride, Ca = site
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(B, H, W, C, generator=g, device="cuda") * 2).to(
        torch.bfloat16)
    w_q, aw = CI.quantize_weight(torch.randn(N, C, 3, 3, generator=g,
                                             device="cuda"))
    kw = dict(bias=torch.randn(N, generator=g, device="cuda"),
              stride=stride, gamma=torch.randn(N, generator=g, device="cuda"),
              beta=torch.randn(N, generator=g, device="cuda"))
    plain = dict(kw, w_q=w_q, aw=aw)
    if Ca:
        a = (torch.randn(B, H, W, Ca, generator=g, device="cuda") * 2).to(
            torch.bfloat16)
        aq, aa = CI.quantize_weight(torch.randn(N, Ca, 3, 3, generator=g,
                                                device="cuda"))
        kw.update(aux=a, aux_packed=CI.pack_weights(aq, aa),
                  ax_aux=CI.act_scale(a))
        plain.update(aux=a, aux_w_q=aq, aux_aw=aa, ax_aux=kw["ax_aux"])
    return x, CI.pack_weights(w_q, aw), CI.act_scale(x), kw, plain


def timed(lib, x, packed, ax, kw, iters=20):
    CI._lib = lambda: lib

    def fn():
        return CI.conv_int8_packed(x, packed, ax, **kw)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "conv_int8_probe.json"))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--sites", default="",
                    help="indices into SITES to time (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    names = [v for v in args.variants.split(",") if v]
    out_dir = ROOT / "build" / "conv_int8_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {"base": variant_source([])}
    srcs.update({n: variant_source(VARIANTS[n][1]) for n in names})
    with ThreadPoolExecutor(len(srcs)) as pool:
        paths = dict(zip(srcs, pool.map(lambda n: build(n, srcs[n], out_dir),
                                        srcs)))
    libs = {n: load(p) for n, p in paths.items()}
    real_lib = CI._lib
    results = {"card": card, "sites": []}
    try:
        picked = ([SITES[int(i)] for i in args.sites.split(",")]
                  if args.sites else SITES)
        for site in picked:
            x, packed, ax, kw, plain = site_inputs(site)
            row = {"site": list(site), "variants": {}}
            for n in names:
                kind = VARIANTS[n][0]
                t = [timed(libs["base"], x, packed, ax, kw),
                     timed(libs[n], x, packed, ax, kw),
                     timed(libs[n], x, packed, ax, kw),
                     timed(libs["base"], x, packed, ax, kw)]
                entry = {"kind": kind, "ms": t}
                if kind == "candidate":
                    CI._lib = lambda: libs[n]
                    y = CI.conv_int8_packed(x, packed, ax, **kw)
                    ref = CI.conv_int8_plain(x, ax=ax, **plain)
                    entry["max_abs_err"] = float((y.float() - ref.float())
                                                 .abs().max())
                row["variants"][n] = entry
                print(f"{site} {n:14s} ({kind}): base {t[0]:.4f}, variant "
                      f"{t[1]:.4f}, {t[2]:.4f}, base {t[3]:.4f} ms"
                      + (f", max|err| {entry['max_abs_err']:.3e}"
                         if "max_abs_err" in entry else ""), flush=True)
            results["sites"].append(row)
            del x, packed, kw, plain
            torch.cuda.empty_cache()
    finally:
        CI._lib = real_lib
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
