#!/usr/bin/env python3
"""Where the ELU+dropout kernels' time goes, on one NVIDIA GPU.

    python3 examples/torch_elu_dropout_probe.py [--out PATH] [--variants a,b]
        [--parent DIR]

Run it from the root of a checkout on a machine with a CUDA device and nvcc.
It builds ``csrc/elu_dropout.cu`` as it is ("base") and in variants, one
nvcc per variant, all started together, into ``build/elu_dropout_probe/``:
text edits of the source (each edit must apply), the other designs of
``examples/elu_dropout_designs.cu`` spliced in for its kernel, and, with
``--parent``, the ``csrc/elu_dropout.cu`` of another checkout as it is
("parent") and with this source's bf16 math ("parent_fast").  Ablations
(the knock-out split) drop a phase of the kernel: their outputs are wrong
by design.  Candidates change the design and are checked against the plain
version (zero patterns equal, the largest difference reported).  Each
variant is timed with CUDA events at the cvbae step's largest dropout site,
(12, 256, 256, 32) bf16 at rate 0.05, forward at element offsets 0 and
n + 1 and backward at offset 0, on the same inputs, in the order base,
variant, variant, base, so that every difference is read within one run.
A device copy of x (``torch.Tensor.copy_``) is timed beside them as the
card's reachable rate for the forward's bytes.  The card's name and power
limit, each variant's registers (and spilled bytes), its SASS opcode
counts (``cuobjdump -sass``) and every time go to standard output and to
``--out`` (``build/elu_dropout_probe.json`` by default).
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (  # noqa: E402
    elu_dropout as E)
from behavior_driven_video_synthesis_tpu_torch.ops.cuda.build import (  # noqa: E402
    CSRC, NVCC_FLAGS, _nvcc)

SHAPE, RATE = (12, 256, 256, 32), 0.05
NO_PHILOX = ("  for (int r = 0; r < 10; ++r) {",
             "  for (int r = 0; r < 0; ++r) {")
NO_ELU = ("    const float e = x > 0.f ? x : (kFast ? expm1_bf16(x) : "
          "expm1f(x));", "    const float e = x;")
# the backward keeps reading x (a select on its sign), so that its bytes stay
NO_EXP = ("    const float de = x > 0.f ? 1.f : (kFast ? exp_bf16(x) : "
          "expf(x));", "    const float de = x > 0.f ? 1.f : 0.5f;")


def const(name, old, new):
    return (f"constexpr {name} = {old};", f"constexpr {name} = {new};")


WIDE_PTX = (
    "  hi = __umulhi(m, a);\n  lo = m * a;",
    "  unsigned long long p;\n  asm(\"mul.wide.u32 %0, %1, %2;\" : "
    "\"=l\"(p) : \"r\"(m), \"r\"(a));\n  hi = static_cast<uint32_t>"
    "(p >> 32);\n  lo = static_cast<uint32_t>(p);")
# name: (kind, [(text in csrc/elu_dropout.cu, its replacement), ...])
VARIANTS = {
    "no_philox": ("ablation", [NO_PHILOX]),
    "no_elu": ("ablation", [NO_ELU, NO_EXP]),
    "copy_only": ("ablation", [
        NO_PHILOX, NO_ELU, NO_EXP,
        ("    return keep ? e * scale : 0.f;", "    return e;"),
        ("    return keep ? (ct * scale) * de : 0.f;", "    return x + ct;")]),
    "libm_math": ("candidate", [
        const("bool kFastMath", "sizeof(T) == 2", "false")]),
    "wide64": ("candidate", [(
        "  hi = __umulhi(m, a);\n  lo = m * a;",
        "  const unsigned long long p = static_cast<unsigned long long>(m) "
        "* a;\n  hi = static_cast<uint32_t>(p >> 32);\n  lo = "
        "static_cast<uint32_t>(p);")]),
    "blocks_free": ("candidate", [const("int kBlocks", "8", "1")]),
}
# the parent checkout's kernel with this source's bf16 math (for a parent
# whose csrc/elu_dropout.cu took libm's expm1f and expf)
PARENT_FAST = [
    ("    const float e = xf > 0.f ? xf : expm1f(xf);",
     "    const float e = xf > 0.f ? xf : (fabsf(xf) < 1e-3f ? xf * "
     "fmaf(xf, 0.5f, 1.f) : __expf(xf) - 1.f);"),
    ("    const float de = xf > 0.f ? 1.f : expf(xf);",
     "    const float de = xf > 0.f ? 1.f : __expf(0.5f * xf) * "
     "__expf(0.5f * xf);")]
DESIGNS = Path(__file__).with_name("elu_dropout_designs.cu")
# the other designs, spliced in for the package's kernel: name: (design in
# DESIGNS, edits applied after the splice)
SPLICED = {
    "persistent": ("persistent", []),
    "persistent_t512_min2": ("persistent", [
        const("int kThreads", "256", "512"),
        const("int kMinBlocks", "1", "2")]),
    "grid": ("grid", []),
    "grid_u2_min4_late": ("grid", [const("int kU", "1", "2"),
                                   const("int kMinBlocks", "1", "4"),
                                   const("bool kLoadFirst", "true",
                                         "false")]),
    "bulk": ("bulk", []),
    "shuffle": ("shuffle", []),
    "shuffle_wide": ("shuffle", [WIDE_PTX]),
}
KERNEL_START = "// The kernel."
KERNEL_END = "template <typename Op, typename T>\nint launch_typed("


def design(name):
    """The section ``// == name ==`` of DESIGNS."""
    text = DESIGNS.read_text()
    start = text.index(f"// == {name} ==")
    end = text.index("// == ", start + 1)
    return text[start:end]


def spliced_source(name):
    src = (CSRC / "elu_dropout.cu").read_text()
    a, b = src.index(KERNEL_START), src.index(KERNEL_END)
    return (src[:a] + design("common") + design(f"design: {name}") + "\n"
            + src[b:])


def variant_source(edits, path=CSRC / "elu_dropout.cu", src=None):
    src = Path(path).read_text() if src is None else src
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
    return lib, proc.stdout + proc.stderr


def registers(log):
    """{mangled kernel: registers, or "registers/spilled bytes" where
    ptxas spilled} from an nvcc -Xptxas -v log."""
    out, cur, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)) if not spill
                        else f"{m.group(1)}/{spill}")
    return out


def short(mangled):
    """'Fwd bf16 shift 1' from the mangled name of an instantiation."""
    m = re.search(r"elu_dropout_kernelINS_3(Fwd|Bwd)E(13__nv_bfloat16|f)"
                  r"Li(\d)E", mangled)
    if not m:
        return mangled[-40:]
    dtype = "f32" if m.group(2) == "f" else "bf16"
    return f"{m.group(1)} {dtype} shift {m.group(3)}"


SASS_LINE = r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"


def sass_counts(lib_path):
    """{instantiation: (instructions, {opcode: count})} of the library's
    kernels, from cuobjdump -sass (static counts: the step loop's body once,
    the prologue and the ragged tail's paths included)."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = short(m.group(1))
            out[cur] = {}
            continue
        m = re.search(SASS_LINE, line)
        if m and cur is not None:
            op = m.group(1)
            out[cur][op] = out[cur].get(op, 0) + 1
    return {k: (sum(v.values()), dict(sorted(v.items(), key=lambda kv:
                                                 -kv[1])))
            for k, v in out.items()}


def load(path):
    lib = ctypes.CDLL(str(path))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    u, f = ctypes.c_uint, ctypes.c_float
    lib.bdvs_elu_dropout_fwd.argtypes = [p, p, p, ll, ll, i, u, f, p]
    lib.bdvs_elu_dropout_fwd.restype = i
    lib.bdvs_elu_dropout_bwd.argtypes = [p, p, p, p, ll, ll, i, u, f, p]
    lib.bdvs_elu_dropout_bwd.restype = i
    return lib


def events_ms(fn, iters=100):
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
                                         "elu_dropout_probe.json"))
    ap.add_argument("--variants", default=",".join([*VARIANTS, *SPLICED]))
    ap.add_argument("--parent", default="",
                    help="a checkout whose csrc/elu_dropout.cu is timed "
                         "as the candidate 'parent'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    names = [v for v in args.variants.split(",") if v]
    kinds = {n: VARIANTS[n][0] if n in VARIANTS else "candidate"
             for n in names}
    out_dir = ROOT / "build" / "elu_dropout_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {"base": variant_source([])}
    for n in names:
        if n in SPLICED:
            d, edits = SPLICED[n]
            srcs[n] = variant_source(edits, src=spliced_source(d))
        else:
            srcs[n] = variant_source(VARIANTS[n][1])
    if args.parent:
        parent = (Path(args.parent) / "behavior_driven_video_synthesis_tpu_"
                  "torch" / "csrc" / "elu_dropout.cu")
        srcs["parent"] = variant_source([], parent)
        srcs["parent_fast"] = variant_source(PARENT_FAST, parent)
        names += ["parent", "parent_fast"]
        kinds["parent"] = kinds["parent_fast"] = "candidate"
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(lambda n: build(n, srcs[n], out_dir),
                                        srcs)))
    libs = {n: load(p) for n, (p, _) in built.items()}
    results = {"card": card, "shape": list(SHAPE), "rate": RATE,
               "registers": {}, "variants": {}}
    for n, (_, log) in built.items():
        regs = {short(k): v for k, v in registers(log).items()}
        results["registers"][n] = regs
        print(f"{n:12s} registers: " + ", ".join(
            f"{k} {v}" for k, v in sorted(regs.items())), flush=True)

    results["sass"] = {}
    for n in built:
        counts = sass_counts(built[n][0])
        results["sass"][n] = counts
        for k in ("Fwd bf16 shift 0", "Fwd bf16 shift 1", "Bwd bf16 shift 0",
                  "Bwd bf16 shift 1"):
            total, ops = counts.get(k, (0, {}))
            print(f"{n:12s} SASS {k}: {total} instructions; " + ", ".join(
                f"{op} {c}" for op, c in list(ops.items())[:10]), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, generator=g, device="cuda").to(torch.bfloat16)
    ct = torch.randn(SHAPE, generator=g, device="cuda").to(torch.bfloat16)
    seed = E.draw_seed("cuda", g)
    n = x.numel()
    y_copy = torch.empty_like(x)
    cases = {"fwd": lambda: E.elu_dropout_forward(x, seed, RATE),
             "fwd n+1": lambda: E.elu_dropout_forward(x, seed, RATE, n + 1),
             "bwd": lambda: E.elu_dropout_backward(x, ct, seed, RATE)}
    real_lib = E._lib
    try:
        copy_ms = [events_ms(lambda: y_copy.copy_(x)) for _ in range(2)]
        results["copy_ms"] = copy_ms
        print(f"device copy of x: {copy_ms[0]:.4f}, {copy_ms[1]:.4f} ms",
              flush=True)
        for v in names:
            entry = {"kind": kinds[v], "ms": {}}
            if kinds[v] == "candidate":
                E._lib = lambda: libs[v]
                errs = []
                for off in (0, n + 1):
                    y = E.elu_dropout_forward(x, seed, RATE, off)
                    dx = E.elu_dropout_backward(x, ct, seed, RATE, off)
                    ref = E.elu_dropout_plain(x, seed, RATE, off)
                    dref = E.elu_dropout_backward_plain(x, ct, seed, RATE,
                                                        off)
                    errs.append(int((y == 0).ne(ref == 0).sum())
                                + int((dx == 0).ne(dref == 0).sum()))
                    entry["max_abs_err"] = max(
                        entry.get("max_abs_err", 0.0),
                        float((y.float() - ref.float()).abs().max()),
                        float((dx.float() - dref.float()).abs().max()))
                entry["zero_mismatches"] = sum(errs)
            for case, fn in cases.items():
                t = []
                for lib in ("base", v, v, "base"):
                    E._lib = lambda lib=lib: libs[lib]
                    t.append(events_ms(fn))
                entry["ms"][case] = t
                print(f"{v:12s} ({kinds[v]}) {case:8s}: base {t[0]:.4f}, "
                      f"variant {t[1]:.4f}, {t[2]:.4f}, base {t[3]:.4f} ms",
                      flush=True)
            if "max_abs_err" in entry:
                print(f"{v:12s} against the plain version: zero-pattern "
                      f"mismatches {entry['zero_mismatches']}, max|err| "
                      f"{entry['max_abs_err']:.3e}", flush=True)
            results["variants"][v] = entry
    finally:
        E._lib = real_lib
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
