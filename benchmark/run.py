"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  ``--trace 0`` measures the cell's end-to-end metrics over a
window of ``--seconds``; ``--trace 1`` serves the traffic mix's ``traced``
requests under the profiler and reports the per-layer metrics.  Either
way the served requests of a sample drawn from the seed are compared with
the reference afterwards; the numbers compared are the last lines on
standard error and the last key of the result, the last line on standard
output.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program stays in the checkout, at
# fixed paths, so that only a checkout's first run builds
BUILD = ROOT / "build"
os.environ["BDVS_TORCH_BUILD_DIR"] = str(BUILD / "torch_kernels")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    imported = time.perf_counter()
    from benchmark import harness

    # the host's share of the work is launches from one thread; idle
    # intra-op workers only take cores from it
    torch.set_num_threads(1)

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START,
                         marks=[("import_torch", imported)])
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or of the JAX package: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
