"""``chip_smoke.py``'s phase [26] on the card, ``--runs`` times over: the
1-rank NCCL group's cvbae (``pallas_sharded``) and behavior runs (the
flow sharded by FSDP) against the same runs without a group.  A check of
the phase that fails is printed, not raised, and every run's largest
parameter and Adam moment differences (over 1 + the tensor's largest
magnitude) are printed, so that a drift is seen whole.  Under the
phase's deterministic algorithms every run should read 0; without them
(an earlier version of the phase) the cvbae parameters read up to
9.7e-06.  Run on a machine with one CUDA device:

    python3 examples/torch_multi_device_probe.py [--runs 2] \\
        [--out chiprun_out/multi_device_probe.json]
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "multi_device_probe.json"))
    args = ap.parse_args(argv)
    failed = []

    def check(ok, msg):
        if not ok:
            failed.append(msg)
            chip_smoke.log(f"check failed: {msg}")
    chip_smoke.check = check
    chip_smoke.phase_card()
    chip_smoke.phase_build()
    runs = []
    for _ in range(args.runs):
        chip_smoke.phase_multi_device()
        runs.append(chip_smoke.RESULTS["multi_device"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"runs": runs, "failed": failed}, f, indent=1)
    for r in runs:
        print(json.dumps({"max_diff": r["max_diff"], "step_ms":
                          r["step_ms"]}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
