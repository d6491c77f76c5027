"""Export a trained JAX run for the PyTorch port's serving CLI.

Reads the latest checkpoints of a behavior run (reg_ckpt, and flow_ckpt
when present) or a synthesis run (reg_ckpt) with the JAX package's
``load_run_checkpoint`` and writes what ``bdvs-generate-torch`` reads:
``<out>.npz`` (the parameter tree, "/"-joined keys) and ``<out>.json`` (the
run's architecture, data and general config keys).

    python examples/export_params_for_torch.py --run <base>/behavior_net \\
        --kind behavior --out served/behavior
    python examples/export_params_for_torch.py --run <base>/cvbae_run \\
        --kind synth --out served/synth
    bdvs-generate-torch --behavior_params served/behavior.npz \\
        --synth_params served/synth.npz
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def export(run_dir: str, kind: str, out: str) -> dict:
    """Write ``out``.npz and ``out``.json; returns the flat arrays.  The
    flattening is the port's torch-free ``flax_npz.flatten_tree``."""
    from behavior_driven_video_synthesis_tpu.experiments.visualize import (
        load_run_checkpoint)
    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree)

    state, config = load_run_checkpoint(run_dir, "reg_ckpt")
    if kind == "behavior":
        tree = {"net": state["net"]["params"]}
        try:
            fstate, _ = load_run_checkpoint(run_dir, "flow_ckpt")
            tree["flow"] = {"params": fstate["flow"]["params"],
                            "buffers": fstate["flow"]["buffers"]}
        except FileNotFoundError:
            print("no flow checkpoint: exporting the behavior net only")
    else:
        tree = {"vunet": state["vunet"]["params"]}
    flat = flatten_tree(tree)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out + ".npz", **flat)
    cfg = {k: (config or {}).get(k, {})
           for k in ("architecture", "data", "general")}
    with open(out + ".json", "w") as f:
        json.dump(cfg, f, indent=1, default=str)
    print(f"wrote {out}.npz ({len(flat)} arrays) and {out}.json")
    return flat


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", required=True, help="JAX run directory")
    ap.add_argument("--kind", choices=["behavior", "synth"], required=True)
    ap.add_argument("--out", required=True,
                    help="output path without extension")
    args = ap.parse_args(argv)
    export(args.run, args.kind, args.out)


if __name__ == "__main__":
    main()
