"""Training CLI (``bdvs-train-torch``), on one GPU unless told otherwise.

Counterpart of ``behavior_driven_video_synthesis_tpu/main.py`` (``main``,
:148-186):

    bdvs-train-torch -c configs/shape_and_pose_net.yaml [-m train|infer] \\
                     [-d] [-r] [--device cuda|cpu]
    bdvs-train-torch -c configs/vunet.yaml [-m train|infer] [-d] [-r] \\
                     [--device cuda|cpu]
    bdvs-train-torch -c configs/behavior_net.yaml [-m train|infer] [-d] \\
                     [-r] [-f] [--device cuda|cpu]

Run directories are ``{ckpt,config,generated,log}/<project_name>`` under
``base_dir/experiment``; the config is dumped to
``config/<project>/config.yaml``, with ``general.tf32: false``: float32
products and convolutions run without TF32 (``core/precision.py``).
``--debug`` trains the "debug" project (cvbae and vunet: at most 8 steps;
behavior_net: at most 2 epochs and 1 flow epoch on 8 batches).  The
``cvbae``, ``vunet`` and ``behavior_net`` experiments are ported.
``-m infer`` evaluates the run's checkpoints (cvbae and vunet: SSIM and
the post-hoc latent regressor; behavior_net: the inference protocol) and
logs the summary under ``infer/`` in the run's ``metrics.jsonl``; ``-r``
resumes a run: it reloads the config dumped in the run directory (so the
run's hyperparameters stay as they were) and restores the run's
checkpoints; a finished run runs no step.  ``-f`` (behavior_net only)
sets ``training.only_flow`` (train the flow alone, over this run's or a
sibling run's cVAE).  The other experiments, ``-f`` for the VUNet
experiments, and the ``-v``, ``-s`` and ``-p`` options exit with status
2.
``training.dropout_rng`` is accepted and has no effect (the TPU's rng-bit
generator has no counterpart here).
"""
from __future__ import annotations

import argparse
import sys
from os import path

import torch

from .core.config import load_config, save_config
from .core.precision import disable_tf32, tf32_enabled

PORTED_EXPERIMENTS = ("cvbae", "vunet", "behavior_net")


def create_dir_structure(config: dict, model_name: str):
    general = config["general"]
    base = path.join(general["base_dir"], general["experiment"])
    return {d: path.join(base, d, model_name)
            for d in ("ckpt", "config", "generated", "log")}


def load_parameters(config: dict, debug: bool, restart: bool = False):
    """(config, run dirs) of a loaded config, which is dumped into the
    run; with ``restart``, the config dumped there earlier, if any."""
    general = config.setdefault("general", {})
    if debug:
        general["debug"] = True
        general["project_name"] = "debug"
    dirs = create_dir_structure(config, general["project_name"])
    saved = path.join(dirs["config"], "config.yaml")
    if restart and path.exists(saved):
        config = load_config(saved)
        if debug:
            config["general"]["debug"] = True
    else:
        save_config(config, saved)
    return config, dirs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Train a model of behavior_driven_video_synthesis "
                    "(PyTorch training entry point)")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-m", "--mode", default="train",
                    choices=["train", "infer"])
    ap.add_argument("-d", "--debug", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu to train "
                         "on the CPU)")
    ap.add_argument("-r", "--restart", action="store_true",
                    help="resume a run from its checkpoints")
    ap.add_argument("-f", "--flow", action="store_true",
                    help="train only the flow stage of behavior_net")
    # options of the JAX CLI that this port does not have yet
    ap.add_argument("-v", "--visualization", action="store_true")
    ap.add_argument("-s", "--synth_model", default=None)
    ap.add_argument("-p", "--pretrained_model", default=None)
    args = ap.parse_args(argv)
    unported = [flag for flag, on in (
        ("-v", args.visualization),
        ("-s", args.synth_model is not None),
        ("-p", args.pretrained_model is not None)) if on]
    if unported:
        ap.exit(2, f"{', '.join(unported)}: not ported yet\n")
    return args


def resolve_device(name: str) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU;
    no silent fallback."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu "
                         "to run on the CPU")
    return device


def main(argv=None):
    args = parse_args(argv)
    disable_tf32()
    device = resolve_device(args.device)
    config = load_config(args.config)
    experiment = config.get("general", {}).get("experiment")
    if experiment not in PORTED_EXPERIMENTS:
        sys.stderr.write(f"experiment {experiment!r}: not ported yet "
                         f"(ported: {', '.join(PORTED_EXPERIMENTS)})\n")
        raise SystemExit(2)
    if args.flow and experiment != "behavior_net":
        sys.stderr.write(f"-f (flow-only training) of {experiment!r}: "
                         f"behavior_net has the only flow stage\n")
        raise SystemExit(2)
    # the run's record of its float32 precision, dumped with the config
    config.setdefault("general", {})["tf32"] = tf32_enabled()
    if args.flow:
        config.setdefault("training", {})["only_flow"] = True
    config, dirs = load_parameters(config, args.debug, args.restart)
    if experiment == "behavior_net":
        from .experiments.behavior_net import BehaviorNetExperiment
        exp = BehaviorNetExperiment(config, dirs, device)
        return (exp.run_inference() if args.mode == "infer"
                else exp.run_training())
    if experiment == "vunet":
        from .experiments.vunet import VunetExperiment as cls
    else:
        from .experiments.shape_and_pose_net import ShapePoseExperiment as cls
    exp = cls(config, dirs, device)
    return exp.run_inference() if args.mode == "infer" else exp.run_training()


if __name__ == "__main__":
    main()
