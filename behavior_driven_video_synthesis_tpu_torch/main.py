"""Training CLI (``bdvs-train-torch``), on one GPU unless told otherwise.

Counterpart of ``behavior_driven_video_synthesis_tpu/main.py`` (:31-186):

    bdvs-train-torch -c configs/<experiment>.yaml [-m train|infer] [-d] \\
                     [-r] [-f] [-p RUN] [--device cuda|cpu] [--gpu ...]

for the experiments ``cvbae`` (``configs/shape_and_pose_net.yaml``),
``vunet``, ``behavior_net`` and ``mtvae`` (``configs/mt_vae.yaml``); any
other name exits with status 2.  Run directories are
``{ckpt,config,generated,log}/<project_name>`` under
``base_dir/experiment``; the config is dumped to
``config/<project>/config.yaml``, with ``general.tf32: false``: float32
products and convolutions run without TF32 (``core/precision.py``).
With ``DATAPATH`` set, ``base_dir`` and ``data.datapath`` are taken
relative to it.

``--debug`` trains the "debug" project (cvbae and vunet: at most 8 steps;
behavior_net: at most 2 epochs and 1 flow epoch on 8 batches; mtvae: at
most 2 epochs on 8 batches).  ``-m infer`` evaluates the run's checkpoints
(cvbae and vunet: SSIM and the post-hoc latent regressor; behavior_net and
mtvae: their inference protocols) and logs the summary under ``infer/`` in
the run's ``metrics.jsonl``.  ``-r`` resumes a run: it reloads the config
dumped in the run directory (so the run's hyperparameters stay as they
were) and restores the run's checkpoints; a finished run runs no step.
Without ``-r``, a run whose directory holds a config asks on a terminal
whether to resume: "y" is ``-r``, "n" starts over (``general.fresh_start``:
each role's old checkpoints are deleted before it would restore them);
off a terminal the run restores its checkpoints as before.  ``-p RUN``
warm-starts from a trained run (its experiment root
``<base>/<experiment>`` holding one project, or its ``config/<project>``
directory): its config is adopted and
its checkpoint roles are copied into this run (with ``--debug``, into the
"debug" project), which then trains or evaluates from them.  ``-f``
(behavior_net only) sets ``training.only_flow`` (train the flow alone, over
this run's or a sibling run's cVAE).  ``--gpu`` is accepted and has no
effect (``--device`` picks the device).  ``-v`` sets
``general.visualization`` (the figures and videos of behavior_net and
mtvae; cvbae and vunet have none) and ``-s RUN`` sets
``logging.synth_params``: a cvbae run directory of this package (its
experiment directory, its ``ckpt/<project>`` directory or a ``reg_ckpt``
directory) whose VUNet renders behavior_net's RGB figures.  Neither is
dumped with the config.
``training.dropout_rng`` is accepted and has no effect (the TPU's rng-bit
generator has no counterpart here).

A plain launch trains on one device, where the JAX CLI takes every local
device.  For data parallelism over N GPUs, launch one process per GPU::

    torchrun --nproc_per_node=N -m behavior_driven_video_synthesis_tpu_torch.main -c ...

With ``WORLD_SIZE`` set (torchrun sets it) the CLI joins the process group
(NCCL, or gloo with ``--device cpu``), each rank on ``cuda:LOCAL_RANK``;
an existing group of the caller's is used as it is.  The global batch
stays ``training.batch_size`` (``parallel/mesh.py``).  Rank 0 writes the
run's config, logs and checkpoints; every rank restores; ``-m infer`` runs
on rank 0 alone, while the other ranks return at once (no collective
follows the split, so no collective's timeout bounds the evaluation).
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys
from os import path

import torch

from .core.config import load_config, save_config
from .core.precision import disable_tf32, tf32_enabled
from .experiments import EXPERIMENTS, select_experiment
from .parallel import mesh


def create_dir_structure(config: dict, model_name: str):
    general = config["general"]
    base = path.join(general["base_dir"], general["experiment"])
    return {d: path.join(base, d, model_name)
            for d in ("ckpt", "config", "generated", "log")}


def _reroot(config: dict) -> None:
    """``base_dir`` and ``data.datapath`` under ``$DATAPATH``, if set."""
    root = os.environ.get("DATAPATH")
    if root is None:
        return
    general = config["general"]
    general["base_dir"] = path.join(root, str(general["base_dir"]).lstrip("/"))
    data = config.get("data", {})
    if data.get("datapath"):
        data["datapath"] = path.join(root, str(data["datapath"]).lstrip("/"))


def _ask_resume() -> bool:
    """The reference's "resume training (y/n)?" until y or n."""
    while True:
        answer = input("WARNING: run was started earlier: resume training "
                       "(y/n)? ").strip().lower()
        if answer in ("y", "yes", "n", "no"):
            return answer.startswith("y")
        print("Invalid answer! Try again! (y/n)")


def load_parameters(config: dict, debug: bool, restart: bool = False,
                    pretrained_model: str = None):
    """(config, run dirs) of a loaded config, which is dumped into the
    run; with ``restart`` (or "y" at the resume prompt), the config dumped
    there earlier, if any; with ``pretrained_model``, that run's config
    (:func:`adopt_pretrained`)."""
    general = config.setdefault("general", {})
    if debug:
        general["debug"] = True
        general["project_name"] = "debug"
    _reroot(config)
    dirs = create_dir_structure(config, general["project_name"])
    saved = path.join(dirs["config"], "config.yaml")
    if restart and path.exists(saved):
        config = load_config(saved)
        if debug:
            config["general"]["debug"] = True
        return config, dirs
    if pretrained_model:
        return adopt_pretrained(pretrained_model, debug)
    ask = (path.isfile(saved) and not debug and sys.stdin is not None
           and sys.stdin.isatty())
    if ask and _ask_resume():
        return load_config(saved), dirs
    save_config(config, saved)
    if ask:   # "n": this run only, not the dumped config a -r reloads
        general["fresh_start"] = True
    return config, dirs


def adopt_pretrained(pretrained_model: str, debug: bool):
    """Warm start from a trained run (the JAX ``_adopt_pretrained``): its
    config, dumped into this run, and its checkpoint role directories
    copied into this run's ckpt directory, where none of the same name is.
    A run whose adopted config resolves to its own directories goes on in
    place, with a warning."""
    direct = path.join(pretrained_model, "config.yaml")
    if path.isfile(direct):
        cfg_path = direct
        project = path.basename(path.normpath(pretrained_model))
        src_ckpt = path.join(path.dirname(path.dirname(
            path.normpath(pretrained_model))), "ckpt", project)
    else:
        found = sorted(glob.glob(
            path.join(pretrained_model, "config", "*", "config.yaml")))
        if len(found) != 1:
            raise FileNotFoundError(
                f"--pretrained_model: expected exactly one "
                f"config/<project>/config.yaml under {pretrained_model}, "
                f"found {found}")
        cfg_path = found[0]
        project = path.basename(path.dirname(cfg_path))
        src_ckpt = path.join(pretrained_model, "ckpt", project)
    config = load_config(cfg_path)
    if debug:
        # a --debug warm start writes into the "debug" project, never into
        # the pretrained run itself
        config["general"]["debug"] = True
        config["general"]["project_name"] = "debug"
    dirs = create_dir_structure(config, config["general"]["project_name"])
    save_config(config, path.join(dirs["config"], "config.yaml"))
    if not path.isdir(src_ckpt):
        return config, dirs
    if path.abspath(src_ckpt) == path.abspath(dirs["ckpt"]):
        print("WARNING: --pretrained_model points at a run whose config "
              "resolves to the same run directory; continuing IN PLACE "
              "(new checkpoints rotate out old ones there). Move/copy the "
              "pretrained run elsewhere to warm-start a fresh run.")
        return config, dirs
    for role in os.listdir(src_ckpt):
        src, dst = path.join(src_ckpt, role), path.join(dirs["ckpt"], role)
        if path.isdir(src) and not path.exists(dst):
            shutil.copytree(src, dst)
            print(f"warm start: copied {src} to {dst}")
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
    ap.add_argument("-p", "--pretrained_model", default=None,
                    help="warm-start from a trained run's directory")
    ap.add_argument("--gpu", type=int, nargs="*", default=None,
                    help="accepted for CLI parity; --device picks the "
                         "device")
    ap.add_argument("-v", "--visualization", action="store_true",
                    help="write the experiment's figures and videos")
    ap.add_argument("-s", "--synth_model", default=None,
                    help="a trained cvbae run directory whose VUNet "
                         "renders RGB figures")
    return ap.parse_args(argv)


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
    rank_device = mesh.init_from_env(device)
    try:
        return _run(args, rank_device or device)
    finally:
        if rank_device is not None:
            mesh.shutdown()


def _run(args, device):
    config = load_config(args.config)
    experiment = config.get("general", {}).get("experiment")
    if experiment not in EXPERIMENTS:
        sys.stderr.write(f"unknown experiment: {experiment!r} (known: "
                         f"{', '.join(EXPERIMENTS)})\n")
        raise SystemExit(2)
    if args.flow and experiment != "behavior_net":
        sys.stderr.write(f"-f (flow-only training) of {experiment!r}: "
                         f"behavior_net has the only flow stage\n")
        raise SystemExit(2)
    # the run's record of its float32 precision, dumped with the config
    config.setdefault("general", {})["tf32"] = tf32_enabled()
    if args.flow:
        config.setdefault("training", {})["only_flow"] = True
    if mesh.is_main():
        config, dirs = load_parameters(config, args.debug, args.restart,
                                       args.pretrained_model)
    mesh.barrier()
    if not mesh.is_main():    # the config rank 0 dumped into the run
        config, dirs = load_parameters(config, args.debug, restart=True)
    if args.flow:   # also over a config reloaded from a run
        config.setdefault("training", {})["only_flow"] = True
    if args.visualization:
        config["general"]["visualization"] = True
    if args.synth_model:
        config.setdefault("logging", {})["synth_params"] = args.synth_model
    exp = select_experiment(config, dirs, device, args.restart)
    if args.mode != "infer":
        return exp.run_training()
    if not mesh.is_main():
        return None
    with mesh.alone():
        return exp.run_inference()


if __name__ == "__main__":
    main()
