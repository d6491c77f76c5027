"""Serving CLI (``bdvs-generate-torch``): behavior-transfer RGB videos from
trained weights, on one GPU (or the CPU).

Counterpart of ``behavior_driven_video_synthesis_tpu/generate.py``.  The JAX
package's run directories are orbax checkpoints, which need JAX to read;
this CLI reads the same parameter trees from ``.npz`` files instead
(``examples/export_params_for_torch.py`` writes them from a JAX run):

    bdvs-generate-torch --behavior_params behavior.npz \\
                        --synth_params synth.npz \\
                        [--mode sample|transfer] [--request req.npz] \\
                        [--out ./served] [--length 50] [--batch 4]

``behavior.npz`` holds ``net/...`` (the ResidualBehaviorNet params) and,
optionally, ``flow/params/...`` and ``flow/buffers/...``; ``synth.npz``
holds ``vunet/...``.  Beside each, ``<same name>.json`` may hold the run's
``architecture``, ``data`` and ``general`` config keys; missing keys take
the training defaults.

Modes
  sample    z ~ N(0,1) -> flow inverse (when the behavior file has a flow)
            -> rollout -> render: novel behaviors.
  transfer  infer the behavior posterior mean from the request's ``source``
            sequences and re-enact it from ``x_start``.

Request file (.npz), all optional with synthetic fallbacks: x_start (B, K),
source (B, T, K), app_img (B, S, S, 3) in [-1, 1] float or uint8,
extrinsics (B, 3, 4), intrinsics (B, 4) as (fx, x0, fy, y0), image_size
(B, 2), norm_mean / norm_std (K_full,) and dim_to_use (K,).

Videos are mp4 where OpenCV is installed and uint8 .npy otherwise; the
manifest says which.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from .data.human36m import detailed_joint_model
from .geometry.stickman import JointModel
from .models.behavior import ResidualBehaviorNet
from .models.convert import (behavior_net_from_flax, latent_flow_from_flax,
                             load_flax_npz, vunet_alter_from_flax)
from .models.flows import LatentFlow
from .models.vunet import vunet_from_config
from .pipeline import BehaviorTransferPipeline
from .viz.videos import VIDEO_FORMAT, frames_to_uint8, write_video


def chain_joint_model(n_joints: int) -> JointModel:
    """Minimal consecutive-chain skeleton for non-H36M keypoint layouts
    (synthetic runs): renders every joint, no anatomical semantics."""
    edges = [(i, i + 1) for i in range(max(n_joints - 1, 1))]
    half = max(len(edges) // 2, 1)
    return JointModel(
        body=list(range(min(3, n_joints))),
        right_lines=edges[:half],
        left_lines=edges[half:] or edges[:1],
        head_lines=edges[:1],
        face=[],
        rshoulder=0,
        lshoulder=min(1, n_joints - 1),
        headup=min(2, n_joints - 1),
        kps_to_use=list(range(n_joints)),
        total_relative_joints=[],
        kp_to_joint=["joint"] * n_joints,
    )


def _default_camera(b: int, spatial: int):
    extr = np.tile(np.hstack([np.eye(3), [[0.0], [0.0], [4.0]]]
                             ).astype(np.float32), (b, 1, 1))
    f = float(spatial) * 4.5
    intr = np.tile(np.asarray([f, spatial / 2.0, f, spatial / 2.0],
                              np.float32), (b, 1))
    imsize = np.full((b, 2), float(spatial), np.float32)
    return extr, intr, imsize


def _load_params(npz_path: str):
    """(parameter tree, run config dict) of an exported run."""
    tree = load_flax_npz(npz_path)
    cfg_path = os.path.splitext(npz_path)[0] + ".json"
    config = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = json.load(f)
    return tree, config


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Generate behavior-transfer videos from trained "
                    "weights (PyTorch serving entry point)")
    ap.add_argument("--behavior_params", required=True,
                    help="behavior run .npz (net [+ flow]); config from "
                         "the .json beside it")
    ap.add_argument("--synth_params", required=True,
                    help="synthesis run .npz (vunet); config from the "
                         ".json beside it")
    ap.add_argument("--request", default=None,
                    help=".npz request file (see module docstring)")
    ap.add_argument("--mode", choices=["sample", "transfer"],
                    default="sample")
    ap.add_argument("--out", default="./served")
    ap.add_argument("--batch", type=int, default=4,
                    help="videos per request when no request file given")
    ap.add_argument("--length", type=int, default=50)
    ap.add_argument("--fps", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda when available)")
    # options of the JAX CLI that this port does not have yet
    ap.add_argument("--from_dataset", action="store_true")
    ap.add_argument("--quant", choices=["none", "int8_static"],
                    default="none")
    ap.add_argument("--upsample", choices=["subpixel", "transpose"],
                    default="subpixel")
    ap.add_argument("--preset", choices=["none", "tpu-serving"],
                    default="none")
    args = ap.parse_args(argv)
    unported = [flag for flag, on in (
        ("--from_dataset", args.from_dataset),
        ("--quant", args.quant != "none"),
        ("--upsample transpose", args.upsample != "subpixel"),
        ("--preset", args.preset != "none")) if on]
    if unported:
        ap.exit(2, f"{', '.join(unported)}: not ported yet\n")
    return args


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device or (
        "cuda" if torch.cuda.is_available() else "cpu"))

    btree, bcfg = _load_params(args.behavior_params)
    barch = bcfg.get("architecture", {})
    hid = int(barch.get("dim_hidden_b", 1024))
    has_flow = "flow" in btree
    if not has_flow:
        print("no flow parameters: 'sample' draws behavior latents from "
              "N(0,1) directly")

    stree, scfg = _load_params(args.synth_params)
    sdata = scfg.get("data", {})
    spatial = int(sdata.get("spatial_size", 64))
    s_inplane = bool(sdata.get("inplane_normalize", False))
    s_exp = str(scfg.get("general", {}).get("experiment", "cvbae"))
    if s_exp == "vunet":
        raise SystemExit("the org-variant VUNet (experiment 'vunet') is "
                         "not ported yet")
    s_boxf = int(sdata.get("box_factor", 2))
    app_hw = spatial // (2 ** s_boxf) if s_inplane else spatial
    app_ch = 30 if s_inplane else 3

    net_params = btree["net"]
    n_kps_ckpt = int(np.asarray(net_params["decoder"]["b_out"]).shape[-1])

    # ---- request ----------------------------------------------------------
    req = {}
    if args.request:
        with np.load(args.request) as data:
            req = {k: data[k] for k in data.files}
    rng = np.random.RandomState(args.seed)
    if "x_start" in req:
        x_start = np.asarray(req["x_start"], np.float32)
    else:
        x_start = rng.randn(args.batch, n_kps_ckpt).astype(np.float32) * 0.05
    B, K = x_start.shape
    if K != n_kps_ckpt:
        raise SystemExit(f"request x_start has {K} dims but the behavior "
                         f"weights were trained with {n_kps_ckpt}")
    source = (np.asarray(req["source"], np.float32) if "source" in req
              else None)
    if args.mode == "transfer" and source is None:
        raise SystemExit("--mode transfer needs `source` sequences in the "
                         "request file")
    if source is not None and (source.ndim != 3 or source.shape[0] != B
                               or source.shape[-1] != K):
        raise SystemExit(f"request source must be (B={B}, T, {K}); got "
                         f"{source.shape}")
    mean = np.asarray(req.get("norm_mean", np.zeros(K)), np.float32)
    std = np.asarray(req.get("norm_std", np.ones(K)), np.float32)
    dim_to_use = np.asarray(req.get("dim_to_use", np.arange(K)), np.int64)
    if "app_img" in req:
        app = np.asarray(req["app_img"])
        if app.dtype == np.uint8:
            app = app.astype(np.float32) / 127.5 - 1.0
        app = app.astype(np.float32)
        if app.shape[-1] != app_ch:
            raise SystemExit(
                f"this synthesis run expects {app_ch}-channel appearance "
                f"({'inplane part stack' if s_inplane else 'RGB'}), got "
                f"{app.shape[-1]} channels")
        if app.shape[1] != app_hw:
            if app_ch != 3:
                raise SystemExit(f"inplane appearance must be exactly "
                                 f"({app_hw},{app_hw},30); got "
                                 f"{app.shape[1:]}")
            # bilinear with half-pixel centres, like the JAX CLI's
            # cv2.resize, without needing OpenCV
            app = F.interpolate(torch.from_numpy(app).permute(0, 3, 1, 2),
                                size=(app_hw, app_hw), mode="bilinear",
                                align_corners=False).permute(0, 2, 3, 1)
            app = app.numpy()
    else:
        app = np.full((B, app_hw, app_hw, app_ch), 0.1, np.float32)
    extr_d, intr_d, imsize_d = _default_camera(B, spatial)
    extr = np.asarray(req.get("extrinsics", extr_d), np.float32)
    intr = np.asarray(req.get("intrinsics", intr_d), np.float32)
    imsize = np.asarray(req.get("image_size", imsize_d), np.float32)

    n_joints = int(len(dim_to_use)) // 3
    jm = (detailed_joint_model(world_coords=True) if n_joints == 17
          else chain_joint_model(n_joints))

    # ---- models (serving config) ------------------------------------------
    behavior = ResidualBehaviorNet(
        n_kps=K, dim_hidden_b=hid,
        decoder_arch=str(barch.get("decoder_arch", "lstm")),
        use_nin_dec=bool(barch.get("linear_in_decoder", False)),
        information_bottleneck=True, device=device)
    behavior.load_state_dict(behavior_net_from_flax(net_params))
    use_flow = args.mode == "sample" and has_flow
    flow_model = None
    if use_flow:
        flow_model = LatentFlow(
            flow_in_channels=hid,
            flow_mid_channels=hid * int(barch.get(
                "flow_mid_channels_factor", 2)),
            flow_hidden_depth=int(barch.get("flow_hidden_depth", 2)),
            n_flows=int(barch.get("n_flows", 15)), device=device)
        flow_model.load_state_dict(latent_flow_from_flax(btree["flow"]))
    # remat only changes a backward pass, so serving ignores it
    vunet = vunet_from_config(scfg, "alter", dtype=torch.bfloat16,
                              remat=False, device=device)
    vunet.load_state_dict(vunet_alter_from_flax(stree["vunet"]))
    for m in (behavior, flow_model, vunet):
        if m is not None:
            m.eval()

    pipe = BehaviorTransferPipeline(
        behavior, vunet, jm, mean, std, dim_to_use, spatial_size=spatial,
        stickman_thickness=max(2.0, spatial / 64.0), flow_model=flow_model)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        if args.mode == "transfer":
            _, z, _, _ = behavior.infer_b(
                torch.as_tensor(source, device=device), generator=gen)
        else:
            z = torch.randn(B, hid, generator=gen, device=device)
        out = pipe.generate(z, x_start, app, extr, intr, imsize,
                            length=args.length, generator=gen)

    os.makedirs(args.out, exist_ok=True)
    frames = frames_to_uint8(out["frames"].float().cpu().numpy())
    stick = frames_to_uint8(out["stickman"].float().cpu().numpy())
    paths = {}
    for i in range(B):
        tag = f"{args.mode}_{i}"
        paths[tag] = write_video(
            np.concatenate([stick[i], frames[i]], axis=2),
            os.path.join(args.out, f"{tag}.{VIDEO_FORMAT}"), fps=args.fps)
    manifest = {"mode": args.mode, "batch": B, "length": args.length,
                "spatial": spatial, "quant": args.quant,
                "upsample": args.upsample, "flow": use_flow,
                "device": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else str(device)),
                "video_format": VIDEO_FORMAT, "videos": paths}
    mpath = os.path.join(args.out, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"wrote {len(paths)} videos + {mpath}")
    return manifest


if __name__ == "__main__":
    main()
