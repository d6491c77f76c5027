"""Visual smoke tests of the datasets (``bdvs-data-smoke-torch``).

Counterpart of ``behavior_driven_video_synthesis_tpu/data/smoke.py``, the
reference's ``__main__`` blocks driven by ``configs/test_datasets.yaml``:

  * ``visualize_projection``: the dataset's poses unnormalized (through
    forward kinematics for joint angles) to world coordinates, projected
    with each frame's camera, and drawn over the dataset's frames (black
    where a frame has no image file), plus a 3-D skeleton video; the
    projection of every window is one batched call on the device
    (``geometry/camera.py``);
  * ``test_synth``: pose image, stickman and appearance triplets as PNGs
    (stickmen from 3-D for a Human3.6M dataset without image files);
  * anything else: one loader batch, a grid PNG per image key.

Usage::

    bdvs-data-smoke-torch --config configs/test_datasets.yaml \\
        [--mode ...] [--out ./test_data] [--n_videos 3] [--device cuda|cpu]

Datasets resolve as in training: ``data.dataset`` and ``data.datapath``;
``h36m_synthetic`` (or a Human3.6M config without ``annot_export.h5``)
takes the synthetic Human3.6M columns.  Human3.6M is read through
``data/h5lite.py`` where h5py is missing.  Without ``--device cpu`` the
tool needs a card.
"""
from __future__ import annotations

import argparse
import os
from os import path

import numpy as np
import torch

from ..core.config import load_config
from ..geometry.camera import apply_affine_transform, camera_projection
from ..geometry.kinematics import forward_kinematics
from ..geometry.normalization import unnormalize
from ..viz import videos
from . import get_dataset
from .human36m import Human36mDataset
from .loader import Loader
from .samplers import RandomSampler, SequenceSampler


def _build_h36m(dcfg, mode: str, data_keys):
    kwargs = {k: v for k, v in dcfg.items()
              if k not in ("dataset", "seq_length")}
    kwargs.setdefault("keypoint_type", "keypoints_3d_world")
    ds = Human36mDataset(None, data_keys,
                         tuple(dcfg.get("seq_length", (0, 0))),
                         mode=mode, **kwargs)
    if len(ds) == 0:
        from .synthetic import synthetic_h36m_columns

        ds.populate_from_arrays(synthetic_h36m_columns(
            n_frames_per_video=int(dcfg.get("n_frames_per_video", 120))))
    return ds


def _poses_world(ds, frame_ids: np.ndarray, device) -> torch.Tensor:
    """(N, K, 3) float32 world poses in metres of the dataset's keypoint
    column at ``frame_ids``, on ``device``; forward kinematics for joint
    angles."""
    kk = ds.keypoint_key
    flat = torch.as_tensor(unnormalize(ds.datadict[kk][frame_ids],
                                       ds.norm_stats), dtype=torch.float32,
                           device=device)
    if "angle" in kk:
        xyz = forward_kinematics(flat) / 1000.0
        return xyz[:, np.asarray(ds.joint_model.kps_to_use)]
    return flat.reshape(len(frame_ids), -1, 3)


def project_windows(ds, ids: np.ndarray, device):
    """Frames ``ids`` (n, T) -> (world poses (n, T, K, 3), pixels (n, T,
    K, 2)) as numpy, every frame projected with its own camera in one
    call on ``device``."""
    n, T = ids.shape
    world = _poses_world(ds, ids.ravel(), device).reshape(n, T, -1, 3)
    extr, intr = (torch.as_tensor(np.asarray(ds.datadict[k][ids]),
                                  dtype=torch.float32, device=device)
                  for k in ("extrinsics_univ", "intrinsics_univ"))
    cam = apply_affine_transform(world, extr[:, :, None])
    px = camera_projection(cam, intr)
    return world.cpu().numpy(), px.cpu().numpy()


def visualize_projection(ds, out_dir: str, n_videos: int = 3,
                         win: int = 50, seed: int = 42, device="cpu"):
    """Per window of ``win`` frames, ``test_video_kps_img#<nr>.mp4`` (the
    projected skeleton on the frames) and ``kps_3d_world#<nr>.mp4``;
    returns the paths written."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    win = min(win, len(ds))
    starts = rng.choice(max(1, len(ds) - win), size=n_videos, replace=False)
    ids = starts[:, None] + np.arange(win)
    world, px = project_windows(ds, ids, device)
    lines = ds.joint_model.total_relative_joints
    dd = ds.datadict
    written = []
    for nr in range(n_videos):
        frames = []
        for t, i in enumerate(ids[nr]):
            img = None
            p = str(dd["img_paths"][i]) if "img_paths" in dd else ""
            if p and path.exists(p):
                img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
            if img is None:
                h, w = int(dd["image_size"][i][1]), int(dd["image_size"][i][0])
                img = np.zeros((h, w, 3), np.uint8)
            frames.append(videos.add_joints_to_img(
                np.ascontiguousarray(img), px[nr, t], lines,
                color_joints=[(0, 255, 0)]))
        written.append(videos.write_video(
            np.stack(frames), path.join(out_dir,
                                        f"test_video_kps_img#{nr}.mp4")))
        p3d = path.join(out_dir, f"kps_3d_world#{nr}.mp4")
        videos.create_video_3d(world[nr], out_path=p3d, lines=lines)
        written.append(path.splitext(p3d)[0] + "." + videos.VIDEO_FORMAT)
    return written


def test_synth_grids(ds, out_dir: str, n: int = 8, seed: int = 0):
    """``synth_triplet#<nr>.png`` (pose image, stickman, appearance) of
    ``n`` random items."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    ids = rng.choice(len(ds), size=min(n, len(ds)), replace=False)
    written = []
    for nr, i in enumerate(ids):
        item = ds[int(i)]
        row = []
        for key in ("pose_img", "stickman", "app_img"):
            img = np.asarray(item[key])
            if img.ndim == 4:
                img = img[0]
            row.append(videos.frames_to_uint8(img[None])[0])
        written.append(videos.save_png(np.concatenate(row, axis=1), path.join(
            out_dir, f"synth_triplet#{nr}.png")))
    return written


def stickman_grids(ds, out_dir: str, n: int = 8, seed: int = 0):
    """``stickman_from_3d.png``: the stickmen of ``n`` random items."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    ids = rng.choice(len(ds), size=min(n, len(ds)), replace=False)
    imgs = []
    for i in ids:
        st = np.asarray(ds[int(i)]["stickman"])
        if st.ndim == 4:
            st = st[0]
        imgs.append(videos.frames_to_uint8(st[None])[0])
    return [videos.save_png(videos.make_img_grid(np.stack(imgs), n_cols=4),
                            path.join(out_dir, "stickman_from_3d.png"))]


def default_batch_grids(ds, out_dir: str, batch_size: int = 8):
    """``batch_<key>.png``: a grid of one loader batch per RGB image
    key."""
    os.makedirs(out_dir, exist_ok=True)
    sampler = SequenceSampler(ds, RandomSampler(ds, seed=0), batch_size,
                              drop_last=True)
    batch = next(iter(Loader(ds, sampler, num_workers=0)))
    written = []
    for key, arr in batch.items():
        arr = np.asarray(arr)
        if arr.ndim == 4 and arr.shape[-1] == 3:
            written.append(videos.save_png(
                videos.make_img_grid(videos.frames_to_uint8(arr), n_cols=4),
                path.join(out_dir, f"batch_{key}.png")))
    return written


def _file_dataset(name: str, dcfg, keys):
    return get_dataset({"dataset": name})(
        None, keys, (0, 0), mode="test",
        **{k: v for k, v in dcfg.items()
           if k not in ("dataset", "seq_length")})


def main(argv=None):
    from ..main import resolve_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="configs/test_datasets.yaml")
    ap.add_argument("--mode", default=None,
                    help="override general.mode from the config")
    ap.add_argument("--out", default="./test_data")
    ap.add_argument("--n_videos", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the projection (default cuda; "
                         "pass cpu to run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    config = load_config(args.config)
    dcfg = dict(config["data"])
    mode = args.mode or config["general"].get("mode", "default")
    name = str(dcfg.get("dataset", "h36m_synthetic")).lower()

    is_h36m = name in ("human3.6m", "human36m", "h36m", "h36m_synthetic",
                       "synthetic")
    has_files = bool(dcfg.get("datapath")) and path.exists(
        path.join(str(dcfg.get("datapath")), "annot_export.h5")
        if is_h36m else path.join(str(dcfg.get("datapath")), "index.p"))
    from_3d = {**dcfg, "use_3d_for_stickman": True, "train_synthesis": True,
               "seq_length": (0, 0)}

    if mode == "visualize_projection":
        ds = _build_h36m(dcfg, "test", ["keypoints", "sample_ids"])
        out = visualize_projection(ds, path.join(args.out, "human36m_full"),
                                   n_videos=args.n_videos, device=device)
    elif mode == "test_synth":
        keys = ["pose_img", "stickman", "app_img", "sample_ids"]
        if is_h36m and has_files:
            ds = _build_h36m({**dcfg, "keypoint_type": None,
                              "seq_length": (0, 0)}, "test", keys)
        elif is_h36m:
            # no image files: stickmen drawn from projected 3-D poses
            out = stickman_grids(_build_h36m(from_3d, "test",
                                             ["stickman", "sample_ids"]),
                                 path.join(args.out, name))
            for p in out:
                print(p)
            return out
        else:
            ds = _file_dataset(name, dcfg, keys)
        out = test_synth_grids(ds, path.join(args.out, name))
    else:
        if is_h36m and not has_files:
            ds = _build_h36m(from_3d, "test", ["stickman", "sample_ids"])
        elif is_h36m:
            ds = _build_h36m({**dcfg, "seq_length": (0, 0)}, "test",
                             ["pose_img", "stickman", "sample_ids"])
        else:
            ds = _file_dataset(name, dcfg,
                               ["pose_img", "stickman", "sample_ids"])
        out = default_batch_grids(ds, path.join(args.out, name))
    for p in out:
        print(p)
    return out


if __name__ == "__main__":
    main()
