"""Offline Human3.6M processing: frames by ffmpeg, poses from the CDF
files, cameras by least squares, all into ``annot_export.h5``.

Counterpart of ``behavior_driven_video_synthesis_tpu/data/prep/
process.py``: for each (subject, action, subaction, camera) the frames
``img_%06d.jpg`` come out of the video (ffmpeg), the universal mono 3D
poses out of the CDF files (cdflib), the intrinsics by least squares from
2D<->3D correspondences and the extrinsics by a rigid fit, and every
view's columns go into ``annot_export.h5`` in the layout that
``data/human36m.py:Human36mDataset`` reads::

    python -m behavior_driven_video_synthesis_tpu_torch.data.prep.process \\
        -d <datadir> [--metadata metadata.xml]

The file is written by ``data/h5lite.py:write_columns``, one column at a
time, so that no h5py is needed and the export is not held twice in
memory.  cdflib and ffmpeg are needed only to read the raw data: without
them :func:`read_cdf_poses`, the 2D-pose read of :func:`process_view` and
:func:`extract_frames` raise an ``ImportError`` or ``FileNotFoundError``
that names the tool.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
from os import listdir, makedirs, path
from shutil import move
from tempfile import TemporaryDirectory

import numpy as np

from ..h5lite import write_columns
from .metadata import H36MMetadata

INCLUDED_SUBJECTS = {"S1": 1, "S5": 5, "S6": 6, "S7": 7, "S8": 8,
                     "S9": 9, "S11": 11}


def infer_camera_intrinsics(points2d: np.ndarray,
                            points3d: np.ndarray) -> np.ndarray:
    """Least-squares (f_x, x_0, f_y, y_0) from 2D<->3D correspondences."""
    pose2d = points2d.reshape(-1, 2)
    pose3d = points3d.reshape(-1, 3)
    x3d = np.stack([pose3d[:, 0], pose3d[:, 2]], axis=-1)
    x2d = pose2d[:, 0] * pose3d[:, 2]
    alpha_x, x_0 = np.linalg.lstsq(x3d, x2d, rcond=-1)[0].flatten()
    y3d = np.stack([pose3d[:, 1], pose3d[:, 2]], axis=-1)
    y2d = pose2d[:, 1] * pose3d[:, 2]
    alpha_y, y_0 = np.linalg.lstsq(y3d, y2d, rcond=-1)[0].flatten()
    return np.array([alpha_x, x_0, alpha_y, y_0])


def _cdflib():
    try:
        import cdflib
    except ImportError as e:
        raise ImportError(
            "cdflib is required to read the Human3.6M CDF poses; install it "
            "in the prep environment (not needed to train)") from e
    return cdflib


def read_cdf_poses(cdf_path: str) -> np.ndarray:
    """(N, 32, 3) poses of a CDF file (cdflib)."""
    poses = np.array(_cdflib().CDF(cdf_path)["Pose"])
    return poses.reshape(poses.shape[1], 32, 3)


def extract_frames(video_file: str, frames_dir: str, frames: np.ndarray):
    """The video's frames ``frames`` (1-based) as ``img_%06d.jpg`` under
    ``frames_dir`` (ffmpeg); nothing if they are all there."""
    makedirs(frames_dir, exist_ok=True)
    existing = set(listdir(frames_dir))
    if all(f"img_{i:06d}.jpg" in existing for i in frames):
        return
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise FileNotFoundError("ffmpeg is required to extract the "
                                "Human3.6M frames; it is not on the PATH")
    with TemporaryDirectory() as tmp:
        subprocess.call([ffmpeg, "-nostats", "-loglevel", "error",
                         "-i", video_file, "-qscale:v", "3",
                         path.join(tmp, "img_%06d.jpg")])
        for i in frames:
            fn = f"img_{i:06d}.jpg"
            move(path.join(tmp, fn), path.join(frames_dir, fn))


def process_view(metadata: H36MMetadata, ddir: str, out_dir: str,
                 subject: str, action: str, subaction: str, camera: str):
    """(universal 3D poses, world 3D poses or None, 2D poses or None, frame
    paths relative to ``ddir``) of one view, its frames extracted."""
    subj_dir = path.join(ddir, "extracted", subject)
    base = metadata.get_base_filename(subject, action, subaction, camera)
    poses_3d_univ = read_cdf_poses(
        path.join(subj_dir, "Poses_D3_Positions_mono_universal",
                  base + ".cdf"))
    world_cdf = path.join(subj_dir, "Poses_D3_Positions",
                          base.split(".")[0] + ".cdf")
    poses_3d_world = (read_cdf_poses(world_cdf)
                      if path.exists(world_cdf) else None)
    d2_cdf = path.join(subj_dir, "Poses_D2_Positions", base + ".cdf")
    pose_2d = None
    if path.exists(d2_cdf):
        raw = np.array(_cdflib().CDF(d2_cdf)["Pose"])
        pose_2d = raw.reshape(raw.shape[1], 32, 2)
    frames = np.arange(len(poses_3d_univ)) + 1
    frames_dir = path.join(out_dir, "imageSequence", camera)
    extract_frames(path.join(subj_dir, "Videos", base + ".mp4"),
                   frames_dir, frames)
    frame_paths = [path.relpath(path.join(frames_dir, f"img_{i:06d}.jpg"),
                                ddir) for i in frames]
    return poses_3d_univ, poses_3d_world, pose_2d, frame_paths


def process_all(ddir: str, metadata_path: str):
    """Every view of the included subjects into
    ``<ddir>/annot_export.h5``; a view that fails is reported and
    skipped."""
    metadata = H36MMetadata(metadata_path)
    subactions = []
    for subject in INCLUDED_SUBJECTS:
        subactions += [
            (subject, a, s)
            for a, s in metadata.sequence_mappings[subject]
            if int(a) > 1  # exclude '_ALL'
        ]
    rows = []
    for subject, action, subaction in subactions:
        out_dir = path.join(ddir, "processed", "all", subject,
                            metadata.action_names[action] + "-" + subaction)
        makedirs(out_dir, exist_ok=True)
        for camera in metadata.camera_ids:
            try:
                univ, world, pose_2d, frame_paths = process_view(
                    metadata, ddir, out_dir, subject, action, subaction,
                    camera)
                rows.append(view_annotation_rows(
                    subject_id=INCLUDED_SUBJECTS[subject],
                    action_id=int(action), subaction_id=int(subaction),
                    camera_id=int(camera), frame_paths=frame_paths,
                    poses_3d_univ=univ, poses_3d_world=world,
                    pose_2d=pose_2d))
            except Exception as e:  # noqa: BLE001 — skip broken sequences
                print(f"!!! skipping {(subject, action, subaction, camera)}:"
                      f" {e}")
    if rows:
        write_annot_export(path.join(ddir, "annot_export.h5"), rows)


def fit_extrinsics(points_world: np.ndarray,
                   points_cam: np.ndarray) -> np.ndarray:
    """Least-squares rigid [R|t] with cam = R @ world + t (Kabsch), from
    world<->camera correspondences, so that the export carries its own
    extrinsics."""
    w = points_world.reshape(-1, 3)
    c = points_cam.reshape(-1, 3)
    wm, cm = w.mean(0), c.mean(0)
    H = (w - wm).T @ (c - cm)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    t = cm - R @ wm
    return np.hstack([R, t[:, None]])


def view_annotation_rows(*, subject_id: int, action_id: int,
                         subaction_id: int, camera_id: int,
                         frame_paths, poses_3d_univ: np.ndarray,
                         poses_3d_world: np.ndarray = None,
                         extrinsics: np.ndarray = None,
                         intrinsics: np.ndarray = None,
                         pose_2d: np.ndarray = None,
                         image_size=(1000, 1000)):
    """One (subject, action, subaction, camera) view's annotation columns
    in the layout ``Human36mDataset`` reads.

    poses_3d_univ: (N, 32, 3) camera-frame millimetres.  Of pose_2d and
    intrinsics one may be omitted: intrinsics are then inferred by least
    squares, pose_2d projected through the pinhole.  Extrinsics are fitted
    from world<->camera correspondences when not given.  Columns of
    another frame count than poses_3d_univ raise ``ValueError``.
    """
    n = len(poses_3d_univ)
    # every per-frame column must have the view's frame count, or the
    # columns come out misaligned and the loader reads them silently
    for name, col in (("frame_paths", frame_paths), ("pose_2d", pose_2d),
                      ("poses_3d_world", poses_3d_world)):
        if col is not None and len(col) != n:
            raise ValueError(f"{name} has {len(col)} frames, poses_3d_univ "
                             f"{n}")
    if intrinsics is None:
        if pose_2d is None:
            raise ValueError("need pose_2d or intrinsics")
        intrinsics = infer_camera_intrinsics(pose_2d, poses_3d_univ)
    intrinsics = np.asarray(intrinsics, np.float64)
    if pose_2d is None:
        p = poses_3d_univ / poses_3d_univ[..., 2:]
        pose_2d = np.stack([
            p[..., 0] * intrinsics[0] + intrinsics[1],
            p[..., 1] * intrinsics[2] + intrinsics[3],
        ], axis=-1)
    if poses_3d_world is None:
        poses_3d_world = poses_3d_univ  # mono exports have no world frame
    if extrinsics is None:
        extrinsics = fit_extrinsics(poses_3d_world, poses_3d_univ)
    image_size = np.asarray(image_size, np.float64)
    return {
        "frame_path": np.asarray(
            [str(p).encode("utf-8") for p in frame_paths]),
        "pose_2d": np.asarray(pose_2d, np.float64),
        "subject": np.full(n, subject_id, np.int64),
        "frame": np.arange(1, n + 1, dtype=np.int64),  # 1-based on disk
        "action": np.full(n, action_id, np.int64),
        "subaction": np.full(n, subaction_id, np.int64),
        "pose_normalized_2d": np.asarray(pose_2d, np.float64)
        / image_size[None, None, :],
        "camera": np.full(n, camera_id, np.int64),
        "image_size": np.tile(image_size, (n, 1)),
        "intrinsics_univ": np.tile(intrinsics, (n, 1)),
        "pose_3d": np.asarray(poses_3d_univ, np.float64),
        "pose_3d_world": np.asarray(poses_3d_world, np.float64),
        "extrinsics_univ": np.tile(np.asarray(extrinsics, np.float64),
                                   (n, 1, 1)),
    }


def write_annot_export(out_file: str, view_rows) -> str:
    """Join the views' columns and write ``annot_export.h5``
    (``data/h5lite.py``): one column joined and written at a time.  Byte
    strings of several widths join at the widest, as numpy joins them."""
    view_rows = list(view_rows)
    if not view_rows:
        raise ValueError("no views to export")
    makedirs(path.dirname(path.abspath(out_file)), exist_ok=True)
    columns = ((k, np.concatenate([r[k] for r in view_rows], axis=0))
               for k in view_rows[0])
    return write_columns(out_file, columns)


if __name__ == "__main__":
    p = argparse.ArgumentParser(
        description="process extracted Human3.6M views into "
                    "<datadir>/annot_export.h5")
    p.add_argument("-d", "--datadir", required=True)
    p.add_argument("--metadata", default="metadata.xml")
    args = p.parse_args()
    process_all(args.datadir, args.metadata)
