"""Small image-data trees and a seeded Inception, set up for both packages
from numpy seeds.

Shared by ``tests/test_torch_inception_metrics.py``, the golden maker
``tests/make_torch_port_image_data_golden.py`` and ``chip_smoke.py``
phases [18] and [19]; it imports no JAX.

  * :func:`write_index_tree` writes a DeepFashion / Market ``index.p``
    tree of JPEGs, :func:`h36m_columns` the columns of a Human3.6M
    ``annot_export.h5`` (32 world joints in mm seen by pinhole cameras)
    and :func:`write_h36m_tree` the tree (JPEG frames and the h5, written
    by :func:`write_columns` in the subset of HDF5 that the port's
    ``data/h5lite.py`` reads, so no h5py is needed);
  * :func:`seeded_inception` fills the port's InceptionV3 from a numpy
    seed at a scale that keeps its activations alive;
  * :func:`golden_items` collates items as uint8 levels (images) and
    floats (targets), the golden's format.
"""
from __future__ import annotations

import os
import pickle
import struct
from typing import Dict, List, Sequence

import numpy as np

from behavior_driven_video_synthesis_tpu_torch.data.h5lite import (
    _SIGNATURE, _UNDEF)

# the golden's datasets: (name, data keys, dataset keywords, item ids)
S = 32
KEYS = ["pose_img", "stickman", "app_img", "sample_ids"]
GOLDEN_DATASETS = [
    ("deepfashion", "deepfashion",
     {"spatial_size": S, "data_seed": 3, "train_regressor": True,
      "reg_steps": 2}, [0, 1, 2]),
    ("deepfashion_parts", "deepfashion",
     {"spatial_size": S, "data_seed": 4, "train_regressor": True,
      "reg_steps": 2, "inplane_normalize": True, "box_factor": 1}, [0, 1]),
    ("human36m", "human3.6m",
     {"spatial_size": S, "data_seed": 5, "train_regressor": True,
      "reg_steps": 2, "keypoint_type": "keypoints_3d_world",
      "use_3d_for_stickman": True, "train_synthesis": True,
      "stickman_scale": 16, "use_person_split": True}, [0, 3]),
]
# keys whose values are images in [-1, 1] (stored as uint8 levels)
IMAGE_KEYS = ("pose_img", "stickman", "app_img", "pose_img_inplane",
              "reg_imgs")
# uint8 levels an image may differ from the golden's on another machine:
# one for every image (its decode, resize and part warp), four for the
# augmented pose image, which cv2.warpAffine makes: OpenCV 4.13's and
# 5.0's fixed-point bilinear interpolation differ by up to 4 levels on the
# same input
LEVELS = {"pose_img_inplane": 4}


def _smooth_image(rng, h, w):
    """A JPEG-friendly image: a colour gradient and blurred noise."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([xx, yy, 1 - xx], -1) * rng.uniform(80, 200, 3)
    noise = rng.rand(h // 8 + 1, w // 8 + 1, 3) * 60
    noise = np.kron(noise, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    import cv2

    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return enc.tobytes()


def index_data(n: int, size: int, seed: int):
    """(JPEG streams, index.p dict) of ``n`` images ``size`` px a side."""
    rng = np.random.RandomState(seed)
    jpegs = [encode_jpeg(_smooth_image(rng, size, size)) for _ in range(n)]
    index = {"imgs": [f"img_{i:04d}.jpg" for i in range(n)],
             "joints": rng.uniform(0.1, 0.9, (n, 18, 2)),
             "train": [i % 4 != 0 for i in range(n)]}
    return jpegs, index


def write_index_tree(root: str, jpegs: Sequence[bytes], index: Dict) -> str:
    os.makedirs(root, exist_ok=True)
    for name, data in zip(index["imgs"], jpegs):
        with open(os.path.join(root, name), "wb") as f:
            f.write(data)
    with open(os.path.join(root, "index.p"), "wb") as f:
        pickle.dump(index, f)
    return root


def _camera(i: int):
    th = 0.15 * i
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    return np.hstack([R, np.array([[50.0 * i], [-30.0], [150.0]])])


def h36m_columns(subjects=(1, 9), actions=(2, 8), cameras=(54138969,),
                 n_frames=6, image_hw=48, seed=7):
    """The columns of an ``annot_export.h5``, frame by frame: smooth
    32-joint world trajectories in mm ~2.5 m before each camera, their
    projections, and the frames' paths."""
    rng = np.random.RandomState(seed)
    cols: Dict[str, List] = {k: [] for k in (
        "frame_path", "pose_2d", "subject", "frame", "action", "subaction",
        "pose_normalized_2d", "camera", "image_size", "intrinsics_univ",
        "pose_3d", "pose_3d_world", "extrinsics_univ")}
    intr = np.array([2.2 * image_hw, image_hw / 2, 2.2 * image_hw,
                     image_hw / 2])
    K = np.array([[intr[0], 0, intr[1]], [0, intr[2], intr[3]], [0, 0, 1]])
    for ci, cam in enumerate(cameras):
        extr = _camera(ci)
        for pid in subjects:
            for act in actions:
                base = rng.randn(32, 3) * 250.0 + np.array([0, 0, 2500.0])
                freq = rng.uniform(0.05, 0.3, (32, 3))
                phase = rng.uniform(0, 2 * np.pi, (32, 3))
                t = np.arange(n_frames)[:, None, None]
                world = base + 150.0 * np.sin(freq * t + phase)
                cam_kps = world @ extr[:, :3].T + extr[:, 3]
                px = (cam_kps / cam_kps[:, :, -1:]) @ K.T
                vdir = f"S{pid}/act{act}_1/cam_{cam}"
                cols["frame_path"].append(np.asarray(
                    [f"{vdir}/frame_{i + 1:06d}.jpg".encode()
                     for i in range(n_frames)]))
                cols["pose_2d"].append(px[:, :, :2])
                cols["subject"].append(np.full(n_frames, pid))
                cols["frame"].append(np.arange(n_frames) + 1)
                cols["action"].append(np.full(n_frames, act))
                cols["subaction"].append(np.full(n_frames, 1))
                cols["pose_normalized_2d"].append(px[:, :, :2] / image_hw)
                cols["camera"].append(np.full(n_frames, cam))
                cols["image_size"].append(
                    np.tile([image_hw, image_hw], (n_frames, 1)))
                cols["intrinsics_univ"].append(np.tile(intr, (n_frames, 1)))
                cols["pose_3d"].append(cam_kps)
                cols["pose_3d_world"].append(world)
                cols["extrinsics_univ"].append(np.tile(extr, (n_frames, 1,
                                                              1)))
    return {k: np.concatenate(v) for k, v in cols.items()}


def h36m_frames(columns, seed: int = 8, image_hw: int = 48,
                encode=encode_jpeg) -> List[bytes]:
    """One JPEG stream per frame of ``columns``."""
    rng = np.random.RandomState(seed)
    return [encode(_smooth_image(rng, image_hw, image_hw))
            for _ in columns["frame_path"]]


def write_h36m_tree(root: str, columns, jpegs: Sequence[bytes]) -> str:
    for rel, data in zip(columns["frame_path"], jpegs):
        path = os.path.join(root, rel.decode())
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
    write_columns(os.path.join(root, "annot_export.h5"), columns)
    return root


# -- a flat HDF5 file without h5py ----------------------------------------
def _header(messages) -> bytes:
    """A version 1 object header holding ``messages`` [(type, data)]."""
    body = b"".join(struct.pack("<HHB3x", t, len(m) + (-len(m)) % 8, 0)
                    + m + bytes((-len(m)) % 8) for t, m in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind in "iu":
        flags = (1 if dtype.byteorder == ">" else 0) | (
            0x08 if dtype.kind == "i" else 0)
        return struct.pack("<BBBBIHH", 0x10, flags, 0, 0, size, 0, 8 * size)
    if dtype.kind == "f" and size in (4, 8):
        exp_loc, exp_size, mant, bias = ((23, 8, 23, 127) if size == 4
                                         else (52, 11, 52, 1023))
        flags = 0x20 | (1 if dtype.byteorder == ">" else 0)
        return struct.pack("<BBBBIHHBBBBI", 0x11, flags, 8 * size - 1, 0,
                           size, 0, 8 * size, exp_loc, exp_size, 0, mant,
                           bias)
    if dtype.kind == "S":
        return struct.pack("<BBBBI", 0x13, 1, 0, 0, size)   # null-padded
    raise ValueError(f"dtype {dtype} is not written")


def write_columns(path: str, columns: Dict[str, np.ndarray]) -> None:
    """Write each array of ``columns`` as a contiguous dataset of the root
    group of a new HDF5 file at ``path``."""
    names = sorted(columns)
    arrays = [np.ascontiguousarray(columns[n]) for n in names]
    heap = bytearray(b"\0" * 8)                 # offset 0: the empty name
    name_at = []
    for n in names:
        name_at.append(len(heap))
        b = n.encode() + b"\0"
        heap += b + bytes((-len(b)) % 8)
    leaf_k = max(4, (len(names) + 1) // 2)
    internal_k = 16
    superblock_size = 56 + 40
    root = superblock_size
    root_size = len(_header([(0x11, bytes(16))]))
    heap_hdr = root + root_size
    heap_data = heap_hdr + 32
    btree = heap_data + len(heap)
    btree_size = 24 + (2 * internal_k + 1) * 8 + 2 * internal_k * 8
    snod = btree + btree_size
    pos = snod + 8 + 2 * leaf_k * 40
    headers, data_at = [], []
    for a in arrays:
        size = len(_header([(0x01, bytes(8 + 8 * a.ndim)),
                            (0x03, _datatype(a.dtype)), (0x08, bytes(18))]))
        headers.append(pos)
        data_at.append(pos + size)
        pos += size + a.nbytes + (-a.nbytes) % 8
    out = bytearray(pos)
    out[:superblock_size] = (
        _SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                 leaf_k, internal_k, 0)
        + struct.pack("<QQQQ", 0, _UNDEF, pos, _UNDEF)
        + struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree,
                                                            heap_hdr))
    out[root:heap_hdr] = _header([(0x11, struct.pack("<QQ", btree,
                                                     heap_hdr))])
    # a free-list offset of 1 is the library's "no free block"
    out[heap_hdr:heap_data] = b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap),
                                                   1, heap_data)
    out[heap_data:btree] = heap
    out[btree:btree + 24 + 24] = (
        b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _UNDEF, _UNDEF)
        + struct.pack("<QQQ", 0, snod, name_at[-1] if names else 0))
    out[snod:snod + 8] = b"SNOD" + struct.pack("<BBH", 1, 0, len(names))
    for i, (a, h) in enumerate(zip(arrays, headers)):
        e = snod + 8 + 40 * i
        out[e:e + 24] = struct.pack("<QQII", name_at[i], h, 0, 0)
        space = struct.pack("<BBBB4x", 1, a.ndim, 0, 0) + b"".join(
            struct.pack("<Q", s) for s in a.shape)
        layout = struct.pack("<BBQQ", 3, 1, data_at[i] if a.nbytes else
                             _UNDEF, a.nbytes)
        hdr = _header([(0x01, space), (0x03, _datatype(a.dtype)),
                       (0x08, layout)])
        out[h:h + len(hdr)] = hdr
        out[data_at[i]:data_at[i] + a.nbytes] = a.tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))


def seeded_inception(seed: int = 0, device=None):
    """The port's InceptionV3 with logits, its weights drawn from numpy
    seed ``seed`` at a scale that keeps the activations alive through the
    94 BasicConv2d, BatchNorm statistics away from (0, 1); eval mode."""
    import torch

    from behavior_driven_video_synthesis_tpu_torch.models.inception import (
        InceptionV3Features)

    rng = np.random.RandomState(seed)
    model = InceptionV3Features(with_logits=True)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            shape = tuple(t.shape)
            if leaf == "num_batches_tracked":
                continue
            if leaf == "running_var":
                v = 0.5 + rng.rand(*shape)
            elif leaf == "weight" and ".bn." in name:
                v = 1.0 + 0.1 * rng.randn(*shape)
            elif t.dim() == 1:
                v = 0.1 * rng.randn(*shape)
            else:
                v = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    return model.to(device).eval()


def inception_inputs(seed: int, n: int = 2, size: int = 256):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


def fid_features(seed: int):
    rng = np.random.RandomState(seed)
    return (rng.randn(40, 16).astype(np.float32),
            (rng.randn(30, 16) * 1.3 + 0.4).astype(np.float32))


def crop_inputs(seed: int):
    """Keypoints of a box inside the image, one leaving it and a
    degenerate one, and the images (3, 24, 20, 3)."""
    rng = np.random.RandomState(seed)
    kps = np.stack([rng.uniform(4, 20, (18, 2)), rng.uniform(-6, 28, (18, 2)),
                    np.full((18, 2), 10.0)]).astype(np.float32)
    return kps, rng.uniform(-1, 1, (3, 24, 20, 3)).astype(np.float32)


def to_levels(x: np.ndarray) -> np.ndarray:
    """Images in [-1, 1] made from uint8 -> those uint8 levels."""
    return np.round((np.asarray(x, np.float64) + 1) * 127.5).astype(np.uint8)


def golden_items(collated: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: to_levels(v) if k in IMAGE_KEYS else np.asarray(v)
            for k, v in collated.items()}


# -- the port against the golden ----------------------------------------------
def _unpack(data, offsets):
    return [data[a:b].tobytes() for a, b in zip(offsets[:-1], offsets[1:])]


def write_golden_trees(golden: Dict[str, np.ndarray], root: str):
    """The golden's DeepFashion and Human3.6M trees under ``root``."""
    n = len(golden["df/train"])
    index = {"imgs": [f"img_{i:04d}.jpg" for i in range(n)],
             "joints": golden["df/joints"],
             "train": [bool(t) for t in golden["df/train"]]}
    cols = {k[len("h36m/"):]: golden[k] for k in golden
            if k.startswith("h36m/") and k not in ("h36m/jpeg",
                                                    "h36m/offsets")}
    return {"df": write_index_tree(
                os.path.join(root, "df"),
                _unpack(golden["df/jpeg"], golden["df/offsets"]), index),
            "h36m": write_h36m_tree(
                os.path.join(root, "h36m"), cols,
                _unpack(golden["h36m/jpeg"], golden["h36m/offsets"]))}


def port_items(trees, device) -> Dict[str, np.ndarray]:
    """The port's items of ``GOLDEN_DATASETS`` on those trees, the part
    stacks made on ``device`` as the VUNet driver makes them."""
    import torch

    from behavior_driven_video_synthesis_tpu_torch.data import get_dataset
    from behavior_driven_video_synthesis_tpu_torch.data.loader import collate
    from behavior_driven_video_synthesis_tpu_torch.data.parts import (
        PART_SUFFIXES, finish_part_stacks)

    out = {}
    for name, dataset, kw, ids in GOLDEN_DATASETS:
        root = trees["h36m" if dataset == "human3.6m" else "df"]
        ds = get_dataset({"dataset": dataset})(
            None, list(KEYS), (0, 0), datapath=root, **kw)
        batch = {k: v if k.endswith(PART_SUFFIXES[1:])
                 else torch.from_numpy(v).to(device)
                 for k, v in collate([ds[i] for i in ids]).items()}
        batch = finish_part_stacks(batch, ds.spatial_size // 2 **
                                   ds.box_factor)
        for k, v in golden_items({k: v.cpu().numpy()
                                  for k, v in batch.items()}).items():
            out[f"items/{name}/{k}"] = v
    return out


def check_against_golden(golden: Dict[str, np.ndarray], device, root: str
                         ) -> Dict[str, float]:
    """The port on ``device`` against the golden: worst error over its
    tolerance for the items (every image within 1 uint8 level, the
    augmented pose image within 4: see ``LEVELS``; targets rtol 1e-6),
    Inception (rtol 1e-4, atol 1e-4 x the largest magnitude), IS
    (1e-4 relative), FID (1e-5 relative) and the crop (atol 1e-5); also
    the share of image values equal to the golden's."""
    import torch

    from behavior_driven_video_synthesis_tpu_torch.metrics.fid import (
        fid_from_features)
    from behavior_driven_video_synthesis_tpu_torch.metrics.inception_score \
        import inception_score_from_logits
    from behavior_driven_video_synthesis_tpu_torch.models.inception import (
        inception_features)
    from behavior_driven_video_synthesis_tpu_torch.utils.boxes import (
        bounding_box_batch)
    worst = {"items": 0.0}
    equal, total = 0, 0
    mine = port_items(write_golden_trees(golden, root), device)
    want = {k for k in golden if k.startswith("items/")}
    if set(mine) != want:
        raise ValueError(f"item keys {sorted(set(mine) ^ want)} differ")
    for k in sorted(want):
        a, b = mine[k], golden[k]
        if a.shape != b.shape:
            raise ValueError(f"{k}: shape {a.shape} != {b.shape}")
        key = k.rsplit("/", 1)[-1]
        if key in IMAGE_KEYS:
            d = np.abs(a.astype(int) - b.astype(int))
            worst["items"] = max(worst["items"],
                                 float(d.max()) / LEVELS.get(key, 1))
            equal, total = equal + int((d == 0).sum()), total + d.size
        else:
            err = np.abs(a.astype(np.float64) - b) / (
                1e-6 * np.abs(b) + 1e-12)
            worst["items"] = max(worst["items"], float(err.max()))
    model = seeded_inception(int(golden["inception/seed"]), device)
    with torch.no_grad():
        feats, logits = inception_features(model, torch.from_numpy(
            inception_inputs(int(golden["inception/input_seed"]))).to(
                device))
    for name, t in (("features", feats), ("logits", logits)):
        ref = golden[f"inception/{name}"]
        tol = 1e-4 * np.abs(ref) + 1e-4 * np.abs(ref).max()
        worst[f"inception_{name}"] = float(
            (np.abs(t.cpu().numpy() - ref) / tol).max())
    worst["is"] = abs(inception_score_from_logits(logits)[0]
                      - float(golden["is/value"])) / (
        1e-4 * float(golden["is/value"]))
    a, b = fid_features(int(golden["fid/seed"]))
    fid = fid_from_features(torch.from_numpy(a).to(device),
                            torch.from_numpy(b).to(device))
    worst["fid"] = abs(fid - float(golden["fid/value"])) / (
        1e-5 * float(golden["fid/value"]))
    kps, imgs = crop_inputs(int(golden["crop/seed"]))
    crop = bounding_box_batch(torch.from_numpy(kps).to(device),
                              torch.from_numpy(imgs).to(device), 16)
    worst["crop"] = float(np.abs(crop.cpu().numpy()
                                 - golden["crop/out"]).max()) / 1e-5
    worst["images_equal_share"] = equal / total
    return worst
