"""The port's image datasets against the JAX package's, on the CPU.

The same files (a DeepFashion / Market ``index.p`` tree and a Human3.6M
``annot_export.h5`` tree, written by the JAX tests' own fixtures) and the
same ``data_seed`` go through both packages:

  * the port's libjpeg binding (``data/native.py``) decodes byte-equal to
    the JAX package's at scale denominators 1 and 2, one stream and a
    batch; a file with an EXIF orientation goes to cv2 in both;
  * DeepFashion, Market and Human3.6M items are equal, key by key, in the
    same order of random draws: ``pose_img``, ``app_img``, ``stickman``
    (2D, from 3D, with per-line colours), the augmented
    ``pose_img_inplane``, ``use_crops``, ``reg_imgs`` and ``reg_targets``
    exactly; the part stacks, which an item leaves to the device path
    (``finish_part_stacks``, run here on the CPU for an item and for a
    batch), within 1 uint8 level (2/255 in [-1, 1]) of the JAX package's
    cv2 / native warp;
  * ``bounding_box_batch`` and ``part_crops_batch`` within 1e-5, the host
    boxes and the sampling distributions exactly;
  * ``data/h5lite.py`` reads what h5py writes and what the tests' writer
    (``torch_port_image_data.write_columns``, which h5py reads) writes;
    without h5py the dataset reads its ``annot_export.h5`` with it;
  * the stickman from joint angles raises, naming A3.
"""
import os
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")

import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.data import native as jnative
from behavior_driven_video_synthesis_tpu.data.deepfashion import (
    DeepFashionDataset as JaxDeepFashion)
from behavior_driven_video_synthesis_tpu.data.human36m import (
    Human36mDataset as JaxHuman36m)
from behavior_driven_video_synthesis_tpu.data.market import (
    MarketDataset as JaxMarket)
from behavior_driven_video_synthesis_tpu.utils import boxes as jboxes
from behavior_driven_video_synthesis_tpu.utils import sampling as jsampling

from behavior_driven_video_synthesis_tpu_torch.data import (
    base, get_dataset, h5lite, native)
from behavior_driven_video_synthesis_tpu_torch.data.deepfashion import (
    DeepFashionDataset)
from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
    Human36mDataset)
from behavior_driven_video_synthesis_tpu_torch.data.loader import (
    Loader, collate)
from behavior_driven_video_synthesis_tpu_torch.data.market import (
    MarketDataset)
from behavior_driven_video_synthesis_tpu_torch.data.parts import (
    finish_part_stacks)
from behavior_driven_video_synthesis_tpu_torch.data.samplers import (
    RandomSampler, SequenceSampler)
from behavior_driven_video_synthesis_tpu_torch.utils import boxes, sampling

import torch_port_image_data as TI
from test_file_datasets import make_index_fixture
from test_h36m_files import make_h36m_fixture
from torch_port_threads import one_torch_thread  # noqa: F401

S = 64
STACK_TOL = 2 / 255 + 1e-6      # one uint8 level in [-1, 1]
KEYS = ["pose_img", "stickman", "app_img", "sample_ids"]


@pytest.fixture(scope="module")
def df_root(tmp_path_factory):
    return make_index_fixture(str(tmp_path_factory.mktemp("df")), n=12)


@pytest.fixture(scope="module")
def h36m_root(tmp_path_factory):
    return make_h36m_fixture(str(tmp_path_factory.mktemp("h36m")))


def _finished(item, ds):
    """An item of the port with its part stacks made, on the CPU, as the
    VUNet driver makes them for a batch on the device."""
    placed = {k: v if k.endswith((":parts_mats", ":parts_valid"))
              else torch.from_numpy(np.asarray(v)) for k, v in item.items()}
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in finish_part_stacks(
                placed, ds.spatial_size // 2 ** ds.box_factor).items()}


def _same_items(mine, ref, ids, stacks=()):
    """Items ``ids`` of both datasets, fetched in the same order: equal,
    the keys ``stacks`` (made from the port's item by the device path's
    warp) within one uint8 level."""
    for i in ids:
        a, b = _finished(mine[i], mine), ref[i]
        assert a.keys() == b.keys(), (sorted(a), sorted(b))
        for k in b:
            assert np.asarray(a[k]).shape == np.asarray(b[k]).shape, k
            if k in stacks:
                np.testing.assert_allclose(a[k], b[k], rtol=0,
                                           atol=STACK_TOL, err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")


def _jpeg(rng, h=96, w=80):
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 92])
    assert ok
    return enc.tobytes()


def _with_orientation(data, value=6):
    """``data`` with a minimal APP1 EXIF segment carrying Orientation."""
    tiff = (b"II*\x00\x08\x00\x00\x00\x01\x00"
            b"\x12\x01\x03\x00\x01\x00\x00\x00"
            + value.to_bytes(2, "little") + b"\x00\x00\x00\x00\x00\x00")
    payload = b"Exif\x00\x00" + tiff
    return (data[:2] + b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big")
            + payload + data[2:])


# -- the decode ----------------------------------------------------------------
def test_decode_is_byte_equal_to_jax():
    if not (native.decode_available() and jnative.decode_available()):
        pytest.skip("libjpeg's headers are not installed: "
                    f"{native.build_error()}")
    rng = np.random.RandomState(0)
    streams = [_jpeg(rng, 96 + 13 * i, 80 + 7 * i) for i in range(3)]
    for denom in (1, 2):
        for s in streams:
            np.testing.assert_array_equal(native.decode_jpeg(s, denom),
                                          jnative.decode_jpeg(s, denom))
        for a, b in zip(native.decode_jpeg_batch(streams, denom, 2),
                        jnative.decode_jpeg_batch(streams, denom, 2)):
            np.testing.assert_array_equal(a, b)
    tagged = _with_orientation(streams[0])
    for s in (streams[0], tagged, tagged[:40]):
        assert native.jpeg_orientation(s) == jnative.jpeg_orientation(s)
    assert native.jpeg_dims(tagged) == jnative.jpeg_dims(tagged) == (96, 80)
    assert [native.pick_scale_denom(1000, 1000, m) for m in (256, 125)] \
        == [jnative.pick_scale_denom(1000, 1000, m) for m in (256, 125)] \
        == [2, 8]
    with pytest.raises(ValueError):
        native.decode_jpeg(streams[0][:40])


def test_an_exif_rotated_file_goes_to_cv2_in_both(tmp_path):
    rng = np.random.RandomState(1)
    plain, rotated = str(tmp_path / "plain.jpg"), str(tmp_path / "rot.jpg")
    data = _jpeg(rng, 96, 64)
    with open(plain, "wb") as f:
        f.write(data)
    with open(rotated, "wb") as f:
        f.write(_with_orientation(data))
    mine = base.BaseDataset(None, "train", (0, 0), [], None, spatial_size=32)
    ref = JaxDeepFashion(None, [], (0, 0), spatial_size=32)
    for ds in (mine, ref):
        ds.datadict["img_paths"] = np.asarray([plain, rotated])
    base.DECODES.clear()
    for idx in (0, 1):
        np.testing.assert_array_equal(mine._load_image_rgb(idx, min_dim=32),
                                      ref._load_image_rgb(idx, min_dim=32))
    # orientation 6: cv2 turns the 96 x 64 image a quarter turn
    assert mine._load_image_rgb(1, min_dim=32).shape == (64, 96, 3)
    np.testing.assert_array_equal(
        mine._load_image_rgb(1), cv2.imread(rotated)[:, :, ::-1])
    assert base.DECODES["cv2"] >= 2
    assert base.DECODES["native"] == (1 if native.decode_available() else 0)


# -- DeepFashion and Market -----------------------------------------------------
@pytest.mark.parametrize("options", [
    {},
    {"inplane_normalize": True, "box_factor": 2},
    {"use_crops": True, "diff_line_colors": True, "reg_steps": 1},
], ids=["augmented", "part_stacks", "crops_line_colors"])
def test_deepfashion_items_equal_jax(df_root, options):
    kw = {"datapath": df_root, "spatial_size": S, "data_seed": 3,
          "train_regressor": True, "reg_steps": 3, **options}
    for mode in ("train", "test"):
        mine = DeepFashionDataset(None, list(KEYS), (0, 0), mode=mode, **kw)
        ref = JaxDeepFashion(None, list(KEYS), (0, 0), mode=mode, **kw)
        assert len(mine) == len(ref) > 0
        np.testing.assert_array_equal(mine.datadict["map_ids"],
                                      ref.datadict["map_ids"])
        _same_items(mine, ref, [0, len(ref) - 1, 1],
                    stacks=("app_img", "reg_imgs"))


def test_market_items_equal_jax(tmp_path):
    root = make_index_fixture(str(tmp_path / "market"), n=8, size=128,
                              seed=1)
    keys = ["pose_img", "stickman", "app_img", "pose_img_inplane"]
    mine = MarketDataset(None, list(keys), (0, 0), datapath=root,
                         spatial_size=128, data_seed=0)
    ref = JaxMarket(None, list(keys), (0, 0), datapath=root,
                    spatial_size=128, data_seed=0)
    _same_items(mine, ref, range(3))
    assert get_dataset({"dataset": "Market1501"}) is MarketDataset
    assert get_dataset({"dataset": "deepfashion"}) is DeepFashionDataset
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset({"dataset": "kinetics"})


def test_device_part_stacks_of_a_batch_equal_jax(df_root):
    """The loader's batch with the stacks left to the device path, made
    there in one gather, against the JAX items of the same draws."""
    kw = {"datapath": df_root, "spatial_size": S, "data_seed": 5,
          "inplane_normalize": True, "train_regressor": True,
          "reg_steps": 2}
    mine = DeepFashionDataset(None, list(KEYS), (0, 0), **kw)
    ref = JaxDeepFashion(None, list(KEYS), (0, 0), **kw)
    sampler = SequenceSampler(mine, RandomSampler(mine, seed=0), 4)
    ids = next(iter(sampler))
    batch = next(iter(Loader(mine, [ids], num_workers=1)))
    assert batch["app_img:parts_src"].shape == (4, S, S, 3)
    placed = {k: v if k.endswith((":parts_mats", ":parts_valid"))
              else torch.from_numpy(v) for k, v in batch.items()}
    placed = finish_part_stacks(placed, S // 4)
    assert not any(":parts_" in k for k in placed)
    want = collate([ref[i] for i in ids])
    assert placed.keys() == want.keys()
    for k in want:
        got = placed[k].numpy()
        assert got.shape == want[k].shape, k
        np.testing.assert_allclose(got, want[k], rtol=0, atol=STACK_TOL,
                                   err_msg=k)


# -- Human3.6M -------------------------------------------------------------------
@pytest.mark.parametrize("options", [
    {}, {"use_3d_for_stickman": True, "train_synthesis": True}],
    ids=["stickman_2d", "stickman_from_3d"])
def test_human36m_items_equal_jax(h36m_root, options):
    kw = {"datapath": h36m_root, "spatial_size": S, "data_seed": 2,
          "keypoint_type": "keypoints_3d_world", "train_regressor": True,
          "reg_steps": 3, **options}
    mine = Human36mDataset(None, list(KEYS), (0, 0), **kw)
    ref = JaxHuman36m(None, list(KEYS), (0, 0), **kw)
    assert len(mine) == len(ref) > 0
    _same_items(mine, ref, [0, 17, len(ref) - 1])
    item = mine[5]
    assert item["reg_targets"].shape == (3, 17, 2)
    assert np.abs(item["stickman"]).max() > 0.3          # something drawn


def test_human36m_reads_its_h5_without_h5py(h36m_root, monkeypatch):
    kw = {"datapath": h36m_root, "spatial_size": S, "data_seed": 0,
          "keypoint_type": "keypoints_3d_world"}
    with_h5py = Human36mDataset(None, ["pose_img"], (0, 0), **kw)
    monkeypatch.setitem(sys.modules, "h5py", None)
    without = Human36mDataset(None, ["pose_img"], (0, 0), **kw)
    assert with_h5py.datadict.keys() == without.datadict.keys()
    for k, v in with_h5py.datadict.items():
        np.testing.assert_array_equal(without.datadict[k], v, err_msg=k)


def test_the_stickman_from_joint_angles_names_a3():
    ds = Human36mDataset(None, ["stickman"], (0, 0),
                         keypoint_type="angle_world_expmap",
                         use_3d_for_stickman=True, train_synthesis=True)
    with pytest.raises(NotImplementedError, match="A3"):
        ds._output_dict["stickman"]([0])
    with pytest.raises(ValueError, match="use_3d_for_stickman"):
        Human36mDataset(None, ["stickman"], (0, 0),
                        keypoint_type="keypoints_3d_world",
                        use_3d_for_stickman=True)


def test_h5lite_reads_and_writes_what_h5py_does(tmp_path):
    rng = np.random.RandomState(0)
    cols = {"frame_path": np.asarray([b"S1/a/frame_000001.jpg", b"S9/b.jpg",
                                      b"c"]),
            "pose_3d_world": rng.randn(3, 32, 3), "subject": np.array([1, 5,
                                                                       9]),
            "frame": np.arange(3, dtype=np.int32),
            "image_size": rng.rand(3, 2).astype(np.float32),
            "flags": np.arange(5, dtype=np.uint8), "empty": np.zeros((0, 3)),
            **{f"extra_{i:02d}": rng.randn(2, i + 1) for i in range(12)}}
    with h5py.File(tmp_path / "by_h5py.h5", "w") as f:
        for k, v in cols.items():
            f.create_dataset(k, data=v)
    TI.write_columns(str(tmp_path / "by_h5lite.h5"), cols)
    with h5py.File(tmp_path / "by_h5lite.h5", "r") as f:
        written = {k: np.asarray(f[k]) for k in f.keys()}
    for got in (h5lite.read_columns(str(tmp_path / "by_h5py.h5")), written,
                h5lite.read_columns(str(tmp_path / "by_h5lite.h5"))):
        assert got.keys() == cols.keys()
        for k, v in cols.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    with open(tmp_path / "not.h5", "wb") as f:
        f.write(b"\0" * 64)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        h5lite.read_columns(str(tmp_path / "not.h5"))


# -- boxes and sampling ------------------------------------------------------------
def test_boxes_match_jax():
    rng = np.random.RandomState(0)
    imgs = rng.uniform(-1, 1, (3, 48, 40, 3)).astype(np.float32)
    # one box inside the image, one leaving it, one degenerate
    kps = np.stack([rng.uniform(10, 30, (18, 2)),
                    rng.uniform(-10, 55, (18, 2)),
                    np.full((18, 2), 20.0)]).astype(np.float32)
    for out_size, relax in ((32, 0.1), (17, 0.3)):
        np.testing.assert_allclose(
            boxes.bounding_box_batch(torch.from_numpy(kps),
                                     torch.from_numpy(imgs), out_size,
                                     relax).numpy(),
            np.asarray(jboxes.bounding_box_batch(
                jnp.asarray(kps), jnp.asarray(imgs), out_size, relax)),
            rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        boxes.part_crops_batch(torch.from_numpy(kps), torch.from_numpy(imgs),
                               [0, 14, 15], 16).numpy(),
        np.asarray(jboxes.part_crops_batch(jnp.asarray(kps),
                                           jnp.asarray(imgs), [0, 14, 15],
                                           16)), rtol=0, atol=1e-5)
    img = (rng.rand(48, 40, 3) * 255).astype(np.uint8)
    for k in kps:
        a, b = (boxes.get_bounding_box(k, img.shape),
                jboxes.get_bounding_box(k, img.shape))
        assert a["bbox"] == b["bbox"]
        np.testing.assert_array_equal(a["pads"], b["pads"])
        np.testing.assert_array_equal(boxes.crop_with_bbox(img, k),
                                      jboxes.crop_with_bbox(img, k))


def test_sampling_distributions_match_jax():
    rng = np.random.RandomState(0)
    kps = rng.rand(6, 18, 2)
    kps[2] = 0.5                                     # a degenerate pose
    for kw in ({}, {"exp_weight": 2.0, "kp_subset": [0, 1, 2, 5, 8]}):
        np.testing.assert_array_equal(
            sampling.get_area_sampling_dist(kps, **kw),
            jsampling.get_area_sampling_dist(kps, **kw))
    p_ids = np.array([3, 3, 1, 7, 7, 7, 1])
    np.testing.assert_array_equal(sampling.get_pid_sampling_dist(p_ids),
                                  jsampling.get_pid_sampling_dist(p_ids))
    data = list(range(11))
    assert sampling.parallel_data_prefetch(lambda x: x * x, data, 3) == \
        jsampling.parallel_data_prefetch(lambda x: x * x, data, 3)


def test_the_native_library_builds_beside_the_kernels():
    if not native.decode_available():
        pytest.skip(f"the decode library does not build here: "
                    f"{native.build_error()}")
    path = native.library_path()
    assert path.exists() and "torch_kernels" in str(path)
    assert not str(path).startswith(os.path.dirname(native.SOURCE) + os.sep)
