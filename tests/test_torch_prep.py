"""The port's offline Human3.6M preparation against the JAX package.

The cases of JAX ``tests/test_prep_export.py`` (extrinsics and intrinsics
recovered, export then load, derived columns) run on the port's
``data/prep/process.py`` and its dataset; ``view_annotation_rows`` is held
column by column against JAX's on the same numpy inputs (equal: both are
the same float64 numpy).  The port writes ``annot_export.h5`` without
h5py (``data/h5lite.py:write_columns``): its file reads equal through
h5py, ``read_columns`` and JAX's ``Human36mDataset``, and JAX's
h5py-written file reads equal through the port's dataset with h5py hidden.
The metadata parser and the archive extraction agree with JAX's on small
synthetic inputs; the steps that need cdflib or ffmpeg raise naming them.
"""
import io
import os
import sys
import tarfile

import numpy as np
import pytest

import h5py

from behavior_driven_video_synthesis_tpu.data.human36m import (
    Human36mDataset as JHuman36mDataset)
from behavior_driven_video_synthesis_tpu.data.prep import extract as jextract
from behavior_driven_video_synthesis_tpu.data.prep import (
    metadata as jmetadata)
from behavior_driven_video_synthesis_tpu.data.prep import process as jprocess

from behavior_driven_video_synthesis_tpu_torch.data import h5lite
from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
    Human36mDataset)
from behavior_driven_video_synthesis_tpu_torch.data.prep import (
    H36MMetadata, extract, infer_camera_intrinsics, process)
from behavior_driven_video_synthesis_tpu_torch.data.prep.process import (
    fit_extrinsics, view_annotation_rows, write_annot_export)

from torch_port_threads import one_torch_thread  # noqa: F401

COLUMNS = ("frame_path", "pose_2d", "subject", "frame", "action",
           "subaction", "pose_normalized_2d", "camera", "image_size",
           "intrinsics_univ", "pose_3d", "pose_3d_world", "extrinsics_univ")


def _camera(theta=0.2):
    R = np.array([[np.cos(theta), 0, np.sin(theta)],
                  [0, 1, 0],
                  [-np.sin(theta), 0, np.cos(theta)]])
    t = np.array([120.0, -40.0, 300.0])
    return np.hstack([R, t[:, None]])


def _view(rng, n=40, extr=None):
    extr = _camera() if extr is None else extr
    world = rng.randn(n, 32, 3) * 250.0 + np.array([0, 0, 2500.0])
    cam = world @ extr[:, :3].T + extr[:, 3]
    intr = np.array([1145.0, 512.0, 1143.0, 515.0])
    p = cam / cam[..., 2:]
    px = np.stack([p[..., 0] * intr[0] + intr[1],
                   p[..., 1] * intr[2] + intr[3]], axis=-1)
    return world, cam, px, intr, extr


def _views(module, seed=2, n=30):
    """Three subjects x two actions of views through ``module``'s
    view_annotation_rows."""
    rng = np.random.RandomState(seed)
    rows = []
    for pid in (1, 5, 9):
        for act in (2, 4):
            world, cam, px, _, _ = _view(rng, n=n)
            paths = [f"S{pid}/a{act}/img_{i:06d}.jpg" for i in range(n)]
            rows.append(module.view_annotation_rows(
                subject_id=pid, action_id=act, subaction_id=1,
                camera_id=54138969, frame_paths=paths,
                poses_3d_univ=cam, poses_3d_world=world,
                pose_2d=px, image_size=(1000, 1000)))
    return rows


@pytest.fixture
def no_h5py(monkeypatch):
    """h5py hidden from imports, as on a machine without it."""
    monkeypatch.setitem(sys.modules, "h5py", None)


def _dataset(cls, root, mode="train"):
    return cls(None, ["keypoints", "sample_ids"], (0, 0), mode=mode,
               datapath=str(root), spatial_size=64,
               keypoint_type="keypoints_3d_world")


# -- JAX tests/test_prep_export.py's cases ----------------------------------

def test_fit_extrinsics_recovers_camera():
    rng = np.random.RandomState(0)
    world, cam, _, _, extr = _view(rng)
    est = fit_extrinsics(world, cam)
    np.testing.assert_allclose(est, extr, atol=1e-8)
    np.testing.assert_array_equal(est, jprocess.fit_extrinsics(world, cam))


def test_infer_intrinsics_recovers_camera():
    rng = np.random.RandomState(1)
    _, cam, px, intr, _ = _view(rng)
    est = infer_camera_intrinsics(px, cam)
    np.testing.assert_allclose(est, intr, rtol=1e-6)
    np.testing.assert_array_equal(
        est, jprocess.infer_camera_intrinsics(px, cam))


def test_export_then_load(tmp_path, no_h5py):
    """Rows from three subjects x two actions export, without h5py, to a
    file the port's Human36mDataset reads (splits, mm -> m,
    normalization)."""
    out = write_annot_export(str(tmp_path / "d" / "annot_export.h5"),
                             _views(process))
    assert os.path.exists(out)
    ds = _dataset(Human36mDataset, tmp_path / "d")
    assert len(ds) == 2 * 2 * 30          # subjects 1, 5 in train
    np.testing.assert_allclose(ds.datadict["intrinsics_univ"][0],
                               [1145.0, 512.0, 1143.0, 515.0], rtol=1e-6)
    assert np.abs(ds.datadict["extrinsics_univ"][:, :, -1]).max() < 10
    item = ds[0]
    assert np.isfinite(item["keypoints"]).all()


def test_export_derives_missing_columns():
    """pose_2d from the intrinsics, extrinsics fitted; and the intrinsics
    inferred from a given pose_2d."""
    rng = np.random.RandomState(3)
    world, cam, px, intr, extr = _view(rng, n=20)
    rows = [view_annotation_rows(
        subject_id=1, action_id=2, subaction_id=1, camera_id=1,
        frame_paths=[f"f{i}.jpg" for i in range(20)],
        poses_3d_univ=cam, poses_3d_world=world, intrinsics=intr)]
    np.testing.assert_allclose(rows[0]["pose_2d"], px, rtol=1e-6)
    np.testing.assert_allclose(rows[0]["extrinsics_univ"][0], extr,
                               atol=1e-7)
    rows2 = [view_annotation_rows(
        subject_id=1, action_id=2, subaction_id=1, camera_id=1,
        frame_paths=[f"f{i}.jpg" for i in range(20)],
        poses_3d_univ=cam, poses_3d_world=world, pose_2d=px)]
    np.testing.assert_allclose(rows2[0]["intrinsics_univ"][0], intr,
                               rtol=1e-6)


# -- the rows against JAX's ---------------------------------------------------

@pytest.fixture(scope="module")
def both_rows():
    rng = np.random.RandomState(4)
    world, cam, px, intr, _ = _view(rng, n=25)
    kw = dict(subject_id=5, action_id=3, subaction_id=2, camera_id=60457274,
              frame_paths=[f"S5/x/img_{i:06d}.jpg" for i in range(25)],
              poses_3d_univ=cam)
    cases = [dict(poses_3d_world=world, pose_2d=px),
             dict(poses_3d_world=world, intrinsics=intr),
             dict(pose_2d=px, image_size=(1002, 998))]
    return [(view_annotation_rows(**kw, **c),
             jprocess.view_annotation_rows(**kw, **c)) for c in cases]


@pytest.mark.parametrize("column", COLUMNS)
def test_view_rows_equal_jax_column(both_rows, column):
    for port, ref in both_rows:
        assert set(port) == set(ref) == set(COLUMNS)
        assert port[column].dtype == ref[column].dtype
        np.testing.assert_array_equal(port[column], ref[column])


def test_view_rows_refuse_misaligned_columns():
    rng = np.random.RandomState(5)
    world, cam, px, _, _ = _view(rng, n=10)
    with pytest.raises(ValueError, match="pose_2d has 9 frames"):
        view_annotation_rows(subject_id=1, action_id=2, subaction_id=1,
                             camera_id=1, frame_paths=["f"] * 10,
                             poses_3d_univ=cam, pose_2d=px[:9])
    with pytest.raises(ValueError, match="need pose_2d or intrinsics"):
        view_annotation_rows(subject_id=1, action_id=2, subaction_id=1,
                             camera_id=1, frame_paths=["f"] * 10,
                             poses_3d_univ=cam)


# -- the writer ---------------------------------------------------------------

def test_written_file_reads_equal_through_h5py_and_read_columns(tmp_path):
    rows = _views(process, seed=6, n=12)
    out = write_annot_export(str(tmp_path / "annot_export.h5"), rows)
    want = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    with h5py.File(out, "r") as f:
        via_h5py = {k: f[k][()] for k in f}
    via_lite = h5lite.read_columns(out)
    assert set(via_h5py) == set(via_lite) == set(want)
    for k, v in want.items():
        assert via_h5py[k].dtype == v.dtype, k
        np.testing.assert_array_equal(via_h5py[k], v)
        np.testing.assert_array_equal(via_lite[k], v)


def test_writer_takes_the_columns_one_at_a_time(tmp_path):
    """Each column is on disk before the next is asked for; dtypes of
    every kind the reader reads round-trip, big-endian ones as
    little-endian; 0-d arrays and other dtypes raise."""
    path = str(tmp_path / "cols.h5")
    seen = []
    cols = {"a_f32": np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3),
            "b_u8": np.arange(5, dtype=np.uint8),
            "c_be": np.arange(4, dtype=">i4"),
            "d_str": np.asarray([b"x", b"yz", b""]),
            **{f"e{i:02d}": np.full((i + 1,), i, np.int16)
               for i in range(20)}}

    def columns():
        for k, v in cols.items():
            if seen:
                assert os.path.getsize(path) >= 96 + sum(
                    cols[s].nbytes for s in seen)
            seen.append(k)
            yield k, v
    h5lite.write_columns(path, columns())
    with h5py.File(path, "r") as f:
        assert sorted(f) == sorted(cols)
        for k, v in cols.items():
            np.testing.assert_array_equal(f[k][()], v)
    back = h5lite.read_columns(path)
    for k, v in cols.items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError, match="0-d"):
        h5lite.write_columns(str(tmp_path / "x.h5"), [("s", np.float64(1))])
    with pytest.raises(ValueError, match="complex"):
        h5lite.write_columns(str(tmp_path / "y.h5"),
                             [("c", np.zeros(2, np.complex64))])


def test_port_file_loads_equal_through_both_datasets(tmp_path):
    """The port's h5py-free file through JAX's Human36mDataset (h5py) and
    the port's (h5lite) gives the same columns and items."""
    rows = _views(process)
    write_annot_export(str(tmp_path / "annot_export.h5"), rows)
    ref = _dataset(JHuman36mDataset, tmp_path)
    sys.modules["h5py"], saved = None, sys.modules["h5py"]
    try:
        port = _dataset(Human36mDataset, tmp_path)
    finally:
        sys.modules["h5py"] = saved
    assert len(port) == len(ref)
    for k in ("keypoints_3d_world", "intrinsics_univ", "extrinsics_univ",
              "p_ids", "f_ids", "action"):
        np.testing.assert_array_equal(port.datadict[k], ref.datadict[k])
    for i in (0, len(ref) - 1):
        np.testing.assert_array_equal(port[i]["keypoints"],
                                      ref[i]["keypoints"])


def test_jax_h5py_file_loads_equal_through_the_port_dataset(tmp_path,
                                                            monkeypatch):
    """JAX's export (written by h5py) read by the port's dataset without
    h5py equals JAX's dataset on it."""
    jprocess.write_annot_export(str(tmp_path / "annot_export.h5"),
                                _views(jprocess))
    ref = _dataset(JHuman36mDataset, tmp_path, mode="test")
    monkeypatch.setitem(sys.modules, "h5py", None)
    port = _dataset(Human36mDataset, tmp_path, mode="test")
    assert len(port) == len(ref) == 2 * 30
    np.testing.assert_array_equal(port.datadict["keypoints_3d_world"],
                                  ref.datadict["keypoints_3d_world"])
    np.testing.assert_array_equal(port[3]["keypoints"], ref[3]["keypoints"])


# -- metadata, archives and the gated tools -----------------------------------

METADATA_XML = """<?xml version="1.0"?>
<root>
<mapping>
<tr><td>a</td><td>b</td><td>S1</td><td>S5</td></tr>
<tr><td>1</td><td>1</td><td>_ALL 1</td><td>_ALL 5</td></tr>
<tr><td>2</td><td>1</td><td>Directions 1</td><td>Directions</td></tr>
<tr><td>2</td><td>2</td><td>Directions</td><td>Directions 2</td></tr>
<tr><td>3</td><td>1</td><td>Discussion 1</td><td>Discussion 2</td></tr>
</mapping>
<actionnames><n>_ALL</n><n>Directions</n><n>Discussion</n></actionnames>
<dbcameras><index2id><id>54138969</id><id>55011271</id></index2id>
</dbcameras>
</root>
"""


def test_metadata_parses_as_jax(tmp_path):
    path = tmp_path / "metadata.xml"
    path.write_text(METADATA_XML)
    port, ref = H36MMetadata(str(path)), jmetadata.H36MMetadata(str(path))
    for attr in ("subjects", "sequence_mappings", "action_names",
                 "camera_ids"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.subjects == ["S1", "S5"]
    assert port.get_base_filename("S5", "2", "2", "55011271") == \
        ref.get_base_filename("S5", "2", "2", "55011271") == \
        "Directions 2.55011271"


def _tgz(path, files):
    with tarfile.open(path, "w:gz") as tar:
        for name, data in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def _tree(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        for d in dirs:
            out[os.path.join(rel, d) + "/"] = None
        for name in files:
            with open(os.path.join(dirpath, name), "rb") as f:
                out[os.path.join(rel, name)] = f.read()
    return out


def test_extract_strips_the_common_prefix_as_jax(tmp_path):
    files = {"S1/MyPoses/D3/Walking.cdf": b"w", "S1/MyPoses/D3/Eating.cdf":
             b"e", "S1/MyPoses/D3/sub/Sitting 1.cdf": b"s"}
    _tgz(tmp_path / "a.tgz", files)
    extract.extract_tgz(str(tmp_path / "a.tgz"), str(tmp_path / "port"))
    jextract.extract_tgz(str(tmp_path / "a.tgz"), str(tmp_path / "jax"))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert (tmp_path / "port" / "Walking.cdf").read_bytes() == b"w"
    assert (tmp_path / "port" / "sub" / "Sitting 1.cdf").exists()
    # an existing destination is left as it is
    extract.extract_tgz(str(tmp_path / "a.tgz"), str(tmp_path / "port"))
    assert extract.SUBJECTS == jextract.SUBJECTS


def test_tools_that_are_missing_are_named(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cdflib", None)
    with pytest.raises(ImportError, match="cdflib"):
        process.read_cdf_poses(str(tmp_path / "x.cdf"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="ffmpeg"):
        process.extract_frames(str(tmp_path / "v.mp4"),
                               str(tmp_path / "frames"), np.arange(1, 3))
    assert process.INCLUDED_SUBJECTS == jprocess.INCLUDED_SUBJECTS
