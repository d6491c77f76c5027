"""``bdvs-generate-torch --from_dataset`` against the JAX package's
request path, on the CPU.

A tiny behavior run (``bdvs-train-torch``, ``configs/behavior_net.yaml``
with ``dim_hidden_b`` 16, 2 flows, B=2, ``seq_length`` [4, 5]) trains on a
Human3.6M tree written by ``tests/torch_port_image_data.py`` (subjects 1
and 9 x 2 actions x 12 frames of 48 px, S9 the test split).  Then:

  * ``--from_dataset`` behind a 32 px cvbae synthesis run serves, and the
    request it writes equals what the JAX CLI's calls
    (``build_sequence_data`` and ``get_synth_input``) give for the same
    items: ``source``, ``x_start``, the norm statistics, ``app_img`` and
    the cameras exactly;
  * for an in-plane (30-channel) synthesis run the appearance is the
    frame's part stack (``generate.synth_inputs``), within 1 uint8 level
    (2/255 in [-1, 1]) of JAX ``normalize_parts`` on the same index of the
    JAX dataset (``keypoint_type: keypoints_3d``, whose joint model has
    part homographies);
  * ``get_synth_input_all_cameras`` equals the JAX function on the tree;
  * an ``h36m_synthetic`` behavior config names frames that were never
    written: the port keeps the synthetic appearance and camera and prints
    the JAX CLI's fallback message, where the JAX calls fail (ROADMAP C15).
"""
import json
import os
import shutil

import numpy as np
import pytest
import yaml

from behavior_driven_video_synthesis_tpu.core import Config
from behavior_driven_video_synthesis_tpu.data.parts import (
    normalize_parts as jnormalize_parts)
from behavior_driven_video_synthesis_tpu.experiments.data_factory import (
    build_sequence_data as jbuild_sequence_data)
from behavior_driven_video_synthesis_tpu.experiments.visualize import (
    get_synth_input as jget_synth_input)

from behavior_driven_video_synthesis_tpu_torch import generate, main
from behavior_driven_video_synthesis_tpu_torch.core.config import (
    deep_merge, load_config)
from behavior_driven_video_synthesis_tpu_torch.models import convert
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.vunet import VUNet

import torch_port_image_data as image_data
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, B = 32, 2
PART_TOL = 2.0 / 255 + 1e-6          # one uint8 level in [-1, 1]


@pytest.fixture(scope="module")
def behavior_run(tmp_path_factory):
    """(behavior.npz path, the run's data config) of a tiny behavior run on
    a Human3.6M file tree."""
    base = tmp_path_factory.mktemp("from_dataset")
    cols = image_data.h36m_columns(subjects=(1, 9), actions=(2, 8),
                                   n_frames=12, image_hw=48)
    root = image_data.write_h36m_tree(str(base / "h36m"), cols,
                                      image_data.h36m_frames(cols))
    cfg = deep_merge(load_config(os.path.join(REPO, "configs",
                                              "behavior_net.yaml")), {
        "general": {"base_dir": str(base / "runs"), "project_name": "tiny"},
        "data": {"dataset": "human3.6m", "datapath": root,
                 "seq_length": [4, 5], "n_data_workers": 0},
        "architecture": {"dim_hidden_b": 16, "n_flows": 2},
        "training": {"batch_size": B, "n_epochs": 1}})
    path = base / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    main.main(["-c", str(path), "--device", "cpu"])
    npz = base / "runs" / "behavior_net" / "ckpt" / "tiny" / "behavior.npz"
    with open(npz.with_suffix(".json")) as f:
        assert json.load(f)["data"]["datapath"] == root
    return npz, cfg["data"]


def _synth_run(d):
    """A seeded 32 px cvbae synthesis run (3-channel appearance)."""
    os.makedirs(d, exist_ok=True)
    net = init_random_(VUNet(spatial_size=S, nf_start=4, nf_max=8),
                       np.random.RandomState(1))
    convert.save_flax_npz(os.path.join(d, "synth.npz"), {
        "vunet": convert.vunet_alter_to_flax(net.state_dict())})
    with open(os.path.join(d, "synth.json"), "w") as f:
        json.dump({"data": {"spatial_size": S},
                   "architecture": {"nf_start": 4, "nf_max": 8},
                   "general": {"experiment": "cvbae"}}, f)
    return os.path.join(d, "synth.npz")


def _serve(behavior_npz, synth_npz, out):
    man = generate.main([
        "--behavior_params", str(behavior_npz), "--synth_params", synth_npz,
        "--from_dataset", "--length", "3", "--batch", str(B),
        "--device", "cpu", "--out", str(out)])
    assert man["from_dataset"] and len(man["videos"]) == B
    with np.load(man["request"]) as data:
        return man, {k: data[k] for k in data.files}


def _jax_dataset(data_cfg):
    cfg = Config({"data": dict(data_cfg), "training": {"batch_size": B},
                  "general": {}})
    return jbuild_sequence_data(cfg, mode="test")


def test_request_equals_the_jax_calls(behavior_run, tmp_path, capsys):
    npz, data_cfg = behavior_run
    man, req = _serve(npz, _synth_run(str(tmp_path / "synth")),
                      tmp_path / "served")
    assert ("request built from the run's dataset: 2 sequences, real "
            "appearance/cameras") in capsys.readouterr().out
    _, meta = _jax_dataset(data_cfg)
    jds = meta["dataset"]
    kps = jds.datadict[jds.keypoint_key][req["sample_ids"]]
    assert kps.shape == (B, 5, 51)
    np.testing.assert_array_equal(req["source"], kps[:, :-1])
    np.testing.assert_array_equal(req["x_start"], kps[:, 0])
    stats = meta["norm_stats"]
    for k, ref in (("norm_mean", stats.mean), ("norm_std", stats.std),
                   ("dim_to_use", stats.dim_to_use)):
        np.testing.assert_array_equal(req[k], np.asarray(ref), err_msg=k)
    ref = [jget_synth_input(jds, i, S) for i in range(B)]
    for key, arrays in zip(("app_img", "extrinsics", "intrinsics",
                            "image_size"), zip(*ref)):
        np.testing.assert_array_equal(req[key], np.stack(arrays),
                                      err_msg=key)
    assert req["app_img"].shape == (B, S, S, 3)


def test_inplane_appearance_is_the_part_stack(behavior_run):
    """The in-plane branch on frames 0 and 1 of the Human3.6M tree read
    with ``keypoint_type: keypoints_3d``, whose joint model has part
    homographies: a behavior run reaches it in neither package (ROADMAP
    C11), so the branch is held here on the image dataset itself."""
    from behavior_driven_video_synthesis_tpu.data.human36m import (
        Human36mDataset as JaxHuman36m)
    from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
        Human36mDataset)

    _, data_cfg = behavior_run
    kw = dict(datapath=data_cfg["datapath"], keypoint_type="keypoints_3d",
              spatial_size=S, mode="test")
    ds = Human36mDataset(None, ["pose_img"], (0, 0), **kw)
    jds = JaxHuman36m(None, ["pose_img"], (0, 0), **kw)
    assert ds.joint_model.norm_T
    req = generate.synth_inputs(ds, B, S, True, 1)
    for i in range(B):
        ref = jnormalize_parts(jds._prep_image(i),
                               jds._get_kps_for_rendering(i), jds.joint_model,
                               S // 2).astype(np.float32) / 127.5 - 1.0
        assert req["app_img"][i].shape == ref.shape == (S // 2, S // 2, 30)
        np.testing.assert_allclose(req["app_img"][i], ref, rtol=0,
                                   atol=PART_TOL)
        for key, col in (("extrinsics", "extrinsics_univ"),
                         ("intrinsics", "intrinsics_univ"),
                         ("image_size", "image_size")):
            np.testing.assert_array_equal(
                req[key][i], np.asarray(jds.datadict[col][i], np.float32))


def test_synth_input_of_every_camera_equals_jax(behavior_run):
    from behavior_driven_video_synthesis_tpu.data.human36m import (
        Human36mDataset as JaxHuman36m)
    from behavior_driven_video_synthesis_tpu.experiments.visualize import (
        get_synth_input_all_cameras as jall)
    from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
        Human36mDataset)
    from behavior_driven_video_synthesis_tpu_torch.experiments.visualize \
        import get_synth_input_all_cameras

    _, data_cfg = behavior_run
    kw = dict(datapath=data_cfg["datapath"], spatial_size=S, mode="test",
              keypoint_type="keypoints_3d_world", train_synthesis=True)
    mine = get_synth_input_all_cameras(
        Human36mDataset(None, ["pose_img"], (0, 0), **kw),
        np.random.RandomState(3), S)
    ref = jall(JaxHuman36m(None, ["pose_img"], (0, 0), **kw),
               np.random.RandomState(3), S)
    assert mine[0].shape == (1, S, S, 3)          # the tree's one camera
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)


def test_synthetic_dataset_falls_back(behavior_run, tmp_path, capsys):
    npz, _ = behavior_run
    d = tmp_path / "synthetic_behavior"
    os.makedirs(d)
    shutil.copy(npz, d / "behavior.npz")
    with open(npz.with_suffix(".json")) as f:
        bcfg = json.load(f)
    bcfg["data"] = {"dataset": "h36m_synthetic", "seq_length": [4, 5],
                    "n_frames_per_video": 12, "n_data_workers": 0}
    with open(d / "behavior.json", "w") as f:
        json.dump(bcfg, f)
    man, req = _serve(d / "behavior.npz", _synth_run(str(tmp_path / "s")),
                      tmp_path / "served")
    assert ("request built from the run's dataset: 2 sequences, synthetic "
            "appearance/camera fallback") in capsys.readouterr().out
    assert "app_img" not in req and req["source"].shape == (B, 4, 51)
    # the JAX CLI reads the frames the dataset names and fails
    _, meta = _jax_dataset(bcfg["data"])
    with pytest.raises(FileNotFoundError):
        jget_synth_input(meta["dataset"], 0, S)
