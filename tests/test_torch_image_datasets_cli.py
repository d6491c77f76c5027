"""The VUNet experiments on image files through the port's training entry
point (``bdvs-train-torch``), on the CPU.

The counterpart of JAX ``tests/test_h36m_files.py:
test_cvbae_cli_on_h36m_files`` with evaluation: at small width (32 px, nf
4->8) each run trains 3 steps, resumes with ``-r`` to step 5 and is
evaluated with ``-m infer`` and ``metrics.compute_is`` /
``compute_fid``, on trees the JAX tests' fixtures write:

  * cvbae on a Human3.6M tree as ``configs/shape_and_pose_net.yaml``
    publishes it (``keypoints_3d_world``, stickmen from 3D, the regressor
    on its probe images; here with the person split, which the fixture's
    two actions need), the regressor sized by the 17 keypoints (ROADMAP
    C8); a second ``-m infer`` reads the FID cache instead of recomputing
    the targets' features;
  * org-VUNet on a DeepFashion and on a Market tree with in-plane part
    stacks, as ``configs/vunet.yaml`` publishes it (the post-hoc
    regressor off, ROADMAP C6), with IS; on DeepFashion also with FID,
    evaluated twice: the second ``-m infer`` reads the targets' features
    from the cache the first wrote.

The trained runs are shared through module-scoped fixtures.  The FID
runs a 2048-wide ``sqrtm`` on the host (~15 s here, twice that when the
tier-1 run's workers share the machine), so only the cvbae run computes
it; the org run records the features the FID is given instead
(``fid_from_features`` itself is held against the JAX package's in
``test_torch_inception_metrics.py``), and ``chip_smoke.py`` phase [18]
computes it for both experiments.
"""
import os

import numpy as np
import pytest
import torch
import yaml

cv2 = pytest.importorskip("cv2")
pytest.importorskip("h5py")

from behavior_driven_video_synthesis_tpu_torch import main
from behavior_driven_video_synthesis_tpu_torch.core.config import (
    deep_merge, load_config)
from behavior_driven_video_synthesis_tpu_torch.data import base
from behavior_driven_video_synthesis_tpu_torch.experiments import (
    shape_and_pose_net as sp)

from test_file_datasets import make_index_fixture
from test_h36m_files import make_h36m_fixture
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"data": {"spatial_size": 32, "box_factor": 1, "n_data_workers": 2},
         "architecture": {"nf_start": 4, "nf_max": 8},
         "training": {"batch_size": 4, "end_iteration": 3, "bf16": False,
                      "n_init_batches": 1, "reg_steps": 2},
         "metrics": {"n_it_metrics": 1000, "max_n_samples": 8},
         "logging": {"ckpt_steps": 3, "log_steps": 1000}}


def _write(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _run(root, config, data, metrics, experiment):
    """Train 3 steps, resume to 5 and evaluate; returns (train output,
    resume output, -m infer summaries, the run's directories)."""
    cfg = deep_merge(load_config(os.path.join(REPO, "configs", config)),
                     SMALL)
    cfg = deep_merge(cfg, {
        "general": {"base_dir": str(root / "runs"), "project_name": "tiny",
                    "debug": True},
        "data": data, "metrics": metrics})
    path = _write(root / "cfg.yaml", cfg)
    trained = main.main(["-c", path, "--device", "cpu"])
    run = root / "runs" / experiment
    dumped = run / "config" / "tiny" / "config.yaml"
    cfg = load_config(str(dumped))
    cfg["training"]["end_iteration"] = 5
    _write(dumped, cfg)
    resumed = main.main(["-c", path, "--device", "cpu", "-r"])
    return trained, resumed, path, run


def _counted_inception():
    calls = []
    forward = sp.inception_features

    def counted(model, img):
        calls.append(len(img))
        return forward(model, img)
    return calls, counted


@pytest.fixture(scope="module")
def cvbae_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cvbae")
    h36m = make_h36m_fixture(str(root / "h36m"))
    trained, resumed, path, run = _run(
        root, "shape_and_pose_net.yaml",
        {"dataset": "human3.6m", "datapath": h36m, "use_person_split": True,
         # 32 px // 50 would draw lines 0 px thick
         "stickman_scale": 16},
        {"compute_is": True, "compute_fid": True}, "cvbae")
    calls, counted = _counted_inception()
    summaries = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sp, "inception_features", counted)
        for _ in range(2):
            summaries.append(main.main(["-c", path, "--device", "cpu", "-m",
                                        "infer"]))
            calls.append("end")
    return trained, resumed, summaries, run, calls


def _recorded_fid(given):
    def fid_from_features(recon, gt):
        given.append((recon.numpy().copy(), gt.numpy().copy()))
        return 0.0
    return fid_from_features


@pytest.fixture(scope="module")
def org_runs(tmp_path_factory):
    out = {}
    for name, size, fid in (("deepfashion", 256, True),
                            ("market", 128, False)):
        root = tmp_path_factory.mktemp(name)
        tree = make_index_fixture(str(root / name), n=20, size=size)
        trained, resumed, path, run = _run(
            root, "vunet.yaml", {"dataset": name, "datapath": tree},
            {"posthoc_regressor": False, "compute_is": True,
             "compute_fid": fid}, "vunet")
        base.DECODES.clear()
        calls, counted = _counted_inception()
        given = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sp, "inception_features", counted)
            mp.setattr(sp, "fid_from_features", _recorded_fid(given))
            summaries = []
            for _ in range(2 if fid else 1):
                summaries.append(main.main(["-c", path, "--device", "cpu",
                                            "-m", "infer"]))
                calls.append("end")
        out[name] = (trained, resumed, summaries[0], run, dict(base.DECODES),
                     calls, given)
    return out


def test_cvbae_trains_and_resumes_on_human36m_files(cvbae_run):
    trained, resumed, _, run, _ = cvbae_run
    assert trained["state"].step == 3 and resumed["state"].step == 5
    saves = sorted(os.listdir(run / "ckpt" / "tiny" / "reg_ckpt"))
    assert saves == ["step_3.pt", "step_5.pt"]
    # the regressor predicts the 17 keypoints of the probe images
    assert resumed["regressor"].linears[-1].out_features == 34
    assert all(torch.isfinite(p).all() for p in resumed["vunet"].parameters())


def test_cvbae_infer_reports_is_and_fid_and_reads_the_fid_cache(cvbae_run):
    _, _, summaries, run, calls = cvbae_run
    for summary in summaries:
        assert set(summary) == {"ssim", "is_recon", "is_transfer", "fid",
                                "loss_regressor_posthoc"}
        assert all(np.isfinite(v) for v in summary.values())
        assert summary["is_recon"] >= 1 and summary["fid"] >= 0
    cache = run / "ckpt" / "tiny" / "human3.6m-fid-features.npy"
    assert np.load(cache).shape == (8, 2048)
    first, second = (calls[:calls.index("end")],
                     calls[calls.index("end") + 1:-1])
    # transfers, targets and prior samples of 2 batches of 4; then the
    # targets' features come from the cache
    assert first == [4] * 6 and second == [4] * 4


@pytest.mark.parametrize("dataset", ["deepfashion", "market"])
def test_org_vunet_on_index_files(org_runs, dataset):
    trained, resumed, summary, run, decodes, _, _ = org_runs[dataset]
    assert trained["state"].step == 3 and resumed["state"].step == 5
    # the appearance encoder takes the 30-channel part stacks
    assert resumed["vunet"].eu.nin.conv.weight_v.shape[1] == 30
    assert set(summary) == {"ssim", "is_recon", "is_transfer"} | (
        {"fid"} if dataset == "deepfashion" else set())
    assert all(np.isfinite(v) for v in summary.values())
    assert sum(decodes.values()) > 0


def test_org_infer_writes_then_reads_the_fid_cache(org_runs):
    _, _, _, run, _, calls, given = org_runs["deepfashion"]
    cache = run / "ckpt" / "tiny" / "deepfashion-fid-features.npy"
    assert np.load(cache).shape == (4, 2048)
    first, second = (calls[:calls.index("end")],
                     calls[calls.index("end") + 1:-1])
    # transfers, targets and prior samples of the test split's one batch
    # of 4; then the targets' features come from the cache
    assert first == [4] * 3 and second == [4] * 2
    assert len(given) == 2
    np.testing.assert_array_equal(given[1][1], np.load(cache))
    np.testing.assert_array_equal(given[0][1], given[1][1])
    assert given[0][0].shape == given[1][0].shape == (4, 2048)


def test_an_empty_datapath_is_refused(tmp_path):
    cfg = deep_merge(load_config(os.path.join(REPO, "configs", "vunet.yaml")),
                     SMALL)
    cfg = deep_merge(cfg, {"general": {"base_dir": str(tmp_path / "runs")},
                           "data": {"dataset": "deepfashion",
                                    "datapath": str(tmp_path)}})
    with pytest.raises(ValueError, match="holds no train images"):
        main.main(["-c", _write(tmp_path / "c.yaml", cfg), "--device",
                   "cpu"])
