"""The port's dataset smoke tool (``bdvs-data-smoke-torch``) against the
JAX package's (``bdvs-data-smoke``), on the CPU.

On the same trees (the JAX tests' Human3.6M files with two cameras, a
DeepFashion ``index.p`` tree, and the synthetic Human3.6M columns) each
mode writes the JAX tool's list of files, and every file decodes; the
projection's pixel coordinates (recorded where both tools draw them) agree
to atol 1e-3.  Without ``--device cpu`` the tool needs a card.
"""
import os
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

cv2 = pytest.importorskip("cv2")
pytest.importorskip("h5py")

import behavior_driven_video_synthesis_tpu.viz as jax_viz  # noqa: E402
from behavior_driven_video_synthesis_tpu.data import (  # noqa: E402
    smoke as jax_smoke)

from behavior_driven_video_synthesis_tpu_torch.data import smoke  # noqa: E402
from behavior_driven_video_synthesis_tpu_torch.viz import videos  # noqa: E402
from test_file_datasets import make_index_fixture  # noqa: E402
from test_h36m_files import make_h36m_fixture  # noqa: E402
from torch_port_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke_trees")
    return {"h36m": make_h36m_fixture(str(root / "h36m")),
            "deepfashion": make_index_fixture(str(root / "df"), n=10,
                                              size=64)}


CASES = {
    "projection_synthetic": ({"dataset": "h36m_synthetic",
                              "n_frames_per_video": 60},
                             "visualize_projection"),
    "projection_files": ({"dataset": "human3.6m", "datapath": "h36m"},
                         "visualize_projection"),
    "test_synth_synthetic": ({"dataset": "h36m_synthetic",
                              "n_frames_per_video": 40, "spatial_size": 64},
                             "test_synth"),
    "test_synth_files": ({"dataset": "human3.6m", "datapath": "h36m",
                          "spatial_size": 64}, "test_synth"),
    "test_synth_deepfashion": ({"dataset": "deepfashion",
                                "datapath": "deepfashion",
                                "spatial_size": 32}, "test_synth"),
    "default_synthetic": ({"dataset": "h36m_synthetic",
                           "n_frames_per_video": 40, "spatial_size": 64},
                          None),
    "default_files": ({"dataset": "human3.6m", "datapath": "h36m",
                       "spatial_size": 64}, None),
}


def _recording(module, name, into):
    fn = getattr(module, name)

    def draw(img, kps, *a, **kw):
        into.append(np.array(kps, np.float64))
        return fn(img, kps, *a, **kw)
    return mock.patch.object(module, name, draw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_smoke_modes_match_jax(trees, tmp_path, case):
    data, mode = CASES[case]
    if "datapath" in data:
        data = {**data, "datapath": trees[data["datapath"]]}
    cfg = str(tmp_path / "cfg.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"general": {"mode": "default"}, "data": data}, f)
    argv = ["--config", cfg, "--n_videos", "2"] + (
        ["--mode", mode] if mode else [])
    px_ref, px = [], []
    with _recording(jax_viz, "add_joints_to_img", px_ref):
        ref = jax_smoke.main(argv + ["--out", str(tmp_path / "jax")])
    with _recording(videos, "add_joints_to_img", px):
        mine = smoke.main(argv + ["--out", str(tmp_path / "port"),
                                  "--device", "cpu"])
    assert ([os.path.relpath(p, tmp_path / "port") for p in mine]
            == [os.path.relpath(p, tmp_path / "jax") for p in ref])
    assert len(px) == len(px_ref) == (100 if mode == "visualize_projection"
                                      else 0)
    for a, b in zip(px, px_ref):
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
    for p in mine:
        if p.endswith(".png"):
            assert cv2.imread(p) is not None, p
        else:
            cap = cv2.VideoCapture(p)
            assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 50, p
            cap.release()


def test_smoke_tool_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        smoke.main(["--out", str(tmp_path)])
