"""The Human3.6M sequence path of the port against the JAX package, on the
CPU.

``geometry/normalization.py``, the six samplers of ``data/samplers.py``,
``Human36mDataset`` (filled from ``synthetic_h36m_columns`` and from a tiny
``annot_export.h5``), ``data/loader.py``'s ``Loader`` and the
``h36m_synthetic`` branch of ``build_sequence_data``: the same inputs and
seeds give equal stats, ids, items and batches (exact equality: all of it
is numpy on both sides).
"""
import functools

import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu.core import Config
from behavior_driven_video_synthesis_tpu.data import human36m as jax_h36m
from behavior_driven_video_synthesis_tpu.data import samplers as jax_samplers
from behavior_driven_video_synthesis_tpu.data.loader import (
    Loader as JaxLoader)
from behavior_driven_video_synthesis_tpu.data.synthetic import (
    synthetic_h36m_columns as jax_columns)
from behavior_driven_video_synthesis_tpu.experiments import (
    data_factory as jax_factory)
from behavior_driven_video_synthesis_tpu.geometry import (
    normalization as jax_norm)

from behavior_driven_video_synthesis_tpu_torch.data import human36m
from behavior_driven_video_synthesis_tpu_torch.data import samplers
from behavior_driven_video_synthesis_tpu_torch.data.loader import Loader
from behavior_driven_video_synthesis_tpu_torch.data.synthetic import (
    synthetic_h36m_columns)
from behavior_driven_video_synthesis_tpu_torch.experiments import (
    data_factory)
from behavior_driven_video_synthesis_tpu_torch.geometry import normalization

from torch_port_h36m import write_annot_export

KEYS = ["keypoints", "paired_keypoints", "action", "sample_ids",
        "paired_sample_ids"]
# (synthetic_h36m_columns' keywords, the dataset's)
OPTIONS = {
    "person_split": ({}, {}),
    "overall_split": ({}, {"overall_split": True}),
    "action_split": ({"actions": (2, 8, 14, 15)},
                     {"use_person_split": False,
                      "action_split_type": "generalize_walking"}),
    "discard": ({}, {"actions_to_discard": ["Eating"]}),
    "lag_too_long": ({}, {"sequential_frame_lag": 5}),
}


def _equal(a, b, what=""):
    assert a.keys() == b.keys(), what
    for k in b:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f"{what} {k}")


def test_normalization_stats_round_trip_and_the_torch_path():
    rng = np.random.RandomState(0)
    data = rng.randn(40, 12) * 3.0 + 1.0
    data[:, [2, 7]] = 0.5                       # two degenerate dims
    mine = normalization.normalization_stats(data)
    ref = jax_norm.normalization_stats(data)
    for f in ("mean", "std", "dim_to_use", "dim_to_ignore"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f), f)
    assert mine.full_dim == 12 and list(mine.dim_to_ignore) == [2, 7]
    z = normalization.normalize(data, mine)
    np.testing.assert_array_equal(z, np.asarray(jax_norm.normalize(data,
                                                                   ref)))
    assert z.shape == (40, 10) and z.dtype == np.float32
    back = normalization.unnormalize(z, mine)
    np.testing.assert_array_equal(back, np.asarray(jax_norm.unnormalize(z,
                                                                        ref)))
    np.testing.assert_allclose(back, data, rtol=1e-5, atol=1e-5)
    t = normalization.revert_output_format(torch.from_numpy(z[:5]), mine)
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), back[:5])


def _datasets(mode="train", keys=KEYS, seq_length=(8, 9), columns=None,
              **kw):
    """(port dataset, JAX dataset) from the same synthetic columns."""
    kw = {"keypoint_type": "keypoints_3d_world", "label_transfer": True,
          "data_seed": 3, "sequential_frame_lag": 2, **kw}
    cols = synthetic_h36m_columns(n_frames_per_video=40, seed=0,
                                  **(columns or {}))
    # 2D keypoints too, which the motion-weighted sampler reads
    cols["keypoints"] = cols["keypoints_3d_world"][..., :2].reshape(
        len(cols["p_ids"]), -1)
    mine = human36m.Human36mDataset(None, keys, seq_length, mode=mode, **kw)
    ref = jax_h36m.Human36mDataset(None, keys, seq_length, mode=mode, **kw)
    mine.populate_from_arrays({k: v.copy() for k, v in cols.items()})
    ref.populate_from_arrays({k: v.copy() for k, v in cols.items()})
    return mine, ref


def _same_dataset(mine, ref):
    assert len(mine) == len(ref) > 0
    _equal(mine.datadict, ref.datadict, "datadict")
    for f in ("mean", "std", "dim_to_use", "dim_to_ignore"):
        np.testing.assert_array_equal(getattr(mine.norm_stats, f),
                                      getattr(ref.norm_stats, f), f)
    assert mine.seq_length == ref.seq_length
    assert mine.sequential_frame_lag == ref.sequential_frame_lag
    assert mine.sequence_start_ids == ref.sequence_start_ids
    assert mine.sequence_end_ids == ref.sequence_end_ids
    np.testing.assert_array_equal(mine.matched_map_ids, ref.matched_map_ids)
    assert mine.action_id_to_action == ref.action_id_to_action


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_human36m_from_synthetic_columns(mode, option):
    """norm_stats, the split and the column store are the JAX dataset's,
    and every item (its windows, pairs and draws) is too."""
    columns, kw = OPTIONS[option]
    mine, ref = _datasets(mode, columns=columns, **kw)
    _same_dataset(mine, ref)
    for idx in [0, 5, len(ref) - 1, [3, 6], [len(ref) - 2, 8]]:
        _equal(mine[idx], ref[idx], f"item {idx}")


def test_human36m_matched_keypoints_under_pose_encodings():
    keys = ["keypoints", "matched_keypoints", "intrinsics",
            "extrinsics_paired"]
    mine, ref = _datasets("train", keys=keys)
    enc = np.random.RandomState(1).randn(len(ref), 4)
    mine.set_pose_encodings(enc)
    ref.set_pose_encodings(enc)
    for idx in ([0, 8], [17, 8], 30):
        _equal(mine[idx], ref[idx], f"item {idx}")


def test_human36m_from_a_tiny_annot_export_h5(tmp_path):
    """Two cameras (world keypoints keep one), poses in mm (turned to m),
    1-based frames, byte-string paths and the debug subset."""
    pytest.importorskip("h5py")
    write_annot_export(str(tmp_path))
    kw = {"keypoint_type": "keypoints_3d_world", "label_transfer": True,
          "data_seed": 5, "datapath": str(tmp_path)}
    for mode, debug in (("train", False), ("test", False), ("train", True)):
        mine = human36m.Human36mDataset(None, KEYS, (8, 9), mode=mode,
                                        debug=debug, **kw)
        ref = jax_h36m.Human36mDataset(None, KEYS, (8, 9), mode=mode,
                                       debug=debug, **kw)
        _same_dataset(mine, ref)
        assert len(mine) == 60           # one subject, 2 actions, 30 frames
        assert mine.datadict["keypoints_3d_world"].shape[1] == 51
        for idx in (0, [11, 8], len(ref) - 1):
            _equal(mine[idx], ref[idx], f"{mode} item {idx}")


def test_human36m_without_h5py_raises(tmp_path, monkeypatch):
    (tmp_path / "annot_export.h5").write_bytes(b"")
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        human36m.Human36mDataset(None, KEYS, (8, 9), datapath=str(tmp_path),
                                 keypoint_type="keypoints_3d_world")


def test_image_fetchers_name_their_roadmap_items():
    mine, _ = _datasets("train", keys=["keypoints", "stickman"])
    with pytest.raises(NotImplementedError, match="A12"):
        mine[0]
    mine, _ = _datasets("train", keys=["app_img"])
    with pytest.raises(NotImplementedError, match="A10c"):
        mine[0]


SAMPLERS = {
    "random": lambda m, ds: m.RandomSampler(ds, seed=4),
    "reconstruction": lambda m, ds: m.ReconstructionSampler(ds, seed=4),
    "per_person": lambda m, ds: m.PerPersonSampler(ds, seed=4),
    "per_person_dist": lambda m, ds: m.PerPersonSampler(
        ds, sampling_dist=np.linspace(1.0, 2.0, len(ds)), seed=4),
    "weighted": lambda m, ds: m.WeightedDataSampler(ds, seed=4),
    "weighted_motion": lambda m, ds: m.WeightedDataSampler(
        ds, motion_sampling=True, alpha_data=0.5, seed=4),
    "entire_sequence": lambda m, ds: m.EntireSequenceSampler(ds, 5),
    "sequence": lambda m, ds: m.SequenceSampler(
        ds, m.RandomSampler(ds, seed=4), 6, drop_last=False, seed=7),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_ids_for_a_fixed_seed(name):
    """Two epochs of ids (and the map_ids the sampler rewrites) equal the
    JAX sampler's."""
    mine_ds, ref_ds = _datasets("train")
    mine = SAMPLERS[name](samplers, mine_ds)
    ref = SAMPLERS[name](jax_samplers, ref_ds)
    assert len(mine) == len(ref)
    for _ in range(2):
        a, b = list(mine), list(ref)
        assert a == b and len(a) > 0
        np.testing.assert_array_equal(mine_ds.datadict["map_ids"],
                                      ref_ds.datadict["map_ids"])


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_batches(workers):
    mine_ds, ref_ds = _datasets("test")
    mine = Loader(mine_ds, samplers.SequenceSampler(
        mine_ds, samplers.RandomSampler(mine_ds, seed=1), 4, seed=2),
        num_workers=workers)
    ref = JaxLoader(ref_ds, jax_samplers.SequenceSampler(
        ref_ds, jax_samplers.RandomSampler(ref_ds, seed=1), 4, seed=2),
        num_workers=1)
    assert len(mine) == len(ref)
    n = 0
    for a, b in zip(mine, ref):
        _equal(a, b, "batch")
        assert a["keypoints"].shape[0] == 4
        n += 1
    assert n == len(ref)


def _seeded_samplers(monkeypatch, module, sampler_module, seed):
    monkeypatch.setattr(module, "RandomSampler", functools.partial(
        sampler_module.RandomSampler, seed=seed))
    monkeypatch.setattr(module, "SequenceSampler", functools.partial(
        sampler_module.SequenceSampler, seed=seed + 1))


@pytest.mark.parametrize("mode", ["train", "test"])
def test_h36m_synthetic_batches_for_the_same_sampler_seed(monkeypatch, mode):
    """The JAX factory seeds nothing (RandomSampler(ds)): both factories'
    samplers are seeded here, and the dataset's draws through
    ``data_seed``."""
    _seeded_samplers(monkeypatch, data_factory, samplers, 11)
    _seeded_samplers(monkeypatch, jax_factory, jax_samplers, 11)
    cfg = {"general": {"debug": False},
           "data": {"dataset": "h36m_synthetic", "seq_length": [8, 9],
                    "sequential_frame_lag": 2, "n_frames_per_video": 30,
                    "keypoint_type": "keypoints_3d_world", "data_seed": 6,
                    "n_data_workers": 2},
           "training": {"batch_size": 4}}
    mine, meta = data_factory.build_sequence_data(cfg, mode)
    ref, ref_meta = jax_factory.build_sequence_data(Config(cfg), mode)
    assert {k: meta[k] for k in ("n_kps", "seq_len", "action_offset")} == {
        k: ref_meta[k] for k in ("n_kps", "seq_len", "action_offset")} == {
        "n_kps": 51, "seq_len": 8, "action_offset": 2}
    # actions 2, 4 and 5: the labels reach 3, which the JAX factory's count
    # of distinct actions leaves out of its heads (ROADMAP C5)
    assert (meta["n_actions"], ref_meta["n_actions"]) == (4, 3)
    np.testing.assert_array_equal(meta["norm_stats"].mean,
                                  ref_meta["norm_stats"].mean)
    assert len(mine) == len(ref) == (45 if mode == "train" else 22)
    for _ in range(2):
        n = 0
        for a, b in zip(mine, ref):
            _equal(a, b, "batch")
            n += 1
        assert n == len(ref)


def test_synthetic_h36m_columns_are_the_jax_packages():
    _equal(synthetic_h36m_columns(n_frames_per_video=12, seed=3),
           jax_columns(n_frames_per_video=12, seed=3), "columns")


def test_missing_human36m_raises_file_not_found():
    cfg = {"data": {"dataset": "human3.6m", "datapath": "no/such/dir",
                    "seq_length": [8, 9]},
           "training": {"batch_size": 4}}
    with pytest.raises(FileNotFoundError, match="annot_export.h5"):
        data_factory.build_sequence_data(cfg, "train")
