"""The behavior experiment's data path, checkpoints and losses in the port,
against the JAX package where it has a counterpart, on the CPU.

The synthetic sequence data (``data/synthetic.py``,
``experiments/data_factory.py``) gives the JAX experiment's batches when
``iter()`` is called where the JAX experiment calls it; ``prefetch_iter``
keeps order and errors; ``CheckpointManager`` commits atomically and
keeps the newest 3; the sequence losses, ``gaussian_reference_nll`` and
the KS p-value equal the JAX functions.
"""
import os

import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu.core import Config
from behavior_driven_video_synthesis_tpu.experiments import (
    data_factory as jax_factory)
from behavior_driven_video_synthesis_tpu.train import losses as jax_losses

from behavior_driven_video_synthesis_tpu_torch.core.checkpoint import (
    CheckpointManager)
from behavior_driven_video_synthesis_tpu_torch.data.loader import (
    prefetch_iter)
from behavior_driven_video_synthesis_tpu_torch.experiments import (
    data_factory)
from behavior_driven_video_synthesis_tpu_torch.experiments.eval_protocol import (
    ks_test_flow_gaussianity)
from behavior_driven_video_synthesis_tpu_torch.models.flows import (
    gaussian_reference_nll)
from behavior_driven_video_synthesis_tpu_torch.train import losses


def _config(debug=False):
    return {"general": {"debug": debug},
            "data": {"dataset": "synthetic", "n_kps": 9, "n_actions": 3,
                     "seq_length": [8, 9], "n_samples": 40},
            "training": {"batch_size": 4}}


@pytest.mark.parametrize("mode,debug", [("train", False), ("test", False),
                                        ("train", True)])
def test_sequence_batches_are_the_jax_experiments(mode, debug):
    """A sample batch, then two epochs: every batch and the meta equal the
    JAX package's, epoch by epoch (each iter() is a new epoch)."""
    cfg = _config(debug)
    mine, meta = data_factory.build_sequence_data(cfg, mode)
    ref, ref_meta = jax_factory.build_sequence_data(Config(cfg), mode)
    assert len(mine) == len(ref) == (8 if debug else 10)
    assert {k: v for k, v in meta.items() if k != "dataset"} == {
        k: v for k, v in ref_meta.items() if k != "dataset"}
    for a, b in zip([next(iter(mine))], [next(iter(ref))]):
        assert a.keys() == b.keys()
        for k in b:
            assert np.array_equal(a[k], b[k]), k
    for _ in range(2):
        n = 0
        for a, b in zip(mine, ref):
            for k in b:
                assert np.array_equal(a[k], b[k]), k
            n += 1
        assert n == len(ref)
    assert mine._epoch == ref._epoch == 3
    first = next(iter(mine))
    assert first["keypoints"].shape == (4, 9, 9)


def test_other_datasets_name_the_roadmap_item():
    """A dataset name neither factory knows raises the JAX factory's
    ValueError (the Human3.6M names are ported: tests/
    test_torch_sequence_data.py)."""
    cfg = _config()
    cfg["data"]["dataset"] = "kinetics"
    for factory, c in ((data_factory, cfg), (jax_factory, Config(cfg))):
        with pytest.raises(ValueError,
                           match="unsupported sequence dataset: kinetics"):
            factory.build_sequence_data(c)


@pytest.mark.parametrize("action,offset", [
    (np.array([5, 3, 4, 3]), None), (np.array([[2, 2], [4, 4]]), 2),
    (np.array([[7, 1], [3, 0]]), None)])
def test_normalize_action_labels(action, offset):
    got = data_factory.normalize_action_labels(action, offset)
    want = jax_factory.normalize_action_labels(action, offset)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_prefetch_keeps_order_and_raises_the_producers_error():
    assert list(prefetch_iter(iter(range(7)), lambda x: x * 2)) == [
        2 * x for x in range(7)]

    def broken():
        yield 1
        raise RuntimeError("bad batch")
    out = []
    with pytest.raises(RuntimeError, match="bad batch"):
        for x in prefetch_iter(broken()):
            out.append(x)
    assert out == [1]
    # abandoned after one item: the producer stops on its flag
    it = prefetch_iter(iter(range(1000)), n=1)
    assert next(it) == 0
    it.close()


def test_checkpoints_commit_atomically_and_keep_the_newest_three(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "reg_ckpt"))
    assert mgr.restore_latest() is None
    for step in (4, 8, 12, 16):
        assert mgr.save(step, {"w": torch.full((2,), float(step)),
                               "step": step})
    assert not mgr.save(16, {"w": torch.zeros(2), "step": -1})
    assert mgr.all_steps() == [8, 12, 16]
    assert sorted(os.listdir(mgr.directory)) == [
        "step_12.pt", "step_16.pt", "step_8.pt"]      # no temporary left
    state, step = mgr.restore_latest()
    assert step == 16 and state["step"] == 16
    assert torch.equal(state["w"], torch.full((2,), 16.0))
    # a save cut before its commit leaves the previous one the newest
    with open(os.path.join(mgr.directory, "step_20.pt.tmp"), "wb") as f:
        f.write(b"partial")
    assert CheckpointManager(mgr.directory).restore_latest()[1] == 16


def test_sequence_losses_match_jax():
    rng = np.random.RandomState(0)
    pred, target = rng.randn(2, 4, 8, 9).astype(np.float32)
    logits = rng.randn(4, 3).astype(np.float32)
    labels = np.array([0, 2, 1, 2])
    z = rng.randn(6, 16).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (losses.mse_loss(t(pred), t(target)),
         jax_losses.mse_loss(pred, target)),
        (losses.recon_loss_per_seq(t(pred), t(target)),
         jax_losses.recon_loss_per_seq(pred, target)),
        (losses.cross_entropy(t(logits), t(labels)),
         jax_losses.cross_entropy(logits, labels)),
        (losses.accuracy(t(logits), t(labels)),
         jax_losses.accuracy(logits, labels))]
    from behavior_driven_video_synthesis_tpu.models.flows.transformer import (
        gaussian_reference_nll as jax_nll)
    pairs.append((gaussian_reference_nll(t(z)), jax_nll(z)))
    for mine, ref in pairs:
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


def test_ks_p_value_matches_jax():
    from behavior_driven_video_synthesis_tpu.experiments.eval_protocol import (
        ks_test_flow_gaussianity as jax_ks)
    z = np.random.RandomState(1).randn(64, 12) * 1.3
    assert ks_test_flow_gaussianity(z) == jax_ks(z)
