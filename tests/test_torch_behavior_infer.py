"""The port's behavior_net inference and bf16 training step against the JAX
package's, on the CPU.

``run_inference`` (``-m infer``) at small width (``tests/
torch_port_infer.py``: 9 keypoints, ``dim_hidden_b`` 16, T=8, B=4, S=3
samples, 3 flows) on the same flax trees and the JAX run's draws: the
summary has the JAX run's keys and every value within the tolerance of
``torch_port_infer.summary_tolerance``.  The bf16 cVAE step
(``training.bf16``) against the JAX package's bf16 step on the same
weights, batch and draws (``tests/torch_port_behavior.py``).
"""
import numpy as np
import pytest
import torch

import torch_port_behavior as TB
import torch_port_infer as TI


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Thousands of small ops: one intra-op thread keeps them from
    contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_inference(tmp_path_factory, one_thread):
    trees = TI.make_trees(0)
    summary, recorded, key = TI.jax_run_inference(
        trees, str(tmp_path_factory.mktemp("jax_infer")))
    return trees, summary, recorded, key


def test_run_inference_summary_matches_jax(jax_inference, tmp_path):
    trees, ref, recorded, key = jax_inference
    assert {k: len(v) for k, v in recorded.items()} == {
        "eval_eps": 2, "prior_z": 2, "flow_z": 2, "cross_eps": 2,
        "prior_b": 2, "flow_codes": 2}
    posthoc = TI.jax_posthoc_draws(key, (TI.MAX_CACHE, TI.T, TI.K))
    draws = TI.recorded_draws(recorded, posthoc)
    mine = TI.port_run_inference(trees, str(tmp_path), draws)
    assert all(not q for q in draws.queues.values())   # every draw used
    assert len(ref) == 53
    TI.check_summary(mine, ref)
    with open(tmp_path / "behavior_net" / "log" / "infer" /
              "metrics.jsonl") as f:
        line = __import__("json").loads(f.readlines()[-1])
    assert line["step"] == 0
    assert {k[len("infer/"):] for k in line
            if k not in ("step", "time")} == set(ref)


_F32_CONFIG = TB.config


def _bf16_config():
    cfg = _F32_CONFIG()
    cfg["training"]["bf16"] = True
    return cfg


def test_bf16_cvae_step_matches_jax_bf16_step(monkeypatch):
    """Two bf16 steps (products in bf16, float32 parameters and Adam
    states).  Tolerances: the losses and metrics rtol 5e-2 (atol 5e-2 for
    the loss and the accuracies, a sum of bf16 rounding over the
    products; the port reduces its losses in float32 where the JAX step
    reduces the KL and the cross-entropies in bf16).  The updates (after
    minus before) leaf by leaf: ||d_port - d_jax|| <= 0.5 ||d_jax|| on
    every leaf, and <= 0.2 of the norm over all leaves together.  Adam's
    first steps are close to lr * sign(grad), so a gradient near zero
    whose bf16 rounding flips its sign moves its element by 2 lr: the
    JAX bf16 update itself differs from the JAX f32 update by up to 0.30
    of its norm on a leaf (SequenceDiscMichael's convolutions).  An update
    left out gives 1.0 on every leaf, a reversed one 2.0."""
    import jax.numpy as jnp

    from behavior_driven_video_synthesis_tpu.models import (
        ClassifierAction, ClassifierActionBeta, RegressorFly,
        ResidualBehaviorNet)
    from behavior_driven_video_synthesis_tpu.models.discriminators import (
        SequenceDiscMichael)
    from behavior_driven_video_synthesis_tpu_torch.models import probes
    from behavior_driven_video_synthesis_tpu_torch.models import behavior
    from behavior_driven_video_synthesis_tpu_torch.models import (
        discriminators)

    bf = jnp.bfloat16

    def jax_setup():
        from behavior_driven_video_synthesis_tpu.core import Config
        return Config(_bf16_config()), {
            "net": ResidualBehaviorNet(n_kps=TB.K, dim_hidden_b=TB.H,
                                       dtype=bf),
            "regressor": RegressorFly(n_out=TB.K, seq_length=TB.T, dtype=bf),
            "cls_action": ClassifierAction(n_classes=TB.N_ACTIONS,
                                           dim=TB.CLS_DIM, dtype=bf),
            "cls_action2": SequenceDiscMichael(layers=(2, 1, 1, 1),
                                               out_dim=TB.N_ACTIONS,
                                               dtype=bf),
            "cls_beta": ClassifierActionBeta(n_classes=TB.N_ACTIONS,
                                             dtype=bf)}

    def port_modules():
        d = torch.bfloat16
        return {
            "net": behavior.ResidualBehaviorNet(TB.K, TB.H, dtype=d),
            "regressor": probes.RegressorFly(TB.H, TB.K, TB.T, dtype=d),
            "cls_action": probes.ClassifierAction(TB.K, TB.N_ACTIONS,
                                                  dim=TB.CLS_DIM, dtype=d),
            "cls_action2": discriminators.SequenceDiscMichael(
                TB.K, TB.T - 1, out_dim=TB.N_ACTIONS, dtype=d),
            "cls_beta": probes.ClassifierActionBeta(TB.H, TB.N_ACTIONS,
                                                    dtype=d)}

    trees, batch, draws = TB.make_inputs(0)
    monkeypatch.setattr(TB, "_jax_setup", jax_setup)
    ref, ref_after = TB.jax_cvae_steps(trees, batch, draws)
    monkeypatch.setattr(TB, "port_modules", port_modules)
    monkeypatch.setattr(TB, "config", _bf16_config)
    mine, after = TB.port_steps(trees, batch, draws, stages=("cvae",))
    assert len(mine["cvae"]) == len(ref) == TB.N_STEPS
    for m, r in zip(mine["cvae"], ref):
        assert m.keys() == r.keys()
        for k in r:
            atol = 5e-2 if k == "loss" or k.startswith("acc") else 0.0
            np.testing.assert_allclose(m[k], np.asarray(r[k], np.float32),
                                       rtol=5e-2, atol=atol, err_msg=k)
    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree)
    f0 = flatten_tree({n: trees[n] for n in TB.MODULES})
    fm = flatten_tree({n: after[n] for n in TB.MODULES})
    fr = flatten_tree(ref_after)
    assert fm.keys() == fr.keys() == f0.keys()
    off = total = 0.0
    for k in fr:
        assert fm[k].dtype == np.float32, k
        d_jax = fr[k].astype(np.float64) - f0[k]
        err = np.linalg.norm(fm[k] - f0[k] - d_jax)
        norm = np.linalg.norm(d_jax)
        assert norm > 0, k
        assert err <= 0.5 * norm, (k, err / norm)
        off, total = off + err ** 2, total + norm ** 2
    assert off <= 0.2 ** 2 * total, np.sqrt(off / total)


def _golden():
    import os

    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        unflatten_tree)

    path = os.path.join(os.path.dirname(__file__), "golden",
                        "torch_port_infer_small.npz")
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})


def test_golden_equals_a_live_jax_run(jax_inference):
    """tests/golden/torch_port_infer_small.npz is what
    tests/make_torch_port_infer_golden.py writes now (rewrite it after
    changing torch_port_infer.py or the JAX inference)."""
    import json

    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree)

    trees, summary, recorded, key = jax_inference
    golden = _golden()
    live = TI.golden_arrays(0, summary, recorded, TI.jax_posthoc_draws(
        key, (TI.MAX_CACHE, TI.T, TI.K)))
    stored = flatten_tree({k: v for k, v in golden.items() if k != "config"})
    assert stored.keys() == live.keys()
    for k, v in live.items():
        if k.startswith("summary/"):     # jit compiles may reorder sums
            np.testing.assert_allclose(stored[k], v, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)
    assert json.loads(bytes(golden["config"]).decode()) == TI.config("")


def test_port_matches_the_infer_golden(tmp_path):
    """What chip_smoke.py checks on the card, here on the CPU: the port
    on the golden's draws and the probes' seeded initial weights, every
    summary value within its tolerance."""
    golden = _golden()
    trees, draws = TI.golden_inputs(golden)
    summary = TI.port_run_inference(trees, str(tmp_path), draws)
    worst, bad = TI.check_against_golden(summary, golden)
    assert not bad and worst <= 1.0
    assert len(summary) == len(golden["summary"]) == 53
