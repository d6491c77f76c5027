"""The behavior evaluation protocol of the port against the JAX package's,
on the CPU.

The five sequence metrics (``metrics/sequence.py``, rtol 1e-5), the
cross-transfer, mu-consistency and CF scores, the post-hoc probes
``Classifier`` and ``Regressor`` (converters, forward), and
``train_posthoc_classifiers`` at a few iterations, both from the probes'
numpy-seeded initial weights (``torch_port_infer.seeded_probes``) and
with the JAX run's batch indices handed in
(``torch_port_infer.jax_posthoc_draws``), all on the same numpy-seeded
inputs.  The probes' bf16 forward is held against the JAX modules' bf16
forward.
"""
import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu.experiments import (
    eval_protocol as jax_protocol)
from behavior_driven_video_synthesis_tpu.metrics import sequence as jax_seq

from behavior_driven_video_synthesis_tpu_torch.experiments import (
    eval_protocol)
from behavior_driven_video_synthesis_tpu_torch.flax_npz import flatten_tree
from behavior_driven_video_synthesis_tpu_torch.metrics import sequence
from behavior_driven_video_synthesis_tpu_torch.models import convert
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.probes import (
    Classifier, ClassifierAction, Regressor)

import torch_port_infer as TI

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Thousands of small ops: one intra-op thread keeps them from
    contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


METRICS = ("average_pairwise_distance", "average_self_distance",
           "final_self_distance", "average_displacement_error",
           "final_displacement_error")


def _samples(seed=0, B=3, S=4, T=6, J=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, T, J, 3).astype(np.float32),
            rng.randn(B, T, J, 3).astype(np.float32))


@pytest.mark.parametrize("name", METRICS)
def test_sequence_metric_matches_jax(name):
    samples, gt = _samples()
    args = (samples,) if "displacement" not in name else (samples, gt)
    got = getattr(sequence, name)(*(torch.from_numpy(a) for a in args))
    want = getattr(jax_seq, name)(*args)
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_sequence_sample_metrics_matches_jax():
    samples, gt = _samples(1, S=2)
    got = sequence.sequence_sample_metrics(torch.from_numpy(samples),
                                           torch.from_numpy(gt))
    want = jax_seq.sequence_sample_metrics(samples, gt)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_cross_transfer_and_mu_consistency_match_jax():
    rng = np.random.RandomState(2)
    cross, src = rng.randn(2, 6, 8, 9).astype(np.float32)
    mu, mu_re, mu_rel = rng.randn(3, 6, 16).astype(np.float32)
    for got, want in (
            (eval_protocol.cross_transfer_metrics(torch.from_numpy(cross),
                                                  src),
             jax_protocol.cross_transfer_metrics(cross, src)),
            (eval_protocol.mu_consistency_metrics(mu, mu_re, mu_rel),
             jax_protocol.mu_consistency_metrics(mu, mu_re, mu_rel))):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_action_transfer_scores_match_jax():
    from behavior_driven_video_synthesis_tpu.models import (
        ClassifierAction as JCA)

    rng = np.random.RandomState(3)
    cross, src = rng.randn(2, 8, 7, 9).astype(np.float32)
    labels = rng.randint(0, 3, 8)
    module = init_random_(ClassifierAction(9, 3, dim=16),
                          np.random.RandomState(4)).eval()
    tree = convert.classifier_action_to_flax(module.state_dict())
    jmod = JCA(n_classes=3, dim=16)
    got = eval_protocol.action_transfer_scores(module, cross, src,
                                               torch.from_numpy(labels))
    want = jax_protocol.action_transfer_scores(
        lambda x: jmod.apply({"params": tree}, x), cross, src, labels)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _probe_cases():
    from behavior_driven_video_synthesis_tpu.models import (
        Classifier as JC, Regressor as JR)

    rng = np.random.RandomState(5)
    seq = rng.randn(4, 7, 9).astype(np.float32)
    mu = rng.randn(4, 16).astype(np.float32)
    return {"classifier": (lambda dt: Classifier(9, 1, dtype=dt),
                           lambda dt: JC(n_classes=1, dtype=dt), seq),
            "regressor": (lambda dt: Regressor(16, 9, dtype=dt),
                          lambda dt: JR(n_out=9, dtype=dt), mu)}


@pytest.mark.parametrize("name", ["classifier", "regressor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_posthoc_probe_converters_and_forward(name, dtype):
    """The trees of the flax modules' init round-trip exactly through the
    port's converters; the forward matches at atol 1e-5 in f32 and 2e-2
    in bf16 (products in bf16 on both sides)."""
    import jax
    import jax.numpy as jnp

    make, jmake, x = _probe_cases()[name]
    tree = jax.tree_util.tree_map(np.asarray, jmake(jnp.float32).init(
        jax.random.PRNGKey(1), x)["params"])
    sd = getattr(convert, f"{name}_from_flax")(tree)
    back = flatten_tree(getattr(convert, f"{name}_to_flax")(sd))
    assert back.keys() == flatten_tree(tree).keys()
    for k, v in flatten_tree(tree).items():
        assert np.array_equal(back[k], v), k
    module = make(getattr(torch, dtype))
    module.load_state_dict(sd)
    with torch.no_grad():
        got = module(torch.from_numpy(x)).float().numpy()
    want = np.asarray(jmake(getattr(jnp, dtype)).apply({"params": tree}, x),
                      np.float32)
    assert all(p.dtype == torch.float32 for p in module.parameters())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 if dtype == "float32" else 2e-2)


def test_train_posthoc_classifiers_matches_jax():
    """Four SGD/Adam iterations at batch 32 of every restart from the JAX
    run's initial parameters and batch indices: the scores within atol
    1e-4, the accuracies within one of the 12 cached sequences, DE and the
    regressor's losses rtol 1e-4."""
    _check_posthoc_against_jax()


def test_posthoc_scores_in_chunks_match_jax(monkeypatch):
    """The same, with the cache scored in chunks of 5 (5, 5, 2), as the
    reference's 25,000 cached sequences are in chunks of SCORE_CHUNK."""
    monkeypatch.setattr(eval_protocol, "SCORE_CHUNK", 5)
    _check_posthoc_against_jax()


def _check_posthoc_against_jax():
    import jax

    rng = np.random.RandomState(6)
    n, t, k, h = 12, 8, 9, 16
    real = rng.randn(n, t, k).astype(np.float32)
    fakes = {s: (real + rng.randn(n, t, k) * (0.5 + i)).astype(np.float32)
             for i, s in enumerate(TI.SOURCES)}
    mu = rng.randn(n, h).astype(np.float32)
    key = jax.random.PRNGKey(3)
    with TI.seeded_probes(np.asarray(key), list(fakes), real.shape):
        want = jax_protocol.train_posthoc_classifiers(
            key, real, fakes, mu=mu, n_iters=4, batch_size=32)
    posthoc = TI.jax_posthoc_draws(np.asarray(key), real.shape, n_iters=4,
                                   batch_size=32)
    draws = TI.recorded_draws({}, posthoc).posthoc
    got = eval_protocol.train_posthoc_classifiers(
        torch.from_numpy(real), {s: torch.from_numpy(f)
                                 for s, f in fakes.items()},
        mu=mu, n_iters=4, batch_size=32, draws=draws)
    assert list(got) == list(want)
    for key_, v in want.items():
        if key_.startswith("score_"):
            tol = dict(rtol=0, atol=1e-4)
        elif key_.startswith("acc_"):
            tol = dict(rtol=0, atol=1.0 / n + 1e-6)
        else:
            tol = dict(rtol=1e-4, atol=0)
        np.testing.assert_allclose(got[key_], v, err_msg=key_, **tol)


def test_posthoc_draws_come_from_the_generator():
    """The default draws come from the generator: the same seed gives the
    same result, another seed another."""
    rng = np.random.RandomState(7)
    real = rng.randn(6, 4, 3).astype(np.float32)
    fakes = {"prior": (real + rng.randn(6, 4, 3)).astype(np.float32)}
    mu = rng.randn(6, 8).astype(np.float32)

    def run(seed):
        return eval_protocol.train_posthoc_classifiers(
            real, fakes, mu=mu, starts=(0, 3), n_iters=2, batch_size=5,
            draws=eval_protocol.PosthocDraws(
                torch.Generator().manual_seed(seed)))
    a, b, c = run(0), run(0), run(1)
    assert a == b and a != c
    assert set(a) == {"score_prior_t0", "acc_prior_t0", "score_prior_t3",
                      "acc_prior_t3", "score_prior", "acc_prior",
                      "loss_regressor_t0", "loss_regressor_t3",
                      "loss_regressor_posthoc"}
