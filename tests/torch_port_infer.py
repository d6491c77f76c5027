"""The small behavior_net inference run, set up for both packages from one
numpy seed.

Shared by ``tests/test_torch_behavior_infer.py`` and the golden maker
``tests/make_torch_port_infer_golden.py``.  Shapes: 9 keypoints,
``dim_hidden_b`` 16, T=8, B=4, 3 actions, 16 synthetic test sequences, 3
flows of mid width 32, n_samples S=3 rollouts per sequence over 2
batches, a rollout cache of 8 sequences and 3 post-hoc iterations; the
modules at the experiment's own widths (the action LSTM at 512), f32.
The weights are drawn into the port's modules with numpy and exported as
flax trees.

The JAX experiment's ``run_inference`` runs as it is, with these
patched in: its train states are built from those trees (no init) and its
checkpoint managers hand them out; ``jax.random.normal`` records each
draw of inference by its site (found from the callers while tracing; the
value through ``jax.debug.callback``); and ``train_posthoc_classifiers``
records its key, from which :func:`jax_posthoc_draws` derives that
function's batch indices as it does, while its probes start from weights
drawn with numpy (:func:`probe_trees`, patched in by
:func:`seeded_probes`).  The port's run then takes the recorded draws
(:func:`recorded_draws`).
"""
from __future__ import annotations

import inspect
import os
from contextlib import ExitStack, contextmanager
from unittest import mock

import numpy as np

K, H, T, B, N_ACTIONS = 9, 16, 8, 4, 3
N_FLOWS, FLOW_MID = 3, 32
N_SAMPLES, MAX_BATCHES = 3, 2
MAX_CACHE, POSTHOC_ITERS, POSTHOC_BATCH = 8, 3, 256
MODULES = ("net", "regressor", "cls_action", "cls_action2", "cls_beta")
TO_FLAX = {"net": "behavior_net", "regressor": "regressor_fly",
           "cls_action": "classifier_action",
           "cls_action2": "sequence_disc_michael",
           "cls_beta": "classifier_action_beta", "flow": "latent_flow"}
SOURCES = ("prior", "cross", "self", "flow")
# the post-hoc probes: a classifier per source, and the regressor
PROBES = SOURCES + ("regressor",)
PROBE_SEED = 0


def config(base_dir: str) -> dict:
    return {
        "general": {"experiment": "behavior_net", "seed": 0,
                    "project_name": "infer", "base_dir": base_dir},
        "data": {"dataset": "synthetic", "n_kps": K, "n_actions": N_ACTIONS,
                 "seq_length": [T, T + 1], "n_samples": 16},
        "architecture": {"decoder_arch": "lstm", "dim_hidden_b": H,
                         "n_flows": N_FLOWS, "flow_hidden_depth": 2,
                         "flow_mid_channels_factor": FLOW_MID // H,
                         "cvae": False},
        "training": {"batch_size": B, "n_epochs": 1},
        "metrics": {"max_cache": MAX_CACHE, "posthoc_iters": POSTHOC_ITERS},
        "logging": {"metrics_every": 1},
    }


def dirs(base_dir: str) -> dict:
    return {d: os.path.join(base_dir, "behavior_net", d, "infer")
            for d in ("ckpt", "config", "generated", "log")}


def make_trees(seed: int = 0) -> dict:
    """Flax trees of the five modules and the flow, at the experiment's
    widths, from numpy seed ``seed``."""
    import torch

    from behavior_driven_video_synthesis_tpu_torch.experiments.behavior_net \
        import BehaviorNetExperiment
    from behavior_driven_video_synthesis_tpu_torch.models import convert
    from behavior_driven_video_synthesis_tpu_torch.models.init import (
        init_random_)

    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        exp = BehaviorNetExperiment(config(tmp), dirs(tmp), "cpu")
        modules = dict(exp._build_models(K, N_ACTIONS, T),
                       flow=exp._build_flow())
    rng = np.random.RandomState(seed)
    trees = {}
    for name, m in modules.items():
        init_random_(m, rng)
        with torch.no_grad():
            for g in (x for x in m.modules()
                      if isinstance(x, torch.nn.GroupNorm)):
                g.weight.copy_(torch.from_numpy(
                    1.0 + 0.1 * rng.randn(*g.weight.shape)))
        trees[name] = getattr(convert, f"{TO_FLAX[name]}_to_flax")(
            m.state_dict())
    return trees


def write_port_checkpoints(trees, base_dir: str):
    """The trees as the port's reg_ckpt and flow_ckpt saves of the run
    ``infer`` under base_dir."""
    from behavior_driven_video_synthesis_tpu_torch.core.checkpoint import (
        CheckpointManager)
    from behavior_driven_video_synthesis_tpu_torch.models import convert

    ckpt = dirs(base_dir)["ckpt"]
    sds = {n: getattr(convert, f"{TO_FLAX[n]}_from_flax")(trees[n])
           for n in TO_FLAX}
    CheckpointManager(os.path.join(ckpt, "reg_ckpt")).save(1, {"state": {
        "modules": {n: sds[n] for n in MODULES}}})
    CheckpointManager(os.path.join(ckpt, "flow_ckpt")).save(1, {"state": {
        "flow": sds["flow"]}})


# -- the JAX run ---------------------------------------------------------------

class _Restored:
    """A checkpoint manager whose newest save is the template itself."""

    def restore_latest(self, template):
        return template, 1


def _site(counters):
    """The inference draw site of a jax.random.normal call, from its
    callers, or None for a draw the port does not make.  Under ``jit``
    this runs while tracing."""
    frame = inspect.currentframe().f_back.f_back
    while frame is not None:
        name = frame.f_code.co_name
        if name == "eval_step":
            return "eval_eps"
        if name == "_sample_rollouts":
            return ("prior_z" if frame.f_locals.get("flow_model") is None
                    else "flow_z")
        if name == "forward_all":
            # the cross transfer's posterior, the prior draw, then the two
            # re-encodings whose noise goes unused
            n = counters.setdefault(frame, 0)   # (keeps the frame alive)
            counters[frame] = n + 1
            return ("cross_eps", "prior_b", None, None)[n]
        if name == "_run_posthoc_protocol":
            return "flow_codes"
        if name in ("run_inference", "train_posthoc_classifiers"):
            return None
        frame = frame.f_back
    return None


def jax_run_inference(trees, base_dir: str):
    """The JAX experiment's run_inference on the trees.  Returns (summary,
    {site: [draws]}, the post-hoc key)."""
    import jax
    import jax.numpy as jnp

    from behavior_driven_video_synthesis_tpu.core import Config
    from behavior_driven_video_synthesis_tpu.experiments import (
        behavior_net as jax_exp, eval_protocol as jax_protocol)
    from behavior_driven_video_synthesis_tpu.train.behavior import (
        BehaviorTrainState)
    from behavior_driven_video_synthesis_tpu.train.flow import FlowTrainState
    from behavior_driven_video_synthesis_tpu.train.state import ModuleState

    exp = jax_exp.BehaviorNetExperiment(Config(config(base_dir)),
                                        dirs(base_dir))
    exp.mesh = None                     # one device: no batch sharding

    # the states the restores hand out, built from the trees (instead of
    # initialized and then overwritten)
    def behavior_state(key, *models_txs_batch_len, **kw):
        txs = models_txs_batch_len[5]
        return BehaviorTrainState(
            step=jnp.zeros((), jnp.int32), gamma=jnp.zeros((), jnp.float32),
            **{n: ModuleState.create({"params": trees[n]}, txs[n])
               for n in MODULES})

    def flow_state(key, flow_model, tx, sample_b):
        return FlowTrainState(step=jnp.zeros((), jnp.int32),
                              flow=ModuleState.create(trees["flow"], tx))

    recorded = {}
    counters = {}
    posthoc_key = []
    orig_normal = jax.random.normal
    orig_posthoc = jax_protocol.train_posthoc_classifiers

    def normal(key, shape=(), dtype=None, **kw):
        out = (orig_normal(key, shape, **kw) if dtype is None
               else orig_normal(key, shape, dtype, **kw))
        site = _site(counters)
        if site is not None:
            # the value, when it runs (each site's runs are in order)
            jax.debug.callback(lambda v, site=site: recorded.setdefault(
                site, []).append(np.asarray(v, np.float32)), out)
        return out

    def posthoc(key, real, fake_sets, *a, **kw):
        posthoc_key.append(np.asarray(key))
        with seeded_probes(key, list(fake_sets), np.shape(real)):
            return orig_posthoc(key, real, fake_sets, *a, **kw)

    with ExitStack() as stack:
        for target, attr, new in (
                (exp, "ckpt_manager", lambda role: _Restored()),
                (jax_exp, "create_behavior_state", behavior_state),
                (jax_exp, "create_flow_state", flow_state),
                (jax_protocol, "train_posthoc_classifiers", posthoc)):
            stack.enter_context(mock.patch.object(target, attr, new))
        stack.enter_context(mock.patch("jax.random.normal", normal))
        summary = exp.run_inference(n_samples=N_SAMPLES,
                                    max_batches=MAX_BATCHES)
    jax.effects_barrier()
    return summary, recorded, posthoc_key[0]


def n_restarts(t_len: int) -> int:
    """The post-hoc protocol's restarts: its start frames clipped to the
    sequence length."""
    from behavior_driven_video_synthesis_tpu_torch.experiments.eval_protocol \
        import DEFAULT_PROBE_STARTS

    return len(dict.fromkeys(min(t, t_len - 1) for t in DEFAULT_PROBE_STARTS))


def probe_trees(seed: int, sources, n_restarts: int, n_in: int = K,
                n_mu: int = H) -> dict:
    """{probe: [flax trees of its n_restarts initial parameter sets]}: a
    real/fake classifier over n_in features per source, and the mu ->
    pose regressor under "regressor"; restart s of probe PROBES[i] drawn
    into the port's module with numpy seed [seed, i, s]."""
    import torch

    from behavior_driven_video_synthesis_tpu_torch.models import convert
    from behavior_driven_video_synthesis_tpu_torch.models.init import (
        init_random_)
    from behavior_driven_video_synthesis_tpu_torch.models.probes import (
        Classifier, Regressor)

    out = {}
    for name in list(sources) + ["regressor"]:
        trees = []
        for r in range(n_restarts):
            m = (Regressor(n_mu, n_in) if name == "regressor"
                 else Classifier(n_in, 1))
            with torch.no_grad():
                init_random_(m, np.random.RandomState(
                    [seed, PROBES.index(name), r]))
            conv = (convert.regressor_to_flax if name == "regressor"
                    else convert.classifier_to_flax)
            trees.append(conv(m.state_dict()))
        out[name] = trees
    return out


def _probe_keys(key_data, sources, n_restarts: int) -> dict:
    """{probe: (restart keys (S, 2), the batch-index loop key)}, derived
    from ``train_posthoc_classifiers``'s key as that function derives
    them."""
    import jax
    import jax.numpy as jnp

    key = jnp.asarray(key_data, jnp.uint32)
    out = {}
    for name in list(sources) + ["regressor"]:
        key, k0, kl = jax.random.split(key, 3)
        out[name] = (np.asarray(jax.random.split(k0, n_restarts)), kl)
    return out


@contextmanager
def seeded_probes(key_data, sources, real_shape, seed: int = PROBE_SEED):
    """Within: the JAX package's post-hoc Classifier and Regressor start
    from :func:`probe_trees`'s weights in ``train_posthoc_classifiers(
    key_data, ...)``.  Their ``init`` picks the tree of the restart whose
    key it is given (the keys derived as that function derives them)."""
    import jax
    import jax.numpy as jnp

    from behavior_driven_video_synthesis_tpu.experiments import (
        eval_protocol as jax_protocol)

    S = n_restarts(real_shape[1])
    trees = probe_trees(seed, sources, S, real_shape[2])
    keys = _probe_keys(key_data, sources, S)

    def seeded(module_cls, names):
        table = np.concatenate([keys[n][0] for n in names])
        stacked = jax.tree_util.tree_map(
            lambda *xs: np.stack(xs), *[t for n in names for t in trees[n]])

        class Seeded:
            def __init__(self, **kw):
                self.module = module_cls(**kw)

            def init(self, k, x):
                i = jnp.argmax(jnp.all(jnp.asarray(table) == k, axis=-1))
                return {"params": jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a)[i], stacked)}

            def apply(self, *a, **kw):
                return self.module.apply(*a, **kw)
        return Seeded

    with mock.patch.object(jax_protocol, "Classifier",
                           seeded(jax_protocol.Classifier, list(sources))), \
            mock.patch.object(jax_protocol, "Regressor",
                              seeded(jax_protocol.Regressor, ["regressor"])):
        yield


def jax_posthoc_draws(key_data, real_shape, sources=SOURCES,
                      n_iters: int = POSTHOC_ITERS,
                      batch_size: int = POSTHOC_BATCH,
                      seed: int = PROBE_SEED):
    """The draws of ``train_posthoc_classifiers(key, ...)`` of the JAX
    package under :func:`seeded_probes`: {probe: (flax trees of the S
    initial parameter sets, (n_iters, S, batch) indices)}; the indices
    derived from its key as it derives them."""
    import jax

    n, t_len, k = real_shape
    S = n_restarts(t_len)
    trees = probe_trees(seed, sources, S, k)

    def indices(kloop, size):
        return np.stack([np.asarray(jax.vmap(
            lambda kk: jax.random.randint(kk, (batch_size,), 0, size))(
                jax.random.split(jax.random.fold_in(kloop, i), S)))
            for i in range(n_iters)])

    return {name: (trees[name], indices(kl, n))
            for name, (_, kl) in _probe_keys(key_data, sources, S).items()}


# -- the port's run ------------------------------------------------------------

def recorded_draws(recorded, posthoc):
    """An InferenceDraws of the port that hands out the recorded draws, in
    order per site, and the post-hoc draws of :func:`jax_posthoc_draws`."""
    import torch

    from behavior_driven_video_synthesis_tpu_torch.experiments.behavior_net \
        import InferenceDraws
    from behavior_driven_video_synthesis_tpu_torch.experiments.eval_protocol \
        import PosthocDraws
    from behavior_driven_video_synthesis_tpu_torch.models import convert

    class Posthoc(PosthocDraws):
        def initial_params(self, source, make, n_restarts):
            trees = posthoc[source][0]
            assert len(trees) == n_restarts
            conv = (convert.regressor_from_flax if source == "regressor"
                    else convert.classifier_from_flax)
            return [conv(t) for t in trees]

        def batch_indices(self, source, it, n_restarts, batch_size, n,
                          device):
            idx = posthoc[source][1][it]
            assert idx.shape == (n_restarts, batch_size)
            return torch.as_tensor(idx, dtype=torch.long, device=device)

    class Recorded(InferenceDraws):
        def __init__(self):
            self.queues = {k: list(v) for k, v in recorded.items()}
            self.posthoc = Posthoc()

        def normal(self, site, shape, device):
            v = self.queues[site].pop(0)
            assert tuple(v.shape) == tuple(shape), (site, v.shape, shape)
            return torch.tensor(v, device=device)

    return Recorded()


def port_run_inference(trees, base_dir: str, draws, device="cpu"):
    """The port's run_inference on the trees (written as its checkpoints)
    with the given draws; returns the summary."""
    from behavior_driven_video_synthesis_tpu_torch.experiments.behavior_net \
        import BehaviorNetExperiment

    write_port_checkpoints(trees, base_dir)
    exp = BehaviorNetExperiment(config(base_dir), dirs(base_dir),
                                device)
    return exp.run_inference(n_samples=N_SAMPLES, max_batches=MAX_BATCHES,
                             draws=draws)


# Tolerances of the port's summary against the JAX run's (f32, the same
# draws): the sample, drift, consistency and regressor metrics differ only
# in summation order (rtol 1e-4, atol 1e-5); the KS p-value rtol 1e-3;
# the post-hoc classifiers' mean sigmoids atol 1e-4 after their SGD steps;
# the accuracies (a mean of thresholded sigmoids or argmaxes over at most
# 8 sequences) and CF scores exactly, or within one sequence where a value
# sits at the threshold.
RTOL, ATOL = 1e-4, 1e-5


def summary_tolerance(key: str):
    """(rtol, atol) for a summary key."""
    if key == "flow_ks_p":
        return 1e-3, 0.0
    if key.startswith("score_"):
        return 0.0, 1e-4
    if key.startswith("acc_") or key in ("CF_cross", "CF_action",
                                         "CF_action_beta"):
        return 0.0, 1.0 / MAX_CACHE + 1e-6
    return RTOL, ATOL


def check_summary(mine: dict, ref: dict, skip=()):
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
        if k.startswith(tuple(skip)):
            continue
        rtol, atol = summary_tolerance(k)
        np.testing.assert_allclose(mine[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


# -- the golden ----------------------------------------------------------------

def digests(trees) -> dict:
    """{module: sum of |leaf| in float64}: a check that a machine rebuilt
    the seeded weights."""
    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree)

    return {n: np.float64(sum(np.abs(np.asarray(v, np.float64)).sum()
                              for v in flatten_tree(t).values()))
            for n, t in trees.items()}


def golden_arrays(seed, summary, recorded, posthoc) -> dict:
    """The golden's arrays: the seeds of the weights and of the post-hoc
    probes' initial weights with their digests, the inference draws, every
    probe's batch indices, and the JAX run's summary."""
    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree)

    return flatten_tree({
        "params_seed": np.int64(seed),
        "probe_seed": np.int64(PROBE_SEED),
        "digest": digests(make_trees(seed)),
        "probe_digest": _probe_digests(
            {n: trees for n, (trees, _) in posthoc.items()}),
        "draws": {site: {str(i): v for i, v in enumerate(vs)}
                  for site, vs in recorded.items()},
        "posthoc": {"indices": {src: idx.astype(np.int16)
                                for src, (_, idx) in posthoc.items()}},
        "summary": {k: np.float64(v) for k, v in summary.items()}})


def _probe_digests(trees) -> dict:
    return digests({n: {str(s): t for s, t in enumerate(ts)}
                    for n, ts in trees.items()})


def _check_digests(mine, stored, what):
    for n, d in mine.items():
        if not np.isclose(d, stored[n], rtol=1e-12):
            raise AssertionError(f"rebuilt {what} of {n}: digest {d} vs "
                                 f"{stored[n]}")


def golden_inputs(golden):
    """(trees, draws) of a golden read with ``unflatten_tree``: the
    weights and the probes' initial weights rebuilt from their seeds
    (checked against the digests), and draws that hand out the golden's."""
    trees = make_trees(int(golden["params_seed"]))
    _check_digests(digests(trees), golden["digest"], "weights")
    indices = {src: np.asarray(idx, np.int64)
               for src, idx in golden["posthoc"]["indices"].items()}
    probes = probe_trees(int(golden["probe_seed"]),
                         [s for s in SOURCES if s in indices],
                         indices["regressor"].shape[1])
    _check_digests(_probe_digests(probes), golden["probe_digest"],
                   "probe weights")
    posthoc = {src: (probes[src], idx) for src, idx in indices.items()}
    recorded = {site: [vs[str(i)] for i in range(len(vs))]
                for site, vs in golden["draws"].items()}
    return trees, recorded_draws(recorded, posthoc)


def check_against_golden(summary, golden):
    """The port's summary against the golden's: every key, and every value
    within ``summary_tolerance``.  Returns (the worst |error| / tolerance,
    a list of the failures)."""
    ref = {k: float(v) for k, v in golden["summary"].items()}
    bad = [f"keys {sorted(set(summary) ^ set(ref))}"] if sorted(
        summary) != sorted(ref) else []
    worst = 0.0
    for k, v in ref.items():
        got = summary.get(k, float("nan"))
        rtol, atol = summary_tolerance(k)
        tol = atol + rtol * abs(v)
        err = abs(got - v)
        if not err <= tol:
            bad.append(f"{k} {got} vs {v} (tolerance {tol:.3g})")
        worst = max(worst, err / tol)
    return worst, bad
