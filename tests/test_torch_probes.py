"""The behavior experiment's probe heads against the JAX package's, on the
CPU.

``RegressorFly``, ``ClassifierAction``, ``ClassifierActionBeta`` and
``SequenceDiscMichael`` (``models/probes.py``, ``models/discriminators.py``)
with numpy-seeded weights: their state dicts carry the reference's keys,
which the JAX package's ``convert_*`` functions read into the very flax
trees the port's converters write; flax -> torch -> flax is exact; and the
forwards match the JAX modules' at atol 1e-5.
"""
import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu_torch.flax_npz import flatten_tree
from behavior_driven_video_synthesis_tpu_torch.models import convert
from behavior_driven_video_synthesis_tpu_torch.models.discriminators import (
    SequenceDiscMichael)
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.probes import (
    ClassifierAction, ClassifierActionBeta, RegressorFly)

K, H, T, B, N_CLASSES, DIM = 9, 16, 8, 4, 3, 16
ATOL = 1e-5


def _case(name, layers=(2, 1, 1, 1)):
    """(port module, JAX module, the JAX package's converter, the
    forward's inputs as numpy arrays)."""
    from behavior_driven_video_synthesis_tpu.models import (
        ClassifierAction as JCA, ClassifierActionBeta as JCB,
        RegressorFly as JRF, convert as jconvert)
    from behavior_driven_video_synthesis_tpu.models.discriminators import (
        SequenceDiscMichael as JSD)

    rng = np.random.RandomState(len(name) + sum(layers))
    mu = rng.randn(B, H).astype(np.float32)
    seq = rng.randn(B, T, K).astype(np.float32)
    onehot = np.eye(T, dtype=np.float32)[rng.randint(0, T, B)]
    if name == "regressor_fly":
        return (RegressorFly(H, K, T), JRF(n_out=K, seq_length=T),
                jconvert.convert_regressor_fly, (mu, onehot))
    if name == "classifier_action":
        return (ClassifierAction(K, N_CLASSES, dim=DIM),
                JCA(n_classes=N_CLASSES, dim=DIM),
                jconvert.convert_classifier_action, (seq,))
    if name == "classifier_action_beta":
        return (ClassifierActionBeta(H, N_CLASSES),
                JCB(n_classes=N_CLASSES),
                jconvert.convert_classifier_action_beta, (mu,))
    vel = seq[:, 1:] - seq[:, :-1]
    return (SequenceDiscMichael(K, T - 1, layers=layers, out_dim=N_CLASSES),
            JSD(layers=layers, out_dim=N_CLASSES),
            lambda sd: jconvert.convert_sequence_disc_michael(sd, layers),
            (vel,))


CASES = [("regressor_fly", (2, 1, 1, 1)),
         ("classifier_action", (2, 1, 1, 1)),
         ("classifier_action_beta", (2, 1, 1, 1)),
         ("sequence_disc_michael", (2, 1, 1, 1)),
         ("sequence_disc_michael", (1, 3, 1, 1))]


def _seeded(module, seed):
    rng = np.random.RandomState(seed)
    init_random_(module, rng)
    with torch.no_grad():        # GroupNorm scales away from 1
        for m in module.modules():
            if isinstance(m, torch.nn.GroupNorm):
                m.weight.add_(torch.from_numpy(
                    0.2 * rng.randn(*m.weight.shape).astype(np.float32)))
    return module


@pytest.mark.parametrize("name,layers", CASES)
def test_keys_are_the_references_and_round_trip_exactly(name, layers):
    module, _, jax_convert, _ = _case(name, layers)
    state = _seeded(module, 0).state_dict()
    sd = {k: v.numpy() for k, v in state.items()}
    to_flax = getattr(convert, f"{name}_to_flax")
    from_flax = getattr(convert, f"{name}_from_flax")
    mine = flatten_tree(to_flax(state))
    # the JAX package's converter reads the port's keys into the same tree
    ref = {k: np.asarray(v) for k, v in
           flatten_tree(jax_convert(sd)["params"]).items()}
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k].dtype == ref[k].dtype and np.array_equal(
            mine[k], ref[k]), k
    back = from_flax({"params": to_flax(state)})
    assert back.keys() == sd.keys()
    for k, v in back.items():
        assert np.array_equal(v.numpy(), sd[k]), k
    again = flatten_tree(to_flax(back))
    assert all(np.array_equal(again[k], mine[k]) for k in mine)


@pytest.mark.parametrize("name,layers", CASES)
def test_forward_matches_jax(name, layers):
    module, jax_module, _, args = _case(name, layers)
    _seeded(module, 1).eval()
    tree = getattr(convert, f"{name}_to_flax")(module.state_dict())
    ref = jax_module.apply({"params": tree}, *args)
    with torch.no_grad():
        out = module(*(torch.from_numpy(a) for a in args))
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    assert len(out) == len(ref)
    logits, ref_logits = out[0].numpy(), np.asarray(ref[0])
    assert logits.shape == ref_logits.shape
    np.testing.assert_allclose(logits, ref_logits, rtol=0, atol=ATOL)
    if len(out) == 2:           # the features: (B, C, T') C-major in torch
        feat = out[1].numpy()
        if name == "sequence_disc_michael":
            feat = feat.transpose(0, 2, 1)
        np.testing.assert_allclose(feat, np.asarray(ref[1]), rtol=0,
                                   atol=ATOL)


def test_fresh_weights_follow_the_jax_initializers():
    """init_like_jax_ on the behavior experiment's five modules and flow
    against the JAX package's ``init`` of the same modules at a moderate
    width: the same leaves, zeros where flax puts zeros, the same spread
    elsewhere (std within 10 % for leaves of 1,000 values or more), the
    LSTMs' uniform bound, and a permutation in every Shuffle."""
    import jax

    from behavior_driven_video_synthesis_tpu.models import (
        ClassifierAction as JCA, ClassifierActionBeta as JCB,
        RegressorFly as JRF, ResidualBehaviorNet as JNet)
    from behavior_driven_video_synthesis_tpu.models.discriminators import (
        SequenceDiscMichael as JSD)
    from behavior_driven_video_synthesis_tpu.models.flows import (
        LatentFlow as JFlow)
    from behavior_driven_video_synthesis_tpu_torch.models.behavior import (
        ResidualBehaviorNet)
    from behavior_driven_video_synthesis_tpu_torch.models.flows import (
        LatentFlow)
    from behavior_driven_video_synthesis_tpu_torch.models.init import (
        init_like_jax_)

    k, h, t, n = 51, 128, 10, 4
    rng = np.random.RandomState(0)
    seq = rng.randn(n, t, k).astype(np.float32)
    mu = rng.randn(n, h).astype(np.float32)
    onehot = np.eye(t, dtype=np.float32)[[0, 1, 2, 3]]
    key = jax.random.PRNGKey(0)
    cases = {
        "behavior_net": (ResidualBehaviorNet(k, h), JNet(
            n_kps=k, dim_hidden_b=h).init({"params": key, "sample": key},
                                           seq, seq, t)),
        "regressor_fly": (RegressorFly(h, k, t), JRF(
            n_out=k, seq_length=t).init(key, mu, onehot)),
        "classifier_action": (ClassifierAction(k, 5, dim=64), JCA(
            n_classes=5, dim=64).init(key, seq)),
        "sequence_disc_michael": (SequenceDiscMichael(k, t - 1, out_dim=5),
                                  JSD(out_dim=5).init(key, seq[:, 1:])),
        "classifier_action_beta": (ClassifierActionBeta(h, 5), JCB(
            n_classes=5).init(key, mu)),
        "latent_flow": (LatentFlow(h, 2 * h, 2, 2), JFlow(
            flow_in_channels=h, flow_mid_channels=2 * h, flow_hidden_depth=2,
            n_flows=2).init({"params": key}, mu)),
    }
    g = torch.Generator().manual_seed(0)
    for name, (module, ref) in cases.items():
        init_like_jax_(module, g)
        mine = flatten_tree(getattr(convert, f"{name}_to_flax")(
            module.state_dict()))
        ref = {k_: np.asarray(v) for k_, v in flatten_tree(
            jax.tree_util.tree_map(np.asarray, dict(ref))).items()}
        if name != "latent_flow":
            ref = {f"params/{k_[len('params/'):]}": v for k_, v in ref.items()}
            mine = {f"params/{k_}": v for k_, v in mine.items()}
        assert mine.keys() == ref.keys(), name
        for leaf, want in ref.items():
            got = mine[leaf]
            assert got.shape == want.shape, leaf
            if leaf.endswith(("/loc", "/scale")):    # set from data
                continue
            if leaf.endswith("/perm"):
                assert sorted(got) == list(range(got.size)), leaf
            elif not want.any():
                assert not got.any(), leaf
            elif want.size >= 1000 and want.std() > 0:
                assert abs(got.std() / want.std() - 1) < 0.1, leaf
            if "LSTM" in leaf or "/rnn/" in leaf or "decoder" in leaf:
                bound = np.abs(want).max()
                assert np.abs(got).max() <= bound * 1.01 + 1e-6, leaf
