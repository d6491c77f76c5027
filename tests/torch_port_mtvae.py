"""The small MT-VAE training step, set up for both packages from one numpy
seed.

Shared by ``tests/test_torch_mtvae.py``, ``tests/test_torch_mtvae_train.py``,
the golden maker ``tests/make_torch_port_mtvae_golden.py`` and
``chip_smoke.py`` phase [17].  Shapes: 9 keypoints, dim 32, z 16, n_cond
3, T=8 (5 predicted frames, so k_v = 5), B=4, f32.  The weights are drawn
into the port's MTVAE with numpy and exported as a flax tree for the JAX
package.  Each step's five draws (h0, c0, the latent noise, the cycle
noise and the cycle target) are handed to the port and, in the order the
JAX step draws them, patched into ``jax.random.normal``
(:func:`jax_noise_in_order`).
"""
from __future__ import annotations

import contextlib
import json
from unittest import mock

import numpy as np

K, DIM, Z, N_COND, T, B = 9, 32, 16, 3, 8, 4
N_STEPS = 2
TOTAL_STEPS = 4          # the KL ramp's length: weights 0.25 and 0.5
SEED = 0
SITES = ("h0", "c0", "z", "cycle", "target")


def config() -> dict:
    return {
        "general": {"experiment": "mtvae", "seed": SEED},
        "data": {"dataset": "synthetic", "n_kps": K, "n_actions": 3,
                 "seq_length": [T - 1, T]},
        "training": {"batch_size": B, "n_epochs": 1, "lr_init": 1e-3,
                     "weight_decay": 1e-4, "n_cond": N_COND, "k_vel": 8,
                     "weight_motion": 10.0, "weight_cycle": 10.0},
    }


def port_model(dtype=None, device=None):
    import torch

    from behavior_driven_video_synthesis_tpu_torch.models.mtvae import MTVAE

    return MTVAE(K, N_COND, DIM, Z, dtype=dtype or torch.float32,
                 device=device)


def jax_model(dtype=None):
    import jax.numpy as jnp

    from behavior_driven_video_synthesis_tpu.models.mtvae import MTVAE

    return MTVAE(n_in=K, n_cond=N_COND, dim=DIM, z_dim=Z,
                 dtype=dtype or jnp.float32)


def noise_shapes():
    return {"h0": (B, DIM), "c0": (B, DIM), "z": (B, DIM // 2),
            "cycle": (B, DIM // 2), "target": (B, DIM // 2)}


def make_inputs(seed: int = SEED):
    """(flax tree of the MTVAE, batch, per-step draws) from numpy seed
    ``seed``."""
    from behavior_driven_video_synthesis_tpu_torch.data.synthetic import (
        SyntheticSequenceDataset)
    from behavior_driven_video_synthesis_tpu_torch.models import convert
    from behavior_driven_video_synthesis_tpu_torch.models.init import (
        init_random_)

    rng = np.random.RandomState(seed)
    model = init_random_(port_model(), rng)
    tree = convert.mtvae_to_flax(model.state_dict())
    ds = SyntheticSequenceDataset(n_samples=B, seq_length=T, n_kps=K,
                                  n_actions=3, seed=seed)
    batch = {"keypoints": ds.keypoints.astype(np.float32),
             "paired_keypoints": ds.keypoints[ds.map_ids].astype(np.float32)}
    noise = [{k: rng.randn(*s).astype(np.float32)
              for k, s in noise_shapes().items()} for _ in range(N_STEPS)]
    return tree, batch, noise


@contextlib.contextmanager
def jax_noise_in_order(noise):
    """Make ``jax.random.normal`` return the given arrays, one a call, in
    order (the MT-VAE's draws share shapes, so they go by order, not by
    shape as ``torch_port_slice.jax_noise`` has it)."""
    import jax.numpy as jnp

    it = iter(noise)

    def normal(key, shape=(), dtype=jnp.float32):
        n = next(it)
        assert tuple(n.shape) == tuple(shape), (n.shape, shape)
        return jnp.asarray(n, dtype)

    with mock.patch("jax.random.normal", normal):
        yield
    assert next(it, None) is None, "a draw was not used"


def jax_steps(tree, batch, noise, enable=True, dtype=None):
    """The JAX package's MT-VAE step, once per entry of ``noise``.
    Returns (per-step metrics, the final flax tree)."""
    import jax
    import jax.numpy as jnp

    from behavior_driven_video_synthesis_tpu.core import Config
    from behavior_driven_video_synthesis_tpu.train.mtvae_exp import (
        MTVAETrainState, make_mtvae_train_step)
    from behavior_driven_video_synthesis_tpu.train.state import (
        ModuleState, torch_adam)

    cfg = Config(config())
    tr = cfg.training
    # the optimizer of experiments/mt_vae.py:_make_tx
    tx = torch_adam(float(tr.lr_init), weight_decay=float(tr.weight_decay))
    state = MTVAETrainState(
        step=jnp.zeros((), jnp.int32),
        net=ModuleState.create({"params": jax.tree_util.tree_map(
            jnp.asarray, tree)}, tx))
    step = make_mtvae_train_step(jax_model(dtype), tx, cfg, TOTAL_STEPS)

    def traced(state, batch, key, enable, draws):
        with jax_noise_in_order([draws[k] for k in SITES]):
            return step(state, batch, key, enable)
    traced = jax.jit(traced)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for i, d in enumerate(noise):
        state, m = traced(state, jbatch, jax.random.PRNGKey(i),
                          jnp.asarray(enable),
                          {k: jnp.asarray(v) for k, v in d.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree_util.tree_map(np.asarray, state.net.params)


def port_state(tree, device="cpu", dtype=None):
    from behavior_driven_video_synthesis_tpu_torch.models import convert
    from behavior_driven_video_synthesis_tpu_torch.train.mtvae_exp import (
        MTVAETrainState)
    from behavior_driven_video_synthesis_tpu_torch.train.state import (
        make_mtvae_optimizer)

    model = port_model(dtype, device)
    model.load_state_dict(convert.mtvae_from_flax(tree))
    return MTVAETrainState(model, make_mtvae_optimizer(
        model, config()["training"]))


def port_steps(tree, batch, noise, device="cpu", enable=True, dtype=None,
               state=None):
    """The port's step as :func:`jax_steps` takes it, on ``device``.
    Returns (per-step metrics, the final flax tree)."""
    import torch

    from behavior_driven_video_synthesis_tpu_torch.models import convert
    from behavior_driven_video_synthesis_tpu_torch.train.mtvae_exp import (
        make_mtvae_train_step)

    def dev(a):
        return torch.as_tensor(a, device=device)

    state = state or port_state(tree, device, dtype)
    step = make_mtvae_train_step(config(), TOTAL_STEPS)
    tbatch = {k: dev(v) for k, v in batch.items()}
    metrics = [{k: float(v) for k, v in step(
        state, tbatch, enable, draws={k: dev(v) for k, v in d.items()}
    ).items()} for d in noise]
    return metrics, convert.mtvae_to_flax(state.model.state_dict())


# Tolerances of the port against the JAX step (f32; on the card with TF32
# off), as the org step's (tests/torch_port_org_train.py): each metric
# rtol 1e-4 (kl_weight 1e-6), and every leaf's update (after minus before)
# within 5 % of the JAX update's norm.
METRIC_RTOL = {"loss": 1e-4, "rec_loss": 1e-4, "kl_loss": 1e-4,
               "motion_loss": 1e-4, "cycle_loss": 1e-4, "kl_weight": 1e-6,
               "grad_norm": 1e-4}
UPDATE_RTOL = 0.05


def check_metrics(mine, ref):
    assert len(mine) == len(ref)
    for m, r in zip(mine, ref):
        assert set(m) == set(r) == set(METRIC_RTOL), (sorted(m), sorted(r))
        for k, rtol in METRIC_RTOL.items():
            assert np.isclose(m[k], r[k], rtol=rtol, atol=0.0), (k, m[k],
                                                                 r[k])


def update_errors(before, mine, ref):
    """{leaf: ||Δport - Δjax|| / ||Δjax||}; inf where JAX left a leaf
    alone and the port did not."""
    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree)

    fb, fm, fr = flatten_tree(before), flatten_tree(mine), flatten_tree(ref)
    assert fb.keys() == fm.keys() == fr.keys()
    out = {}
    for k in fb:
        d_mine = np.asarray(fm[k], np.float64) - fb[k]
        d_ref = np.asarray(fr[k], np.float64) - fb[k]
        diff, scale = np.linalg.norm(d_mine - d_ref), np.linalg.norm(d_ref)
        out[k] = diff / scale if scale else (0.0 if diff == 0 else np.inf)
    return out


def digests(tree, batch, noise) -> dict:
    """float64 sums of |value| of the inputs, a check that
    :func:`make_inputs` rebuilt the golden's inputs."""
    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree)

    def total(t):
        return np.float64(sum(np.abs(np.asarray(v, np.float64)).sum()
                              for v in flatten_tree(t).values()))
    return {"params": total(tree), "batch": total(batch),
            "noise": total({str(i): d for i, d in enumerate(noise)})}


def golden_arrays(tree, batch, noise, metrics, after):
    """The golden's flat arrays: config, seed, digests, metrics and each
    leaf's update in float16 (the file stays far under 1 MB)."""
    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree)

    before, after = flatten_tree(tree), flatten_tree(after)
    return flatten_tree({
        "config": np.frombuffer(json.dumps(config()).encode(), np.uint8),
        "seed": np.int64(SEED),
        "digest": digests(tree, batch, noise),
        "metrics": {str(i): {k: np.float64(v) for k, v in m.items()}
                    for i, m in enumerate(metrics)},
        "update": {k: (np.asarray(after[k], np.float64) - v).astype(
            np.float16) for k, v in before.items()},
    })


def golden_inputs(golden):
    """(tree, batch, noise) of an unflattened golden, rebuilt from its
    seed and checked against its digests."""
    tree, batch, noise = make_inputs(int(golden["seed"]))
    for k, v in digests(tree, batch, noise).items():
        assert np.isclose(v, float(golden["digest"][k]), rtol=1e-12), k
    return tree, batch, noise


def check_against_golden(metrics, tree, after, golden):
    """(worst metric error / tolerance, worst update error / UPDATE_RTOL)
    of the port's run against an unflattened golden, whose float16 update
    is the reference."""
    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree, unflatten_tree)

    worst_m = 0.0
    for i, m in enumerate(metrics):
        for k, rtol in METRIC_RTOL.items():
            ref = float(golden["metrics"][str(i)][k])
            worst_m = max(worst_m, abs(m[k] - ref) / (rtol * abs(ref)))
    before = flatten_tree(tree)
    update = flatten_tree(golden["update"])
    ref_after = unflatten_tree({
        k: v + np.asarray(update[k], np.float64) for k, v in before.items()})
    errs = update_errors(tree, after, ref_after)
    return worst_m, max(errs.values()) / UPDATE_RTOL
