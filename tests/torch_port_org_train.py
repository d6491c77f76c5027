"""The small original-VUNet (org) training step, set up for both packages
from one numpy seed.

Shared by ``tests/test_torch_org_train.py``, the golden maker
``tests/make_torch_port_org_train_golden.py`` and its drift test.  Shapes:
32 px, VUNet-org nf 4->8, B=2, a 30-channel 16x16 part-stack appearance
(box_factor 1), the Laplacian pyramid, f32, dropout 0, and
``end_iteration`` 3, so that the KL ramp runs from int(1.5) = 1 to
int(2.25) = 2: the third step weighs the KL by ``kl_max`` and the first
two by ``kl_init``.  The weights are drawn into the port's VUNet with
numpy and exported as a flax tree for the JAX package; the posterior
noise is handed to both (``torch_port_slice.jax_noise``).
"""
from __future__ import annotations

import numpy as np

S, NF_START, NF_MAX, B, CX, BOX = 32, 4, 8, 2, 30, 1
N_STEPS = 3


def config(grad_accum: int = 1, **training) -> dict:
    tr = {"lr": 8e-4, "adam_betas": [0.5, 0.9], "end_iteration": N_STEPS,
          "ll_weight": 1.0, "vgg_weights": [1.0] * 6, "kl_init": 0.01,
          "kl_max": 1.0, "dropout_prob": 0.0, "perceptual": "laplacian",
          "bf16": False, "grad_accum": grad_accum}
    tr.update(training)
    return {
        "general": {"experiment": "vunet", "seed": 0},
        "data": {"spatial_size": S, "inplane_normalize": True,
                 "box_factor": BOX},
        "architecture": {"nf_start": NF_START, "nf_max": NF_MAX,
                         "n_latent_scales": 2},
        "training": tr,
    }


def noise_shapes(batch: int):
    return [(batch, 4, 4, NF_MAX), (batch, 8, 8, NF_MAX)]


def port_vunet(cfg=None, device=None):
    from behavior_driven_video_synthesis_tpu_torch.models.vunet import (
        vunet_from_config)

    return vunet_from_config(cfg or config(), "org", device=device)


def make_inputs(seed: int = 0):
    """(flax tree of the VUNet, batch, noise) from numpy seed ``seed``;
    noise holds the full batch's and a half batch's shapes."""
    from behavior_driven_video_synthesis_tpu_torch.models import convert
    from behavior_driven_video_synthesis_tpu_torch.models.init import (
        init_random_)

    rng = np.random.RandomState(seed)
    vunet = init_random_(port_vunet(), rng)
    tree = convert.vunet_org_to_flax(vunet.state_dict())
    f32 = np.float32
    P = S // 2 ** BOX
    batch = {
        "pose_img": (rng.rand(B, S, S, 3) * 2 - 1).astype(f32),
        "stickman": (rng.rand(B, S, S, 3) * 2 - 1).astype(f32),
        "app_img": (rng.rand(B, P, P, CX) * 2 - 1).astype(f32),
    }
    noise = {str(b): [rng.randn(*s).astype(f32) for s in noise_shapes(b)]
             for b in (B, B // 2)}
    return tree, batch, noise


def jax_steps(tree, batch, noise, n_steps: int = N_STEPS):
    """The JAX package's org step, ``n_steps`` times on ``batch``.
    Returns (per-step metrics, the final flax tree)."""
    import jax
    import jax.numpy as jnp
    import optax

    from behavior_driven_video_synthesis_tpu.core import Config
    from behavior_driven_video_synthesis_tpu.models.perceptual import (
        LaplacianPyramidFeatures)
    from behavior_driven_video_synthesis_tpu.models.vunet import (
        vunet_from_config)
    from behavior_driven_video_synthesis_tpu.train.state import ModuleState
    from behavior_driven_video_synthesis_tpu.train.vunet_exp import (
        VunetTrainState, make_org_vunet_train_step)
    from torch_port_slice import jax_noise

    cfg = Config(config())
    tr = cfg.training
    vunet = vunet_from_config(cfg, "org", n_channels_x=CX)
    feat = LaplacianPyramidFeatures()
    feat_vars = feat.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    # the optimizers of experiments/shape_and_pose_net.py:_make_txs
    txs = {"vunet": optax.adam(
        optax.linear_schedule(float(tr.lr), 0.0, int(tr.end_iteration)),
        b1=float(tr.adam_betas[0]), b2=float(tr.adam_betas[1]))}
    state = VunetTrainState(
        step=jnp.zeros((), jnp.int32),
        vunet=ModuleState.create({"params": tree}, txs["vunet"]),
        regressor=None, gamma=jnp.zeros((), jnp.float32))
    step = jax.jit(make_org_vunet_train_step(
        vunet, feat, feat_vars, txs, cfg, int(tr.end_iteration)))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    with jax_noise(noise[str(B)]):
        for i in range(n_steps):
            state, m = step(state, jbatch, jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree_util.tree_map(np.asarray, state.vunet.params)


def port_steps(tree, batch, noise, grad_accum: int = 1,
               n_steps: int = N_STEPS, device="cpu", cfg=None,
               generators=(None, None)):
    """The port's org step, ``n_steps`` times on ``batch`` on ``device``
    (config ``cfg``, else :func:`config`).  Returns (per-step metrics,
    the final flax tree)."""
    import torch

    from behavior_driven_video_synthesis_tpu_torch.models import convert
    from behavior_driven_video_synthesis_tpu_torch.models.perceptual import (
        LaplacianPyramidFeatures)
    from behavior_driven_video_synthesis_tpu_torch.train.state import (
        make_vunet_optimizers)
    from behavior_driven_video_synthesis_tpu_torch.train.vunet_exp import (
        VunetTrainState, make_org_vunet_train_step)

    cfg = cfg or config(grad_accum)
    vunet = port_vunet(cfg, device)
    vunet.load_state_dict(convert.vunet_org_from_flax(tree))
    vunet.train()
    tr = cfg["training"]
    step = make_org_vunet_train_step(
        vunet, LaplacianPyramidFeatures(),
        make_vunet_optimizers(vunet, None, tr), cfg,
        int(tr["end_iteration"]))

    def dev(a):
        return torch.as_tensor(a, device=device)

    tbatch = {k: dev(v) for k, v in batch.items()}
    if grad_accum == 1:
        eps = [[dev(n) for n in noise[str(B)]]]
    else:   # the full batch's noise, split as the batch is
        eps = [[dev(n).split(B // grad_accum)[i] for n in noise[str(B)]]
               for i in range(grad_accum)]
    state = VunetTrainState(gamma=torch.zeros((), device=device))
    metrics = []
    for _ in range(n_steps):
        m = step(state, tbatch, generator=generators[0],
                 dropout_generator=generators[1], eps=eps)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, convert.vunet_org_to_flax(vunet.state_dict())


# Tolerances of the port against the JAX step (f32; on the card with TF32
# off), as tests/torch_port_train.py's for cvbae: each metric rtol 1e-4;
# and every leaf's update (after minus before) within 5 % of the JAX
# update's norm.
METRIC_RTOL = {"loss": 1e-4, "likelihood_loss": 1e-4, "kl_loss": 1e-4,
               "kl_weight": 1e-6, "grad_norm": 1e-4}
UPDATE_RTOL = 0.05


def check_metrics(mine, ref):
    assert len(mine) == len(ref)
    for m, r in zip(mine, ref):
        assert set(m) == set(r), (sorted(m), sorted(r))
        for k, rtol in METRIC_RTOL.items():
            assert np.isclose(m[k], r[k], rtol=rtol, atol=0.0), (k, m[k],
                                                                 r[k])


def update_errors(before, mine, ref):
    """{leaf: ||Δport - Δjax|| / ||Δjax||} of the updates; inf where JAX
    left a leaf alone and the port did not."""
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


def check_updates(before, mine, ref):
    """Every leaf's update within UPDATE_RTOL of the JAX update (a frozen
    leaf fails at 1.0), and the JAX steps moved most leaves."""
    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree)

    errs = update_errors(before, mine, ref)
    bad = {k: v for k, v in errs.items() if not v <= UPDATE_RTOL}
    assert not bad, bad
    fb, fr = flatten_tree(before), flatten_tree(ref)
    assert sum(not np.array_equal(fb[k], fr[k]) for k in fb) > 0.9 * len(fb)


def digests(tree, batch, noise) -> dict:
    """float64 sums of |value| of the inputs, a check that
    :func:`make_inputs` rebuilt the golden's inputs."""
    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree)

    def total(t):
        return np.float64(sum(np.abs(np.asarray(v, np.float64)).sum()
                              for v in flatten_tree(t).values()))
    return {"params": total(tree), "batch": total(batch),
            "noise": total({b: {str(i): n for i, n in enumerate(ns)}
                            for b, ns in noise.items()})}


def golden_inputs(golden):
    """(tree, batch, noise) of an unflattened golden, rebuilt from its
    seed and checked against its digests."""
    tree, batch, noise = make_inputs(int(golden["seed"]))
    for k, v in digests(tree, batch, noise).items():
        assert np.isclose(v, float(golden["digest"][k]), rtol=1e-12), k
    return tree, batch, noise


def check_against_golden(metrics, tree, after, golden):
    """(worst metric error / tolerance, worst update error / UPDATE_RTOL)
    of the port's run against an unflattened golden; the update's
    reference is the golden's float16 update."""
    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree, unflatten_tree)

    worst_m = 0.0
    for i, m in enumerate(metrics):
        for k, rtol in METRIC_RTOL.items():
            ref = float(golden["metrics"][str(i)][k])
            worst_m = max(worst_m, abs(m[k] - ref) / (rtol * abs(ref)))
    before = flatten_tree(tree)
    ref_after = unflatten_tree({
        k: v + np.asarray(flatten_tree(golden["update"])[k], np.float64)
        for k, v in before.items()})
    errs = update_errors(tree, after, ref_after)
    return worst_m, max(errs.values()) / UPDATE_RTOL
