"""The small cvbae training step, set up for both packages from one numpy
seed.

Shared by ``tests/test_torch_train_step.py``, the golden maker
``tests/make_torch_port_train_golden.py`` and its drift test.  Shapes:
32 px, VUNet nf 4->8, B=2, R=2 regressor images of 18 keypoints, the
Laplacian perceptual pyramid, f32, dropout 0, n_init_batches 1 (so the
second step includes the KL) and a small ``information_max`` (so gamma
leaves 0 after the first step).  The weights are drawn into the port's
modules with numpy and exported as flax trees for the JAX package; the
posterior noise is handed to both (``torch_port_slice.jax_noise``).
"""
from __future__ import annotations

import numpy as np

S, NF_START, NF_MAX, B, R, N_KPS = 32, 4, 8, 2, 2, 18
LATENT_WIDTHS = [4, 8]          # bottleneck 32 / 2**3 = 4, then 8
N_STEPS = 2


def config(grad_accum: int = 1) -> dict:
    return {
        "general": {"experiment": "cvbae", "seed": 0},
        "data": {"spatial_size": S},
        "architecture": {"nf_start": NF_START, "nf_max": NF_MAX,
                         "n_latent_scales": 2, "cvae": False},
        "training": {"lr": 5e-4, "adam_betas": [0.5, 0.9],
                     "end_iteration": 10, "ll_weight": 1.0,
                     "vgg_weights": [1.0] * 6, "weight_regressor": 4.0,
                     "train_regressor": True, "gamma_step": 1e-4,
                     "information_max": 50.0, "n_init_batches": 1,
                     "imax_scaling": "none", "dropout_prob": 0.0,
                     "perceptual": "laplacian", "bf16": False,
                     "grad_accum": grad_accum},
    }


def noise_shapes(batch: int):
    return [(batch, 4, 4, NF_MAX), (batch, 8, 8, NF_MAX)]


def port_modules(device=None):
    from behavior_driven_video_synthesis_tpu_torch.models.vunet import (
        VunetRegressor, vunet_from_config)

    vunet = vunet_from_config(config(), "alter", device=device)
    regressor = VunetRegressor(2 * N_KPS, LATENT_WIDTHS, nf_max=NF_MAX,
                               device=device)
    return vunet, regressor


def make_inputs(seed: int = 0):
    """(flax trees {"vunet", "regressor"}, batch, noise) from numpy seed
    ``seed``; noise holds the full batch's and a half batch's shapes."""
    from behavior_driven_video_synthesis_tpu_torch.models import convert
    from behavior_driven_video_synthesis_tpu_torch.models.init import (
        init_random_)

    rng = np.random.RandomState(seed)
    vunet, regressor = port_modules()
    init_random_(vunet, rng)
    init_random_(regressor, rng)
    trees = {"vunet": convert.vunet_alter_to_flax(vunet.state_dict()),
             "regressor": convert.vunet_regressor_to_flax(
                 regressor.state_dict())}
    f32 = np.float32
    batch = {
        "pose_img": (rng.rand(B, S, S, 3) * 2 - 1).astype(f32),
        "stickman": (rng.rand(B, S, S, 3) * 2 - 1).astype(f32),
        "app_img": (rng.rand(B, S, S, 3) * 2 - 1).astype(f32),
        "reg_imgs": (rng.rand(B, R, S, S, 3) * 2 - 1).astype(f32),
        "reg_targets": rng.rand(B, R, N_KPS, 2).astype(f32),
    }
    noise = {str(b): [rng.randn(*s).astype(f32) for s in noise_shapes(b)]
             for b in (B, B // 2)}
    return trees, batch, noise


def jax_steps(trees, batch, noise, grad_accum: int = 1,
              n_steps: int = N_STEPS):
    """The JAX package's cvbae step, ``n_steps`` times on ``batch``.
    Returns (per-step metrics, final flax trees)."""
    import jax
    import jax.numpy as jnp
    import optax

    from behavior_driven_video_synthesis_tpu.core import Config
    from behavior_driven_video_synthesis_tpu.models.perceptual import (
        LaplacianPyramidFeatures)
    from behavior_driven_video_synthesis_tpu.models.vunet import (
        VunetRegressor, vunet_from_config)
    from behavior_driven_video_synthesis_tpu.train.state import ModuleState
    from behavior_driven_video_synthesis_tpu.train.vunet_exp import (
        VunetTrainState, make_cvbae_train_step)
    from torch_port_slice import jax_noise

    cfg = Config(config(grad_accum))
    tr = cfg.training
    vunet = vunet_from_config(cfg, "alter")
    regressor = VunetRegressor(n_out=2 * N_KPS,
                               latent_widths=LATENT_WIDTHS, nf_max=NF_MAX)
    feat = LaplacianPyramidFeatures()
    feat_vars = feat.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    # the optimizers of experiments/shape_and_pose_net.py:_make_txs
    txs = {"vunet": optax.adam(
        optax.linear_schedule(float(tr.lr), 0.0, int(tr.end_iteration)),
        b1=float(tr.adam_betas[0]), b2=float(tr.adam_betas[1])),
        "regressor": optax.adam(1e-3)}
    state = VunetTrainState(
        step=jnp.zeros((), jnp.int32),
        vunet=ModuleState.create({"params": trees["vunet"]}, txs["vunet"]),
        regressor=ModuleState.create({"params": trees["regressor"]},
                                     txs["regressor"]),
        gamma=jnp.zeros((), jnp.float32))
    step = jax.jit(make_cvbae_train_step(vunet, regressor, feat, feat_vars,
                                         txs, cfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    with jax_noise(noise[str(B)] + noise[str(B // grad_accum)]):
        for i in range(n_steps):
            state, m = step(state, jbatch, jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
    after = jax.tree_util.tree_map(
        np.asarray, {"vunet": state.vunet.params,
                     "regressor": state.regressor.params})
    return metrics, after


def port_steps(trees, batch, noise, grad_accum: int = 1,
               n_steps: int = N_STEPS, device="cpu"):
    """The port's cvbae step, ``n_steps`` times on ``batch`` on
    ``device``.  Returns (per-step metrics, final flax trees)."""
    import torch

    from behavior_driven_video_synthesis_tpu_torch.models import convert
    from behavior_driven_video_synthesis_tpu_torch.models.perceptual import (
        LaplacianPyramidFeatures)
    from behavior_driven_video_synthesis_tpu_torch.train.state import (
        make_vunet_optimizers)
    from behavior_driven_video_synthesis_tpu_torch.train.vunet_exp import (
        VunetTrainState, make_cvbae_train_step)

    cfg = config(grad_accum)
    vunet, regressor = port_modules(device)
    vunet.load_state_dict(convert.vunet_alter_from_flax(trees["vunet"]))
    regressor.load_state_dict(
        convert.vunet_regressor_from_flax(trees["regressor"]))
    vunet.train()
    opts = make_vunet_optimizers(vunet, regressor, cfg["training"])
    step = make_cvbae_train_step(vunet, regressor,
                                 LaplacianPyramidFeatures(), opts, cfg)

    def dev(a):
        return torch.as_tensor(a, device=device)

    tbatch = {k: dev(v) for k, v in batch.items()}
    eps = [[dev(n) for n in noise[str(B // grad_accum)]]] * grad_accum
    reg_eps = [[dev(n) for n in noise[str(B)]]] * R
    state = VunetTrainState(gamma=torch.zeros((), device=device))
    metrics = []
    for _ in range(n_steps):
        m = step(state, tbatch, eps=eps, reg_eps=reg_eps)
        metrics.append({k: float(v) for k, v in m.items()})
    after = {"vunet": convert.vunet_alter_to_flax(vunet.state_dict()),
             "regressor": convert.vunet_regressor_to_flax(
                 regressor.state_dict())}
    return metrics, after


# Tolerances of the port against the JAX step (f32; on the card with TF32
# off), which differ only in summation order: each metric rtol 1e-4, with
# atol 1e-5 for the loss (a difference of terms near 4 that can land near
# 0); every parameter after the Adam updates atol 1e-4.
METRIC_RTOL = {"loss": 1e-4, "likelihood_loss": 1e-4, "kl_loss": 1e-4,
               "gamma": 1e-4, "grad_norm": 1e-4, "loss_reg": 1e-4}
LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-4


def check_metrics(mine, ref):
    assert len(mine) == len(ref)
    for m, r in zip(mine, ref):
        for k, rtol in METRIC_RTOL.items():
            atol = LOSS_ATOL if k == "loss" else 0.0
            assert np.isclose(m[k], r[k], rtol=rtol, atol=atol), (
                k, m[k], r[k])


def check_params(mine, ref):
    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree)

    fm, fr = flatten_tree(mine), flatten_tree(ref)
    assert fm.keys() == fr.keys()
    for k in fr:
        np.testing.assert_allclose(fm[k], fr[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
