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

With ``gan=True`` the step also trains a PatchGAN (ndf 8, 2 layers, f32,
Adam 2e-3) with ``gan_weight`` 0.1 and the R1 penalty (``lambda_gp`` 1),
as ``tests/test_vunet_training.py:TestGanBranch`` configures it; its
weights are drawn after the others, so the rest of the inputs are those
of ``gan=False``.
"""
from __future__ import annotations

import numpy as np

S, NF_START, NF_MAX, B, R, N_KPS = 32, 4, 8, 2, 2, 18
LATENT_WIDTHS = [4, 8]          # bottleneck 32 / 2**3 = 4, then 8
N_STEPS = 2


GAN_TRAINING = {"use_gan": True, "grad_pen": True, "gan_weight": 0.1,
                "lambda_gp": 1.0, "disc_ndf": 8, "disc_layers": 2,
                "disc_lr": 2e-3}


def config(grad_accum: int = 1, gan: bool = False,
           conv_layer_type: str = "l1") -> dict:
    cfg = {
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
    if gan:
        cfg["training"].update(GAN_TRAINING)
    if conv_layer_type != "l1":
        cfg["architecture"]["conv_layer_type"] = conv_layer_type
    return cfg


def noise_shapes(batch: int):
    return [(batch, 4, 4, NF_MAX), (batch, 8, 8, NF_MAX)]


def port_modules(device=None, conv_layer_type: str = "l1"):
    from behavior_driven_video_synthesis_tpu_torch.models.vunet import (
        VunetRegressor, vunet_from_config)

    vunet = vunet_from_config(config(conv_layer_type=conv_layer_type),
                              "alter", device=device)
    regressor = VunetRegressor(2 * N_KPS, LATENT_WIDTHS, nf_max=NF_MAX,
                               device=device)
    return vunet, regressor


def port_disc(device=None):
    from behavior_driven_video_synthesis_tpu_torch.train.gan import (
        build_discriminator)

    return build_discriminator(config(gan=True), device)


def make_inputs(seed: int = 0, gan: bool = False,
                conv_layer_type: str = "l1"):
    """(flax trees {"vunet", "regressor"[, "disc"]}, batch, noise) from
    numpy seed ``seed``; noise holds the full batch's and a half batch's
    shapes.  The VUNet's conv layers are ``conv_layer_type``'s."""
    from behavior_driven_video_synthesis_tpu_torch.models import convert
    from behavior_driven_video_synthesis_tpu_torch.models.init import (
        init_random_)

    rng = np.random.RandomState(seed)
    vunet, regressor = port_modules(conv_layer_type=conv_layer_type)
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
    if gan:
        trees["disc"] = convert.patchgan_to_flax(
            init_random_(port_disc(), rng).state_dict())
    return trees, batch, noise


def jax_steps(trees, batch, noise, grad_accum: int = 1,
              n_steps: int = N_STEPS, conv_layer_type: str = "l1"):
    """The JAX package's cvbae step, ``n_steps`` times on ``batch`` (with
    the GAN branch where ``trees`` holds "disc").  Returns (per-step
    metrics, final flax trees)."""
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

    gan = "disc" in trees
    cfg = Config(config(grad_accum, gan, conv_layer_type))
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
    disc = None
    if gan:
        from behavior_driven_video_synthesis_tpu.train.gan import (
            GANState, build_discriminator)

        disc = build_discriminator(cfg)
        # experiments/shape_and_pose_net.py:175's optimizer
        txs["disc"] = optax.adam(float(tr.disc_lr), b1=0.5, b2=0.9)
        state = state.replace(gan=GANState(disc=ModuleState.create(
            {"params": trees["disc"]}, txs["disc"])))
    step = jax.jit(make_cvbae_train_step(vunet, regressor, feat, feat_vars,
                                         txs, cfg, disc_model=disc))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    with jax_noise(noise[str(B)] + noise[str(B // grad_accum)]):
        for i in range(n_steps):
            state, m = step(state, jbatch, jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
    after = {"vunet": state.vunet.params,
             "regressor": state.regressor.params}
    if gan:
        after["disc"] = state.gan.disc.params
    return metrics, jax.tree_util.tree_map(np.asarray, after)


def port_steps(trees, batch, noise, grad_accum: int = 1,
               n_steps: int = N_STEPS, device="cpu",
               conv_layer_type: str = "l1"):
    """The port's cvbae step, ``n_steps`` times on ``batch`` on
    ``device`` (with the GAN branch where ``trees`` holds "disc").
    Returns (per-step metrics, final flax trees)."""
    import torch

    from behavior_driven_video_synthesis_tpu_torch.models import convert
    from behavior_driven_video_synthesis_tpu_torch.models.perceptual import (
        LaplacianPyramidFeatures)
    from behavior_driven_video_synthesis_tpu_torch.train.gan import GANState
    from behavior_driven_video_synthesis_tpu_torch.train.state import (
        make_disc_optimizer, make_vunet_optimizers)
    from behavior_driven_video_synthesis_tpu_torch.train.vunet_exp import (
        VunetTrainState, make_cvbae_train_step)

    cfg = config(grad_accum, "disc" in trees, conv_layer_type)
    vunet, regressor = port_modules(device, conv_layer_type)
    vunet.load_state_dict(convert.vunet_alter_from_flax(trees["vunet"]))
    regressor.load_state_dict(
        convert.vunet_regressor_from_flax(trees["regressor"]))
    vunet.train()
    opts = make_vunet_optimizers(vunet, regressor, cfg["training"])
    gan = None
    if "disc" in trees:
        disc = port_disc(device)
        disc.load_state_dict(convert.patchgan_from_flax(trees["disc"]))
        gan = GANState(disc, make_disc_optimizer(disc, cfg["training"]))
    step = make_cvbae_train_step(vunet, regressor,
                                 LaplacianPyramidFeatures(), opts, cfg,
                                 gan=gan)

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
    if gan is not None:
        after["disc"] = convert.patchgan_to_flax(gan.disc.state_dict())
    return metrics, after


# Tolerances of the port against the JAX step (f32; on the card with TF32
# off), which differ only in summation order: each metric rtol 1e-4, with
# atol 1e-5 for the loss (a difference of terms near 4 that can land near
# 0); every parameter after the Adam updates atol 1e-4.
METRIC_RTOL = {"loss": 1e-4, "likelihood_loss": 1e-4, "kl_loss": 1e-4,
               "gamma": 1e-4, "grad_norm": 1e-4, "loss_reg": 1e-4}
# the GAN branch's metrics, where the reference step has them: rtol 1e-4
GAN_METRIC_RTOL = {"dloss": 1e-4, "dloss_r": 1e-4, "dloss_f": 1e-4,
                   "gp": 1e-4, "gen_gan_loss": 1e-4}
LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-4


def check_metrics(mine, ref):
    assert len(mine) == len(ref)
    for m, r in zip(mine, ref):
        rtols = {**METRIC_RTOL, **{k: v for k, v in GAN_METRIC_RTOL.items()
                                   if k in r}}
        for k, rtol in rtols.items():
            atol = LOSS_ATOL if k == "loss" else 0.0
            assert np.isclose(m[k], r[k], rtol=rtol, atol=atol), (
                k, m[k], r[k])


# The discriminator's biases ahead of an instance norm (Conv_1 to
# Conv_{disc_layers}) have a zero gradient in exact arithmetic: the norm
# takes a per-channel constant away.  Adam then steps each package's copy
# on the sign of its own rounding noise, by at most disc_lr a step at the
# first step and 1.04 disc_lr at the second (Cauchy-Schwarz on the moments,
# betas (0.5, 0.9)).  So these biases are held to twice that sum, and the
# discriminator's logits, which they cannot move, to DISC_LOGIT_ATOL on a
# seeded probe batch.
NORMED_BIAS_STEP_BOUND = (1.0, 1.04)
DISC_LOGIT_ATOL = 1e-4


def normed_bias_atol(n_steps: int = N_STEPS) -> float:
    assert n_steps <= len(NORMED_BIAS_STEP_BOUND)
    return 2 * sum(NORMED_BIAS_STEP_BOUND[:n_steps]) * GAN_TRAINING["disc_lr"]


def normed_bias_keys(n_layers: int = GAN_TRAINING["disc_layers"]):
    return {f"disc/Conv_{i}/bias" for i in range(1, n_layers + 1)}


def disc_logits(tree, device="cpu"):
    """The small PatchGAN's logits with flax tree ``tree`` on a probe
    batch from numpy seed 0."""
    import torch

    from behavior_driven_video_synthesis_tpu_torch.models import convert

    disc = port_disc(device)
    disc.load_state_dict(convert.patchgan_from_flax(tree))
    x = np.random.RandomState(0).uniform(-1, 1, (B, S, S, 3))
    with torch.no_grad():
        return disc(torch.as_tensor(x, dtype=torch.float32,
                                    device=device)).cpu().numpy()


def check_params(mine, ref):
    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree)

    fm, fr = flatten_tree(mine), flatten_tree(ref)
    assert fm.keys() == fr.keys()
    normed = normed_bias_keys() if "disc" in ref else set()
    for k in fr:
        atol = normed_bias_atol() if k in normed else PARAM_ATOL
        np.testing.assert_allclose(fm[k], fr[k], rtol=0, atol=atol,
                                   err_msg=k)
    if "disc" in ref:
        np.testing.assert_allclose(disc_logits(mine["disc"]),
                                   disc_logits(ref["disc"]), rtol=0,
                                   atol=DISC_LOGIT_ATOL)
