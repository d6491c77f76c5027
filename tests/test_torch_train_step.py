"""The port's cvbae training step against the JAX package's, on the CPU.

Two steps of ``make_cvbae_train_step`` in each package from the same
numpy-seeded weights, batch and posterior noise (``torch_port_train.py``:
32 px, nf 4->8, B=2, R=2, Laplacian pyramid, f32, dropout 0,
n_init_batches 1 so the second step includes the KL, regressor on), with
the tolerances of ``torch_port_train.check_metrics`` and ``check_params``.
Also: the golden file ``chip_smoke.py`` reads equals a live JAX run.
``grad_accum`` is held in ``test_torch_train_accum.py``.
"""
import json

import numpy as np
import pytest

from behavior_driven_video_synthesis_tpu_torch.flax_npz import flatten_tree
from behavior_driven_video_synthesis_tpu_torch.models.perceptual import (
    LaplacianPyramidFeatures)
from behavior_driven_video_synthesis_tpu_torch.train.state import (
    make_vunet_optimizers)
from behavior_driven_video_synthesis_tpu_torch.train.vunet_exp import (
    make_cvbae_train_step)

import make_torch_port_train_golden as golden_maker
import torch_port_train as T


@pytest.fixture(scope="module")
def inputs():
    return T.make_inputs(0)


@pytest.fixture(scope="module")
def jax_run(inputs):
    return T.jax_steps(*inputs)


def test_cvbae_step_matches_jax(inputs, jax_run):
    metrics, after = T.port_steps(*inputs)
    ref_metrics, ref_after = jax_run
    T.check_metrics(metrics, ref_metrics)
    T.check_params(after, ref_after)
    # the KL joins at step n_init_batches = 1, weighted by the gamma of
    # the step before, which the controller moved off 0
    assert metrics[0]["gamma"] > 0 and metrics[1]["kl_loss"] > 0
    # the logged loss carries the gradient-inert regressor term
    m = metrics[0]
    assert np.isclose(m["loss"], m["likelihood_loss"]
                      - min(m["loss_reg"], 1.2) * 4.0, rtol=1e-6, atol=1e-6)


def test_golden_equals_a_live_jax_run(jax_run):
    """tests/golden/torch_port_train_small.npz is what the maker writes
    from the JAX step now: the same inputs, metrics and parameters."""
    with np.load(golden_maker.OUT) as data:
        stored = {k: data[k] for k in data.files}
    trees, batch, noise = T.make_inputs(0)
    metrics, after = jax_run
    live = flatten_tree({
        "params": trees, "batch": batch,
        "noise": {b: {str(i): n for i, n in enumerate(ns)}
                  for b, ns in noise.items()},
        "metrics": {str(i): m for i, m in enumerate(metrics)},
        "after": after})
    assert set(stored) == set(live) | {"config"}
    assert json.loads(stored["config"].tobytes()) == T.config()
    for k, v in live.items():
        np.testing.assert_allclose(stored[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_gan_branch_is_not_ported(inputs):
    """The GAN branch (A11) is ported (``test_torch_gan.py``); a config
    with ``use_gan`` and no discriminator's state is refused."""
    vunet, regressor = T.port_modules()
    cfg = T.config()
    cfg["training"]["use_gan"] = True
    with pytest.raises(ValueError, match="GANState"):
        make_cvbae_train_step(vunet, regressor, LaplacianPyramidFeatures(),
                              make_vunet_optimizers(vunet, regressor,
                                                    cfg["training"]), cfg)
