"""The port's cvbae step with gradient accumulation, on the CPU.

``grad_accum=2`` against the JAX package's step with the same setting
(``torch_port_train.py``; each microbatch is handed the same half-batch
noise in both packages), and against the port's own ``grad_accum=1`` when
the two microbatches get the halves of the full batch's noise.
Tolerances: ``torch_port_train.check_metrics`` and ``check_params``.
"""
import pytest
import torch

from behavior_driven_video_synthesis_tpu_torch.models import convert
from behavior_driven_video_synthesis_tpu_torch.models.perceptual import (
    LaplacianPyramidFeatures)
from behavior_driven_video_synthesis_tpu_torch.train.state import (
    make_vunet_optimizers)
from behavior_driven_video_synthesis_tpu_torch.train.vunet_exp import (
    VunetTrainState, make_cvbae_train_step)

import torch_port_train as T


@pytest.fixture(scope="module")
def inputs():
    return T.make_inputs(0)


def test_grad_accum_2_matches_jax(inputs):
    metrics, after = T.port_steps(*inputs, grad_accum=2)
    ref_metrics, ref_after = T.jax_steps(*inputs, grad_accum=2)
    T.check_metrics(metrics, ref_metrics)
    T.check_params(after, ref_after)


def test_grad_accum_2_equals_1_on_the_same_noise(inputs):
    """Two microbatches of one sample each, fed the halves of the full
    batch's posterior noise, give the one-batch step."""
    trees, batch, noise = inputs
    one, after_one = T.port_steps(trees, batch, noise, grad_accum=1)
    vunet, regressor = T.port_modules()
    vunet.load_state_dict(convert.vunet_alter_from_flax(trees["vunet"]))
    regressor.load_state_dict(
        convert.vunet_regressor_from_flax(trees["regressor"]))
    cfg = T.config(grad_accum=2)
    step = make_cvbae_train_step(
        vunet, regressor, LaplacianPyramidFeatures(),
        make_vunet_optimizers(vunet, regressor, cfg["training"]), cfg)
    full = [torch.from_numpy(n) for n in noise[str(T.B)]]
    eps = [[n[i:i + 1] for n in full] for i in range(2)]
    state = VunetTrainState()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    two = [{k: float(v) for k, v in step(state, tb, eps=eps,
                                        reg_eps=[full] * T.R).items()}
           for _ in range(T.N_STEPS)]
    T.check_metrics(two, one)
    T.check_params({"vunet": convert.vunet_alter_to_flax(vunet.state_dict()),
                    "regressor": convert.vunet_regressor_to_flax(
                        regressor.state_dict())}, after_one)
