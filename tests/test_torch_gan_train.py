"""The port's cvbae step with the GAN branch against the JAX package's,
on the CPU.

Two steps of ``make_cvbae_train_step`` in each package from the same
numpy-seeded weights, batch and posterior noise (``torch_port_train.py``
with ``gan=True``: 32 px, nf 4->8, B=2, R=2, the regressor on, a PatchGAN
of ndf 8 and 2 layers in f32, ``gan_weight`` 0.1 and ``grad_pen`` with
``lambda_gp`` 1, as ``tests/test_vunet_training.py``'s GAN test configures
them), under ``grad_accum`` 1 and 2, within
``torch_port_train.check_metrics`` / ``check_params``.  Also:
``tests/golden/torch_port_gan_small.npz``, which ``chip_smoke.py`` reads,
equals a live JAX run.
"""
import json

import numpy as np
import pytest

from behavior_driven_video_synthesis_tpu_torch.flax_npz import flatten_tree

import make_torch_port_gan_golden as golden_maker
import torch_port_train as T
from torch_port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def inputs():
    return T.make_inputs(0, gan=True)


@pytest.fixture(scope="module")
def jax_runs(inputs):
    runs = {}

    def get(grad_accum):
        if grad_accum not in runs:
            runs[grad_accum] = T.jax_steps(*inputs, grad_accum=grad_accum)
        return runs[grad_accum]
    return get


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_gan_step_matches_jax(inputs, jax_runs, grad_accum):
    metrics, after = T.port_steps(*inputs, grad_accum=grad_accum)
    ref_metrics, ref_after = jax_runs(grad_accum)
    assert {"dloss", "dloss_r", "dloss_f", "gp", "gen_gan_loss"} <= set(
        ref_metrics[0])
    T.check_metrics(metrics, ref_metrics)
    T.check_params(after, ref_after)
    # the discriminator moved, and its loss is its terms
    flat, before = flatten_tree(after["disc"]), flatten_tree(
        inputs[0]["disc"])
    assert all(np.abs(flat[k] - before[k]).max() > 0 for k in flat)
    for m in metrics:
        assert np.isclose(m["dloss"], m["dloss_r"] + m["dloss_f"] + m["gp"],
                          rtol=1e-6)


def test_golden_equals_a_live_jax_run(jax_runs):
    """tests/golden/torch_port_gan_small.npz is what the maker writes from
    the JAX step now: the same inputs, metrics and parameters."""
    with np.load(golden_maker.OUT) as data:
        stored = {k: data[k] for k in data.files}
    live = golden_maker.golden_arrays(jax_runs(1))
    assert set(stored) == set(live)
    assert json.loads(stored["config"].tobytes()) == T.config(gan=True)
    for k, v in live.items():
        if k != "config":
            np.testing.assert_allclose(stored[k], v, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
