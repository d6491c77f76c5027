"""The port's MT-VAE training step against the JAX package's, on the CPU.

Two steps of ``make_mtvae_train_step`` in each package from the same
numpy-seeded weights, batch and draws (``tests/torch_port_mtvae.py``: 9
keypoints, dim 32, z 16, n_cond 3, T=8, B=4, f32, Adam lr 1e-3 with an L2
term of 1e-4, the KL ramp over 4 steps): every metric at rtol 1e-4
(kl_weight 1e-6), and every leaf's update (after minus before) within
1e-3 of the JAX update's norm (both f32 on the CPU; the card's golden
check allows 5 %, for its float16 updates).  Also: with the update off
the parameters and Adam's state stay bit for bit while the step count
advances; a bf16 step is finite over float32 parameters; and the golden
file ``chip_smoke.py`` reads equals a live JAX run.
"""
import copy
import json

import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
    flatten_tree, unflatten_tree)

import make_torch_port_mtvae_golden as golden_maker
import torch_port_mtvae as TM


@pytest.fixture(scope="module")
def inputs():
    return TM.make_inputs(TM.SEED)


@pytest.fixture(scope="module")
def jax_run(inputs):
    return TM.jax_steps(*inputs)


def test_steps_match_jax(inputs, jax_run):
    tree = inputs[0]
    metrics, after = TM.port_steps(*inputs)
    ref_metrics, ref_after = jax_run
    TM.check_metrics(metrics, ref_metrics)
    errs = TM.update_errors(tree, after, ref_after)
    assert max(errs.values()) <= 1e-3, max(errs.items(), key=lambda e: e[1])
    assert [m["kl_weight"] for m in metrics] == pytest.approx(
        [0.25 + 0.75e-5, 0.5 + 0.5e-5])
    m = metrics[-1]
    assert np.isclose(m["loss"], m["rec_loss"] + m["kl_weight"] * m["kl_loss"]
                      + 10.0 * (m["motion_loss"] + m["cycle_loss"]),
                      rtol=1e-6)


def test_update_off_leaves_parameters_and_adam_state(inputs):
    """One step on, then one off: the second changes neither the
    parameters nor Adam's moments and count, and the step still
    advances (the JAX ``apply_gradients(enabled=False)``)."""
    tree, batch, noise = inputs
    state = TM.port_state(tree)
    TM.port_steps(tree, batch, noise[:1], state=state)
    params = copy.deepcopy(state.model.state_dict())
    adam = copy.deepcopy(state.optimizer.state_dict())
    metrics, _ = TM.port_steps(tree, batch, noise[1:], enable=False,
                               state=state)
    assert state.step == 2 and np.isfinite(metrics[0]["grad_norm"])
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    after = state.optimizer.state_dict()
    assert after["state"].keys() == adam["state"].keys()
    for i, s in adam["state"].items():
        for k, v in s.items():
            assert torch.equal(after["state"][i][k], v), (i, k)


def test_bf16_step_is_finite_over_float32_parameters(inputs):
    tree, batch, noise = inputs
    state = TM.port_state(tree, dtype=torch.bfloat16)
    metrics, _ = TM.port_steps(tree, batch, noise, state=state)
    assert all(np.isfinite(v) for m in metrics for v in m.values())
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    out = state.model(torch.from_numpy(batch["keypoints"]),
                      torch.from_numpy(batch["paired_keypoints"]))
    assert out[0].dtype == torch.bfloat16


def test_golden_equals_a_live_jax_run(inputs, jax_run):
    """tests/golden/torch_port_mtvae_small.npz is what the maker writes
    from the JAX step now, and its seed rebuilds the inputs."""
    with np.load(golden_maker.OUT) as data:
        golden = unflatten_tree({k: data[k] for k in data.files})
    assert json.loads(bytes(golden["config"]).decode()) == TM.config()
    tree, _, _ = TM.golden_inputs(golden)
    stored = TM.golden_arrays(*inputs, *jax_run)
    live = flatten_tree(golden)
    assert set(stored) == set(live)
    for k, v in stored.items():
        np.testing.assert_allclose(
            np.asarray(live[k], np.float64), np.asarray(v, np.float64),
            rtol=2e-3 if k.startswith("update/") else 1e-6,
            atol=2e-3 * np.abs(np.asarray(v, np.float64)).max()
            if k.startswith("update/") else 1e-7, err_msg=k)
    # the port holds the golden as chip_smoke holds it on the card
    mine, mine_after = TM.port_steps(*TM.make_inputs(TM.SEED))
    worst_m, worst_u = TM.check_against_golden(mine, tree, mine_after,
                                               golden)
    assert worst_m <= 1.0 and worst_u <= 1.0, (worst_m, worst_u)
