"""The port's behavior cVAE step against the JAX package's, on the CPU.

Two steps of ``make_behavior_train_step`` in each package from the same
numpy-seeded weights and batch, with the JAX step's draws handed to the
port (``torch_port_behavior.py``: 9 keypoints, ``dim_hidden_b`` 16, T=8,
B=4, 3 actions, f32, ``information_max`` 1 so that gamma leaves 0), at the
tolerances of ``torch_port_behavior.check_metrics`` and ``check_params``.
Also: the eval step matches the JAX eval step; a step with the net update
off freezes the net, its Adam moments and its learning rate; ``multistep_lr`` is optax's schedule; the golden file
``chip_smoke.py`` reads equals a live JAX run.
"""
import json

import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu.core import schedules as jax_schedules
from behavior_driven_video_synthesis_tpu_torch.core.schedules import (
    multistep_lr)
from behavior_driven_video_synthesis_tpu_torch.train.behavior import (
    StepDraws, draw_step, make_behavior_eval_step, make_behavior_train_step)

import make_torch_port_behavior_golden as golden_maker
import torch_port_behavior as TB


@pytest.fixture(scope="module")
def inputs():
    return TB.make_inputs(0)


@pytest.fixture(scope="module")
def jax_run(inputs):
    return TB.jax_steps(*inputs)


def test_cvae_steps_match_jax(inputs, jax_run):
    metrics, after = TB.port_steps(*inputs, stages=("cvae",))
    ref_metrics, ref_after = jax_run
    TB.check_metrics(metrics, {"cvae": ref_metrics["cvae"]})
    TB.check_params(after, dict(ref_after, flow=inputs[0]["flow"]))
    # gamma moved off 0 at step 0 (imax_t = 0 there) and on at step 1
    m0, m1 = metrics["cvae"]
    assert m0["gamma"] > 0 and m1["gamma"] > m0["gamma"]
    assert m0["loss_regressor"] > 0


def test_eval_step_matches_jax(inputs):
    """The per-epoch eval: reconstruction MSE and KL of one batch under
    the same posterior noise, and the rollout it scores."""
    import jax
    import jax.numpy as jnp

    from behavior_driven_video_synthesis_tpu.models import (
        ResidualBehaviorNet as JNet)
    from behavior_driven_video_synthesis_tpu.train.behavior import (
        make_behavior_eval_step as jax_eval_step)
    from torch_port_slice import jax_noise

    trees, batch, draws = inputs
    eps = draws["cvae"][0]["eps"]
    with jax_noise([eps]):
        ref, ref_xs = jax_eval_step(JNet(n_kps=TB.K, dim_hidden_b=TB.H),
                                    TB.T)(trees["net"], batch,
                                          jax.random.PRNGKey(0))
    state, _ = TB.port_state(trees)
    metrics, xs = make_behavior_eval_step(state.modules["net"], TB.T)(
        {k: torch.as_tensor(v) for k, v in batch.items()},
        eps=torch.as_tensor(eps))
    assert metrics.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(ref[k]),
                                   rtol=TB.METRIC_RTOL, err_msg=k)
    np.testing.assert_allclose(xs.numpy(), np.asarray(ref_xs), rtol=0,
                               atol=1e-5)
    assert jnp.shape(ref_xs) == (TB.B, TB.T, TB.K)


def test_net_update_off_freezes_the_net(inputs):
    """enable_net_update=False: the net's parameters, its Adam moments,
    its learning rate and gamma stay; the regressor and probes train."""
    trees, batch, draws = inputs
    state, _ = TB.port_state(trees)
    net_opt, net_lr = state.optimizers["net"], state.optimizers["net_lr"]
    before = {n: {k: v.clone() for k, v in m.state_dict().items()}
              for n, m in state.modules.items()}
    step = make_behavior_train_step(TB.config(), TB.T)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    d = draws["cvae"][0]
    for _ in range(2):
        m = step(state, tbatch, False, draws=StepDraws(
            torch.as_tensor(d["t_adv"]),
            [torch.as_tensor(t) for t in d["t_reg"]],
            torch.as_tensor(d["eps"])))
        assert np.isfinite(float(m["loss"]))
    assert state.step == 2 and float(state.gamma) == 0.0
    assert not net_opt.state            # no moments were made
    assert net_lr.last_epoch == 0
    assert net_opt.param_groups[0]["lr"] == pytest.approx(
        TB.config()["training"]["lr_init"] * 0.3)   # boundary 0 collapsed
    for k, v in state.modules["net"].state_dict().items():
        assert torch.equal(v, before["net"][k]), k
    for n in ("regressor", "cls_action", "cls_action2", "cls_beta"):
        assert any(not torch.equal(v, before[n][k])
                   for k, v in state.modules[n].state_dict().items()), n


@pytest.mark.parametrize("n_steps", [2, 3, 10, 1000])
def test_multistep_lr_is_optax(n_steps):
    """Rate after ``count`` updates, as optax's piecewise-constant
    schedule: boundaries int(tau * n) collapse when equal (two decays at
    n=2) and apply once count >= boundary; the net's LambdaLR follows."""
    tau, gamma, lr = [0.2, 0.45, 0.7], 0.3, 1e-4
    ref = jax_schedules.multistep_lr(lr, n_steps, tau, gamma)
    mine = multistep_lr(lr, n_steps, tau, gamma)
    counts = range(n_steps + 2)
    want = [float(ref(c)) for c in counts]
    np.testing.assert_allclose([mine(c) for c in counts], want, rtol=1e-6)
    if n_steps == 2:
        assert want[-1] == pytest.approx(lr * gamma ** 2)
    p = torch.nn.Parameter(torch.zeros(()))
    opt = torch.optim.Adam([p], lr=lr)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, multistep_lr(1.0, n_steps, tau, gamma))
    for c in counts:
        assert opt.param_groups[0]["lr"] == pytest.approx(want[c],
                                                          rel=1e-6), c
        opt.step()
        sched.step()


def test_draws_come_from_the_generator():
    """A step's draws: frames in [0, T) and noise (B, H), the same for the
    same generator seed."""
    def draws(seed):
        return draw_step(torch.Generator().manual_seed(seed), 4, 16, 8,
                         "cpu")
    a, b = draws(3), draws(3)
    assert torch.equal(a.eps, b.eps) and a.eps.shape == (4, 16)
    ts = torch.stack([a.t_adv, *a.t_reg])
    assert torch.equal(ts, torch.stack([b.t_adv, *b.t_reg]))
    assert ts.shape == (6,) and int(ts.min()) >= 0 and int(ts.max()) < 8


def test_golden_equals_a_live_jax_run(inputs, jax_run):
    """tests/golden/torch_port_behavior_small.npz is what the maker writes
    from the JAX steps now: the same inputs, draws, metrics and
    parameters."""
    with np.load(golden_maker.OUT) as data:
        stored = {k: data[k] for k in data.files}
    live = golden_maker.live_arrays(inputs, jax_run)
    assert set(stored) == set(live) | {"config"}
    assert json.loads(stored["config"].tobytes()) == TB.config()
    for k, v in live.items():
        np.testing.assert_allclose(stored[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
