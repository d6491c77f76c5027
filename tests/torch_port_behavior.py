"""The small behavior_net training steps, set up for both packages from one
numpy seed.

Shared by ``tests/test_torch_behavior_train.py``,
``tests/test_torch_flow_train.py`` and the golden maker
``tests/make_torch_port_behavior_golden.py``.  Shapes: 9 keypoints,
``dim_hidden_b`` 16, T=8 (9 frames), B=4, 3 actions, the action LSTM at
width 16, 3 flows of mid width 32, f32.  The weights are drawn into the
port's modules with numpy and exported as flax trees for the JAX package.
Each step's draws are handed to both: the frames t come from the JAX
step's key, and the posterior noise eps is given to the port and patched
into ``jax.random.normal`` (``torch_port_slice.jax_noise``).
"""
from __future__ import annotations

import numpy as np

K, H, T, B, N_ACTIONS = 9, 16, 8, 4, 3
CLS_DIM, FLOW_MID, N_FLOWS = 16, 32, 3
N_STEPS = 2
N_REG_STEPS = 5
MODULES = ("net", "regressor", "cls_action", "cls_action2", "cls_beta")


def config() -> dict:
    return {
        "general": {"experiment": "behavior_net", "seed": 0},
        "data": {"dataset": "synthetic", "n_kps": K,
                 "n_actions": N_ACTIONS, "seq_length": [T, T + 1]},
        "architecture": {"decoder_arch": "lstm", "dim_hidden_b": H,
                         "n_flows": N_FLOWS, "flow_hidden_depth": 2,
                         "cvae": False},
        # n_steps 2: the lr boundaries of tau collapse to {0, 1}
        "training": {"batch_size": B, "n_epochs": 1, "lr_init": 1e-3,
                     "tau": [0.2, 0.45, 0.7], "gamma": 0.3,
                     "weight_decay": 1e-4, "recon_loss_weight": 2.5,
                     "information_max": 1.0, "gamma_init": 0.0,
                     "gamma_step": 1e-2, "flow_lr": 2.5e-4,
                     "use_regressor": True, "weight_regressor": 0.01,
                     "imax_scaling": "none"},
    }


def port_modules():
    from behavior_driven_video_synthesis_tpu_torch.models.behavior import (
        ResidualBehaviorNet)
    from behavior_driven_video_synthesis_tpu_torch.models.discriminators \
        import SequenceDiscMichael
    from behavior_driven_video_synthesis_tpu_torch.models.probes import (
        ClassifierAction, ClassifierActionBeta, RegressorFly)

    modules = {
        "net": ResidualBehaviorNet(K, H),
        "regressor": RegressorFly(H, K, T),
        "cls_action": ClassifierAction(K, N_ACTIONS, dim=CLS_DIM),
        "cls_action2": SequenceDiscMichael(K, T - 1, out_dim=N_ACTIONS),
        "cls_beta": ClassifierActionBeta(H, N_ACTIONS),
    }
    return modules


def port_flow():
    from behavior_driven_video_synthesis_tpu_torch.models.flows import (
        LatentFlow)

    return LatentFlow(H, FLOW_MID, 2, N_FLOWS)


TO_FLAX = {"net": "behavior_net", "regressor": "regressor_fly",
           "cls_action": "classifier_action",
           "cls_action2": "sequence_disc_michael",
           "cls_beta": "classifier_action_beta"}


def to_flax(name, state_dict):
    from behavior_driven_video_synthesis_tpu_torch.models import convert

    if name == "flow":
        return convert.latent_flow_to_flax(state_dict)
    return getattr(convert, f"{TO_FLAX[name]}_to_flax")(state_dict)


def from_flax(name, tree):
    from behavior_driven_video_synthesis_tpu_torch.models import convert

    if name == "flow":
        return convert.latent_flow_from_flax(tree)
    return getattr(convert, f"{TO_FLAX[name]}_from_flax")(tree)


def make_inputs(seed: int = 0):
    """(flax trees of the five modules and the flow, batch, draws) from
    numpy seed ``seed``.  draws holds, per cVAE step, t_adv, t_reg (5) and
    eps (B, H); per flow step, eps."""
    import torch

    from behavior_driven_video_synthesis_tpu_torch.data.synthetic import (
        SyntheticSequenceDataset)
    from behavior_driven_video_synthesis_tpu_torch.models.init import (
        init_random_)

    rng = np.random.RandomState(seed)
    modules = dict(port_modules(), flow=port_flow())
    trees = {}
    for name, m in modules.items():
        init_random_(m, rng)
        with torch.no_grad():
            for g in (x for x in m.modules()
                      if isinstance(x, torch.nn.GroupNorm)):
                g.weight.copy_(torch.from_numpy(
                    1.0 + 0.1 * rng.randn(*g.weight.shape)))
        trees[name] = to_flax(name, m.state_dict())
    ds = SyntheticSequenceDataset(n_samples=B, seq_length=T + 1, n_kps=K,
                                  n_actions=N_ACTIONS, seed=seed)
    batch = {"keypoints": ds.keypoints.astype(np.float32),
             "action": ds.actions.astype(np.int64)}
    draws = {"cvae": [dict(frames(i), eps=rng.randn(B, H).astype(
        np.float32)) for i in range(N_STEPS)],
        "flow": [dict(eps=rng.randn(B, H).astype(np.float32))
                 for _ in range(N_STEPS)]}
    return trees, batch, draws


def frames(i: int) -> dict:
    """t_adv and t_reg of the JAX step with key PRNGKey(i)."""
    import jax

    _, k_t = jax.random.split(jax.random.PRNGKey(i))
    return {"t_adv": np.int64(jax.random.randint(k_t, (), 0, T)),
            "t_reg": np.asarray([jax.random.randint(
                jax.random.fold_in(k_t, j + 1), (), 0, T)
                for j in range(N_REG_STEPS)], np.int64)}


def _jax_setup():
    from behavior_driven_video_synthesis_tpu.core import Config
    from behavior_driven_video_synthesis_tpu.models import (
        ClassifierAction, ClassifierActionBeta, RegressorFly,
        ResidualBehaviorNet)
    from behavior_driven_video_synthesis_tpu.models.discriminators import (
        SequenceDiscMichael)

    cfg = Config(config())
    models = {
        "net": ResidualBehaviorNet(n_kps=K, dim_hidden_b=H),
        "regressor": RegressorFly(n_out=K, seq_length=T),
        "cls_action": ClassifierAction(n_classes=N_ACTIONS, dim=CLS_DIM),
        "cls_action2": SequenceDiscMichael(layers=(2, 1, 1, 1),
                                           out_dim=N_ACTIONS),
        "cls_beta": ClassifierActionBeta(n_classes=N_ACTIONS),
    }
    return cfg, models


def _with_noise(fn):
    """fn jitted with the posterior noise as its last argument: inside the
    trace ``jax.random.normal`` returns it (one trace for every step)."""
    import jax

    from torch_port_slice import jax_noise

    def traced(*args):
        with jax_noise([args[-1]]):
            return fn(*args[:-1])
    return jax.jit(traced)


def jax_cvae_steps(trees, batch, draws, enable=True):
    """N_STEPS of the JAX package's behavior step.  Returns ([metrics],
    flax trees of the five modules after the steps)."""
    import jax
    import jax.numpy as jnp

    from behavior_driven_video_synthesis_tpu.core import schedules
    from behavior_driven_video_synthesis_tpu.train.behavior import (
        BehaviorTrainState, make_behavior_train_step)
    from behavior_driven_video_synthesis_tpu.train.state import (
        ModuleState, torch_adam)

    cfg, models = _jax_setup()
    tr = cfg.training
    # the optimizers of experiments/behavior_net.py:_make_txs
    txs = {"net": torch_adam(schedules.multistep_lr(
        float(tr.lr_init), N_STEPS, list(tr.tau), float(tr.gamma)),
        weight_decay=float(tr.weight_decay)),
        "regressor": torch_adam(1e-4),
        "cls_action": torch_adam(1e-4, weight_decay=1e-4),
        "cls_action2": torch_adam(1e-4, weight_decay=1e-5),
        "cls_beta": torch_adam(1e-3)}
    state = BehaviorTrainState(
        step=jnp.zeros((), jnp.int32), gamma=jnp.zeros((), jnp.float32),
        **{n: ModuleState.create({"params": trees[n]}, txs[n])
           for n in MODULES})
    step = _with_noise(make_behavior_train_step(
        *(models[n] for n in MODULES), txs, cfg, T, total_steps=N_STEPS))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for i, d in enumerate(draws["cvae"]):
        state, m = step(state, jbatch, jax.random.PRNGKey(i), enable,
                        jnp.asarray(d["eps"]))
        metrics.append(jax.tree_util.tree_map(np.asarray, m))
    after = {n: getattr(state, n).params for n in MODULES}
    return metrics, jax.tree_util.tree_map(np.asarray, after)


def jax_flow_steps(net_tree, flow_tree, batch, draws):
    """N_STEPS of the JAX package's flow step over the net ``net_tree``.
    Returns ([metrics], the flow's variables after the steps)."""
    import jax
    import jax.numpy as jnp

    from behavior_driven_video_synthesis_tpu.models.flows import LatentFlow
    from behavior_driven_video_synthesis_tpu.train.flow import (
        FlowTrainState, make_flow_train_step)
    from behavior_driven_video_synthesis_tpu.train.state import (
        ModuleState, torch_adam)

    cfg, models = _jax_setup()
    tr = cfg.training
    flow_model = LatentFlow(flow_in_channels=H, flow_mid_channels=FLOW_MID,
                            flow_hidden_depth=2, n_flows=N_FLOWS)
    # the flow optimizer of experiments/behavior_net.py:205-213
    tx = torch_adam(float(tr.flow_lr) * B, b1=0.5, b2=0.9,
                    weight_decay=float(tr.weight_decay))
    state = FlowTrainState(step=jnp.zeros((), jnp.int32),
                           flow=ModuleState.create(flow_tree, tx))
    step = _with_noise(make_flow_train_step(models["net"], flow_model, tx,
                                            T))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for i, d in enumerate(draws["flow"]):
        state, m = step(state, net_tree, jbatch, jax.random.PRNGKey(i),
                        jnp.asarray(d["eps"]))
        metrics.append(jax.tree_util.tree_map(np.asarray, m))
    after = {"params": state.flow.params, "buffers": state.flow.buffers}
    return metrics, jax.tree_util.tree_map(np.asarray, after)


def jax_steps(trees, batch, draws):
    """N_STEPS of the JAX package's behavior step, then N_STEPS of its
    flow step over the updated net: ({"cvae": [metrics], "flow":
    [metrics]}, flax trees of the six modules after the steps)."""
    cvae, after = jax_cvae_steps(trees, batch, draws)
    flow, after["flow"] = jax_flow_steps(after["net"], trees["flow"], batch,
                                         draws)
    return {"cvae": cvae, "flow": flow}, after


def port_state(trees, device="cpu"):
    """The port's BehaviorTrainState and FlowTrainState from flax trees."""
    import torch

    from behavior_driven_video_synthesis_tpu_torch.train.behavior import (
        BehaviorTrainState)
    from behavior_driven_video_synthesis_tpu_torch.train.flow import (
        FlowTrainState)
    from behavior_driven_video_synthesis_tpu_torch.train.state import (
        make_behavior_optimizers, make_flow_optimizer)

    tr = config()["training"]
    modules = port_modules()
    for name, m in modules.items():
        m.load_state_dict(from_flax(name, trees[name]))
        m.to(device)
    flow = port_flow()
    flow.load_state_dict(from_flax("flow", trees["flow"]))
    flow.to(device)
    state = BehaviorTrainState(
        modules, make_behavior_optimizers(modules, tr, N_STEPS),
        gamma=torch.zeros((), device=device))
    return state, FlowTrainState(flow, make_flow_optimizer(flow, tr))


def port_steps(trees, batch, draws, device="cpu", enable=True,
               stages=("cvae", "flow")):
    """The port's steps as :func:`jax_steps` takes them, on ``device``;
    ``stages`` ("cvae", "flow" or both) says which run.  Returns ({stage:
    [metrics]}, flax trees of the six modules after the steps)."""
    import torch

    from behavior_driven_video_synthesis_tpu_torch.train.behavior import (
        StepDraws, make_behavior_train_step)
    from behavior_driven_video_synthesis_tpu_torch.train.flow import (
        make_flow_train_step)

    def dev(a):
        return torch.as_tensor(a, device=device)

    state, fstate = port_state(trees, device)
    tbatch = {k: dev(v) for k, v in batch.items()}
    metrics = {}
    if "cvae" in stages:
        step = make_behavior_train_step(config(), T, total_steps=N_STEPS)
        metrics["cvae"] = [{k: v.cpu().numpy() for k, v in step(
            state, tbatch, enable, draws=StepDraws(
                dev(d["t_adv"]), [dev(t) for t in d["t_reg"]],
                dev(d["eps"]))).items()} for d in draws["cvae"]]
    if "flow" in stages:
        fstep = make_flow_train_step(state.modules["net"])
        metrics["flow"] = [{k: v.cpu().numpy() for k, v in fstep(
            fstate, tbatch, eps=dev(d["eps"])).items()}
            for d in draws["flow"]]
    after = {n: to_flax(n, state.modules[n].state_dict()) for n in MODULES}
    after["flow"] = to_flax("flow", fstate.flow.state_dict())
    return metrics, after


# Tolerances of the port against the JAX steps (f32; on the card with TF32
# off), which differ only in summation order: each metric rtol 1e-4 (the
# per-sequence loss elementwise), with atol 1e-5 for the loss; every
# parameter after the Adam updates atol 1e-4.
METRIC_RTOL = 1e-4
LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-4


def check_metrics(mine, ref):
    assert mine.keys() == ref.keys()
    for stage in ref:
        assert len(mine[stage]) == len(ref[stage])
        for m, r in zip(mine[stage], ref[stage]):
            assert m.keys() == r.keys()
            for k in r:
                atol = LOSS_ATOL if k in ("loss", "flow_loss") else 0.0
                np.testing.assert_allclose(m[k], r[k], rtol=METRIC_RTOL,
                                           atol=atol, err_msg=(stage, k))


def check_params(mine, ref):
    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        flatten_tree)

    fm, fr = flatten_tree(mine), flatten_tree(ref)
    assert fm.keys() == fr.keys()
    for k in fr:
        np.testing.assert_allclose(fm[k], fr[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
