"""The port's flow stage against the JAX package's, on the CPU.

ActNorm's data-dependent init (``LatentFlow.initialize_``) against the JAX
``LatentFlow.init`` on the same batch, and two steps of
``make_flow_train_step`` in each package over the same frozen net, from
the same numpy-seeded weights, batch and posterior noise
(``torch_port_behavior.py``: ``dim_hidden_b`` 16, 3 flows of mid width 32,
f32), at the tolerances of ``torch_port_behavior.check_metrics`` and
``check_params``.
"""
import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu_torch.flax_npz import flatten_tree

import torch_port_behavior as TB


@pytest.fixture(scope="module")
def inputs():
    return TB.make_inputs(1)


def test_actnorm_init_matches_jax_init():
    """Every block's loc = -mean, scale = 1 / (std(ddof=1) + 1e-6) of the
    activations that reach it, earlier blocks already set: the JAX init's
    values to 1e-5.  The output's first features are then standardized."""
    import jax

    from behavior_driven_video_synthesis_tpu.models.flows import (
        LatentFlow as JaxFlow)

    b = (np.random.RandomState(2).randn(32, TB.H) * 3 + 1).astype(np.float32)
    ref = JaxFlow(flow_in_channels=TB.H, flow_mid_channels=TB.FLOW_MID,
                  flow_hidden_depth=2, n_flows=TB.N_FLOWS).init(
        {"params": jax.random.PRNGKey(0)}, b)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    flow = TB.port_flow()
    flow.load_state_dict(TB.from_flax("flow", ref))
    with torch.no_grad():
        for layer in flow.flow.sub_layers:
            layer.norm_layer.loc.zero_()
            layer.norm_layer.scale.fill_(1.0)
    flow.initialize_(torch.from_numpy(b))
    mine, want = (flatten_tree(TB.to_flax("flow", flow.state_dict())),
                  flatten_tree(ref))
    assert mine.keys() == want.keys()
    assert sum("loc" in k or "scale" in k for k in want) == 2 * TB.N_FLOWS
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    first = flow.flow.sub_layers[0].norm_layer
    with torch.no_grad():
        y, _ = first(torch.from_numpy(b))
    np.testing.assert_allclose(y.mean(0).numpy(), 0, atol=1e-5)
    np.testing.assert_allclose(y.std(0).numpy(), 1, atol=1e-4)


def test_flow_steps_match_jax(inputs):
    trees, batch, draws = inputs
    ref_metrics, ref_flow = TB.jax_flow_steps(trees["net"], trees["flow"],
                                              batch, draws)
    metrics, after = TB.port_steps(trees, batch, draws, stages=("flow",))
    TB.check_metrics(metrics, {"flow": ref_metrics})
    TB.check_params(after, dict(trees, flow=ref_flow))
    for m in metrics["flow"]:
        np.testing.assert_allclose(m["nll_loss"] + m["nlogdet_loss"],
                                   m["flow_loss"], rtol=1e-5)
