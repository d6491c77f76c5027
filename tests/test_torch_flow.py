"""The PyTorch port's LatentFlow against the JAX package.

Numpy-seeded weights and Shuffle permutations, exported as flax variables
({"params", "buffers"}) for the JAX module and converted back for the
port: forward z and logdet and the reverse agree within
1e-4 * (1 + max|ref|) in f32, for even and odd C.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.models import convert as jconv
from behavior_driven_video_synthesis_tpu.models.flows import (
    LatentFlow as JLatentFlow)
from behavior_driven_video_synthesis_tpu.models.flows.transformer import (
    flow_loss as jflow_loss)

from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models.flows import (
    CouplingFlowBlock, LatentFlow, flow_loss)
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-4 * (1 + np.abs(ref).max()))


def _flows(c, mid=24, n_flows=3, depth=2, seed=0):
    flow = LatentFlow(c, mid, flow_hidden_depth=depth, n_flows=n_flows)
    init_random_(flow, np.random.RandomState(seed))
    variables = pconv.latent_flow_to_flax(flow.state_dict())
    jflow = JLatentFlow(flow_in_channels=c, flow_mid_channels=mid,
                        flow_hidden_depth=depth, n_flows=n_flows)
    return flow, jflow, variables


@pytest.mark.parametrize("c,depth", [(16, 2), (7, 2), (9, 1)])
def test_forward_and_reverse_match_jax(rng, c, depth):
    flow, jflow, variables = _flows(c, depth=depth)
    b = rng.randn(5, c).astype(np.float32)
    jz, jld = jflow.apply(variables, jnp.asarray(b))
    jb = jflow.apply(variables, jz, method=jflow.reverse)
    with torch.no_grad():
        z, ld = flow(torch.from_numpy(b))
        back = flow.reverse(torch.from_numpy(np.array(jz)))
        round_trip = flow.reverse(z)
    _close(z, jz)
    _close(ld, jld)
    _close(back, jb)
    # odd C included: the reverse is the true inverse
    _close(round_trip, b)
    np.testing.assert_allclose(
        float(flow_loss(z, ld)), float(jflow_loss(jz, jld)), rtol=1e-4,
        atol=1e-4)


def test_sample_is_reverse_of_gaussian():
    flow, _, _ = _flows(8)
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    with torch.no_grad():
        s = flow.sample(4, generator=g1)
        want = flow.reverse(torch.randn(4, 8, generator=g2))
    np.testing.assert_array_equal(s.numpy(), want.numpy())


def test_converter_round_trips_through_jax_converter():
    """convert_latent_flow (reference state dict -> flax) is the oracle."""
    flow, _, variables = _flows(7, n_flows=2)
    sd = {k: v.numpy() for k, v in
          pconv.latent_flow_from_flax(variables).items()}
    back = jconv.convert_latent_flow(sd, n_flows=2, hidden_depth=2)
    flat_a = pconv.flatten_tree(variables)
    flat_b = pconv.flatten_tree(jax.tree_util.tree_map(np.asarray, back))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])
    fresh = LatentFlow(7, 24, n_flows=2)
    fresh.load_state_dict(pconv.latent_flow_from_flax(variables),
                          strict=True)
    assert fresh.flow.sub_layers[1].shuffle.forward_shuffle_idx.dtype == \
        torch.int64


def test_unported_couplings_raise():
    for kind in ("gin", "nice"):
        with pytest.raises(NotImplementedError):
            CouplingFlowBlock(8, 16, coupling_type=kind)
