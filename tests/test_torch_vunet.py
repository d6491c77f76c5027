"""The PyTorch port's VUNet-alter against the JAX package.

Numpy-seeded weights go to the JAX VUNet as a flax tree and to the port
through its converter; the posterior noise is handed to both.  encode_means,
transfer_cached, transfer and test_forward agree within
1e-4 * (1 + max|ref|) in f32 on the CPU.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.models import convert as jconv
from behavior_driven_video_synthesis_tpu.models.vunet import VUNet as JVUNet

from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.vunet import (
    VUNet, compute_n_scales, vunet_from_config)

from torch_port_slice import jax_noise

S, NF0, NF1, B = 32, 8, 16, 2
NOISE = [(B, 4, 4, NF1), (B, 8, 8, NF1)]


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=0,
                               atol=1e-4 * (1 + np.abs(ref).max()))


@pytest.fixture(scope="module")
def nets():
    rng = np.random.RandomState(0)
    net = VUNet(spatial_size=S, nf_start=NF0, nf_max=NF1)
    init_random_(net, rng)
    tree = pconv.vunet_alter_to_flax(net.state_dict())
    jnet = JVUNet(spatial_size=S, nf_start=NF0, nf_max=NF1, variant="alter")
    x = (rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
    c = (rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
    noise = [rng.randn(*s).astype(np.float32) for s in NOISE]
    return net, jnet, tree, x, c, noise


def _jax(jnet, tree, method, *args, noise=None):
    fn = jax.jit(partial(jnet.apply, method=method))
    with jax_noise(noise or []):
        return fn({"params": tree},
                  *jax.tree_util.tree_map(jnp.asarray, args),
                  rngs={"sample": jax.random.PRNGKey(0)})


def test_encode_means_and_transfer_cached_match_jax(nets):
    net, jnet, tree, x, c, noise = nets
    jmeans, jlogstds = _jax(jnet, tree, "encode_means", x, noise=noise)
    jframes = _jax(jnet, tree, "transfer_cached",
                   [np.asarray(m) for m in jmeans], c)
    with torch.no_grad():
        means, logstds = net.encode_means(
            torch.from_numpy(x), [torch.from_numpy(n) for n in noise])
        frames = net.transfer_cached(means, torch.from_numpy(c))
    for a, b in zip(means + logstds, list(jmeans) + list(jlogstds)):
        assert a.shape == b.shape
        _close(a, b)
    assert frames.shape == (B, S, S, 3)
    _close(frames, jframes)


def test_transfer_and_test_forward_match_jax(nets):
    net, jnet, tree, x, c, noise = nets
    jt = _jax(jnet, tree, "transfer", x, c, noise=noise)
    # the prior draws of test_forward have the latents' shapes too
    jp = _jax(jnet, tree, "test_forward", c, noise=noise)
    eps = [torch.from_numpy(n) for n in noise]
    with torch.no_grad():
        _close(net.transfer(torch.from_numpy(x), torch.from_numpy(c), eps),
               jt)
        _close(net.test_forward(torch.from_numpy(c), eps), jp)


def test_state_dict_is_the_reference_layout(nets):
    """The port's state dict equals vunet_alter_reference_state_dict of the
    JAX package key for key, and loads strictly."""
    net, _, tree, _, _, _ = nets
    n_scales = compute_n_scales(S, 2)
    ref = jconv.vunet_alter_reference_state_dict(
        {"params": tree}, n_scales=n_scales, n_scales_x=n_scales)
    sd = pconv.vunet_alter_from_flax(tree)
    assert set(sd) == set(ref) == set(net.state_dict())
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k])
    VUNet(spatial_size=S, nf_start=NF0, nf_max=NF1).load_state_dict(
        sd, strict=True)


def test_vunet_from_config_and_unported_options():
    net = vunet_from_config({"data": {"spatial_size": 64},
                             "architecture": {"nf_start": 4, "nf_max": 8},
                             "training": {"bf16": False}}, "alter")
    assert net.dtype == torch.float32 and net.spatial_size == 64
    assert vunet_from_config(None, "alter").dtype == torch.bfloat16
    # every option is ported: each builds, with the state dict of the
    # defaults but for the conv layer type; quant and the transposed
    # upsample need the l1 conv layer (the JAX package's assertions)
    plain = set(VUNet(spatial_size=S, nf_start=NF0, nf_max=NF1).state_dict())
    for kw in ({"quant": "int8_static"}, {"quant": "int8",
                                          "quant_max_hw": 8},
               {"upsample_transpose": True}, {"remat": "subnet"},
               {"conv_layer_type": "l2"}):
        net = VUNet(spatial_size=S, nf_start=NF0, nf_max=NF1, **kw)
        assert (set(net.state_dict()) == plain) == ("conv_layer_type"
                                                     not in kw)
    assert net.dtype == torch.float32
    for kw in ({"quant": "int8_static"}, {"upsample_transpose": True},
               {"rnb_impl": "fused"}):
        with pytest.raises(ValueError, match="l1"):
            VUNet(spatial_size=S, nf_start=NF0, nf_max=NF1,
                  conv_layer_type="ln", **kw)


def test_bf16_compute_stays_close_to_f32(nets):
    net, _, _, x, c, noise = nets
    bf = VUNet(spatial_size=S, nf_start=NF0, nf_max=NF1,
               dtype=torch.bfloat16)
    bf.load_state_dict(net.state_dict())
    eps = [torch.from_numpy(n) for n in noise]
    with torch.no_grad():
        ref = net.transfer(torch.from_numpy(x), torch.from_numpy(c), eps)
        out = bf.transfer(torch.from_numpy(x), torch.from_numpy(c), eps)
    assert out.dtype == torch.bfloat16
    rel = (out.float() - ref).norm() / ref.norm()
    assert float(rel) < 0.05
