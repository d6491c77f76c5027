"""The port's other conv layers and the transposed subpixel upsample against
the JAX package, on the CPU.

``L2NormConv2d`` and ``LayerNormConv2d`` (``conv_layer_type`` ``l2`` and
``ln``) alone, in VUNets of both variants (their trees through the
converter plans, loaded with ``strict=True``), in the training forward and
in ``transfer``, and in one cvbae training step (loss, grad_norm and the
parameters after the update, with ``torch_port_train``'s tolerances).
``NormConv2d(d2s_transpose=True)`` against the JAX transposed conv and
against the port's own subpixel form, alone and in a VUNet.  Weights come
from numpy seeds through the port's modules; everything runs in f32
(max abs diff <= 1e-5 * (1 + max|ref|) for single layers, 1e-4 for whole
networks), except where a case says bf16.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.models import vunet as jvunet
from behavior_driven_video_synthesis_tpu.ops import nn as jnn

from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models.init import (
    init_like_jax_, init_random_)
from behavior_driven_video_synthesis_tpu_torch.models.vunet import VUNet
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn

import torch_port_train as TT
from torch_port_slice import jax_noise
from torch_port_threads import one_torch_thread  # noqa: F401

S, NF0, NF1, B = 32, 4, 8, 2
NOISE_SHAPES = [(B, 4, 4, NF1), (B, 8, 8, NF1)]


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def _close(out, ref, scale=1e-5):
    ref = _np(ref)
    np.testing.assert_allclose(_np(out), ref, rtol=0,
                               atol=scale * (1 + np.abs(ref).max()))


def _layer_tree(module, conv):
    init_random_(module, np.random.RandomState(3))
    plan = pconv._vunet_conv("x", (), 0, conv)
    tree = pconv.to_flax(torch.nn.ModuleDict({"x": module}).state_dict(),
                         plan)
    return tree[plan[0][1][0]]


# -- the layers ---------------------------------------------------------------

@pytest.mark.parametrize("conv", ["l2", "ln"])
@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (1, 1, 0), (3, 2, 1)])
def test_conv_layer_matches_jax(conv, k, stride, pad):
    cin, cout = 5, 7
    layer = pnn.CONV_LAYERS[conv](cin, cout, k, stride, pad)
    tree = _layer_tree(layer, conv)
    x = np.random.RandomState(4).randn(2, 9, 9, cin).astype(np.float32)
    ref = jnn.CONV_LAYERS[conv](cout, kernel_size=k, stride=stride,
                                padding=pad).apply({"params": tree},
                                                   jnp.asarray(x))
    with torch.no_grad():
        out = layer(torch.from_numpy(x))
    assert out.shape == ref.shape
    _close(out, ref)


def test_l2_norm_conv_init_and_names():
    """The JAX initializers (w ~ N(0, 0.05^2), bias and beta 0, gamma 1),
    the state-dict names, and use_bias=False."""
    layer = pnn.L2NormConv2d(16, 32, 3)
    init_like_jax_(layer, torch.Generator().manual_seed(0))
    assert set(layer.state_dict()) == {"weight", "bias", "gamma", "beta"}
    assert abs(float(layer.weight.std()) - 0.05) < 0.005
    assert float(layer.gamma.min()) == float(layer.gamma.max()) == 1.0
    assert not layer.bias.any() and not layer.beta.any()
    assert set(pnn.L2NormConv2d(4, 4, use_bias=False).state_dict()) == {
        "weight", "gamma", "beta"}
    assert set(pnn.LayerNormConv2d(4, 4).state_dict()) == {
        "conv.weight", "conv.bias"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_d2s_transpose_matches_jax_and_subpixel(dtype):
    """One transposed conv with the gathered 6x6 kernel and the parity
    affine is the subpixel conv + depth_to_space: against JAX's
    _conv_d2s_transpose path (f32: 1e-5; bf16: 1e-2 of the range, both
    packages rounding the same f32 sums to bf16) and against the port's
    subpixel form on the same parameters."""
    cin, c = 6, 5
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    up = pnn.NormConv2d(cin, 4 * c, 3, padding=1, d2s_transpose=True,
                        dtype=tdt)
    init_random_(up, np.random.RandomState(5))
    tree = pconv.to_flax(torch.nn.ModuleDict({"x": up}).state_dict(),
                         pconv._norm_conv("x", ()))
    sub = pnn.NormConv2d(cin, 4 * c, 3, padding=1, dtype=tdt)
    sub.load_state_dict(up.state_dict())
    x = np.random.RandomState(6).randn(2, 7, 9, cin).astype(np.float32)
    ref = jnn.NormConv2d(4 * c, kernel_size=3, padding=1,
                         d2s_transpose=True, dtype=jdt).apply(
        {"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        out = up(torch.from_numpy(x))
        via_subpixel = pnn.depth_to_space(sub(torch.from_numpy(x)), 2)
    assert out.shape == ref.shape == (2, 14, 18, c) and out.dtype == tdt
    scale = 1e-5 if dtype == "float32" else 1e-2
    _close(out, ref, scale)
    _close(out, via_subpixel, scale)


# -- VUNets -------------------------------------------------------------------

def _vunets(variant, conv, seed=0, **port_kw):
    kw = dict(spatial_size=S, nf_start=NF0, nf_max=NF1, variant=variant,
              conv_layer_type=conv)
    net = VUNet(**kw)
    init_random_(net, np.random.RandomState(seed))
    to_flax = (pconv.vunet_org_to_flax if variant == "org"
               else pconv.vunet_alter_to_flax)
    tree = to_flax(net.state_dict())
    if port_kw:
        served = VUNet(**kw, **port_kw)
        served.load_state_dict(net.state_dict())
        net = served
    return net.eval(), jvunet.VUNet(**kw, **port_kw), tree


def _images(seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
            for _ in range(2)] + [[rng.randn(*s).astype(np.float32)
                                   for s in NOISE_SHAPES]]


@pytest.mark.parametrize("variant", ["alter", "org"])
@pytest.mark.parametrize("conv", ["l2", "ln"])
def test_vunet_tree_loads_from_jax_init(variant, conv):
    """A tree of the JAX VUNet's names and shapes (its init, traced
    abstractly), filled from a numpy seed, loads strictly through the plan,
    and the port's tree goes back to the same values."""
    kw = dict(spatial_size=S, nf_start=NF0, nf_max=NF1, variant=variant,
              conv_layer_type=conv)
    x = jnp.zeros((1, S, S, 3))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jvunet.VUNet(**kw).init(
        {"params": key, "sample": key}, x, x)["params"])
    rng = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), shapes)
    from_flax = (pconv.vunet_org_from_flax if variant == "org"
                 else pconv.vunet_alter_from_flax)
    to_flax = (pconv.vunet_org_to_flax if variant == "org"
               else pconv.vunet_alter_to_flax)
    net = VUNet(**kw)
    net.load_state_dict(from_flax(tree), strict=True)
    back = pconv.flatten_tree(to_flax(net.state_dict()))
    flat = pconv.flatten_tree(tree)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("conv", ["l2", "ln"])
@pytest.mark.parametrize("train", [True, False])
def test_vunet_forward_matches_jax(conv, train):
    """The training forward (posterior samples, the noise handed to JAX)
    and, with train False, transfer (posterior means)."""
    net, jm, tree = _vunets("alter", conv)
    x, c, noise = _images(1)
    key = jax.random.PRNGKey(0)
    with torch.no_grad():
        if train:
            out = net(torch.from_numpy(x), torch.from_numpy(c), train=True,
                      eps=[torch.from_numpy(n) for n in noise])
        else:
            out = net.transfer(torch.from_numpy(x), torch.from_numpy(c),
                               [torch.from_numpy(n) for n in noise])
    with jax_noise(noise):
        if train:
            ref = jm.apply({"params": tree}, jnp.asarray(x), jnp.asarray(c),
                           train=True, rngs={"sample": key})
        else:
            ref = jm.apply({"params": tree}, jnp.asarray(x), jnp.asarray(c),
                           rngs={"sample": key}, method=jm.transfer)
    if train:
        _close(out[0], ref[0], 1e-4)
        for a, b in zip(out[1] + out[2], ref[1] + ref[2]):
            _close(a, b, 1e-4)
    else:
        _close(out, ref, 1e-4)


@pytest.mark.parametrize("conv", ["l2", "ln"])
def test_org_vunet_transfer_matches_jax(conv):
    net, jm, tree = _vunets("org", conv, seed=2)
    x, c, noise = _images(2)
    with torch.no_grad():
        means, _ = net.encode_means(torch.from_numpy(x),
                                    [torch.from_numpy(n) for n in noise])
        out = net.transfer_cached(means, torch.from_numpy(c))
    with jax_noise(noise):
        ref = jm.apply({"params": tree}, jnp.asarray(x), jnp.asarray(c),
                       rngs={"sample": jax.random.PRNGKey(0)},
                       method=jm.transfer)
    _close(out, ref, 1e-4)


@pytest.mark.parametrize("variant", ["alter", "org"])
def test_upsample_transpose_vunet_matches_jax_and_subpixel(variant):
    """A VUNet serving its subpixel upsamples as transposed convs, on the
    parameters of the subpixel one: against the JAX VUNet with
    upsample_transpose and against the port's subpixel VUNet."""
    sub, _, tree = _vunets(variant, "l1", seed=3)
    net, jm, _ = _vunets(variant, "l1", seed=3, upsample_transpose=True)
    x, c, noise = _images(3)
    with torch.no_grad():
        means, _ = net.encode_means(torch.from_numpy(x),
                                    [torch.from_numpy(n) for n in noise])
        out = net.transfer_cached(means, torch.from_numpy(c))
        plain = sub.transfer_cached(means, torch.from_numpy(c))
    ups = [m for m in net.modules() if isinstance(m, pnn.Upsample)]
    assert ups and all(m.transpose and m.up.d2s_transpose for m in ups)
    with jax_noise(noise):
        ref = jm.apply({"params": tree}, jnp.asarray(x), jnp.asarray(c),
                       rngs={"sample": jax.random.PRNGKey(0)},
                       method=jm.transfer)
    _close(out, ref, 1e-4)
    _close(out, plain, 1e-4)


# -- training -----------------------------------------------------------------

@pytest.mark.parametrize("conv", ["l2", "ln"])
def test_cvbae_step_matches_jax(conv):
    """One cvbae step of an l2 or ln VUNet in both packages: the metrics
    (loss, likelihood, KL, gamma, grad_norm, the regressor's loss) and
    every parameter after the update, with torch_port_train's tolerances
    (f32, summation order only)."""
    inputs = TT.make_inputs(0, conv_layer_type=conv)
    metrics, after = TT.port_steps(*inputs, n_steps=1, conv_layer_type=conv)
    ref_metrics, ref_after = TT.jax_steps(*inputs, n_steps=1,
                                          conv_layer_type=conv)
    TT.check_metrics(metrics, ref_metrics)
    assert np.isfinite(metrics[0]["loss"]) and metrics[0]["grad_norm"] > 0
    if conv == "ln":
        # a LayerNormConv2d's bias ahead of its instance norm has a zero
        # gradient in exact arithmetic, so each package's Adam moves it on
        # its own rounding noise, by at most lr a step (as the
        # discriminator's normed biases, torch_port_train.normed_bias_atol)
        bound = 2 * TT.config()["training"]["lr"]
        flat, ref = (pconv.flatten_tree(t["vunet"])
                     for t in (after, ref_after))
        normed = {k for k in ref if k.endswith("Conv_0/bias")}
        assert normed
        for k in normed:
            np.testing.assert_allclose(flat[k], ref[k], rtol=0, atol=bound,
                                       err_msg=k)
            flat[k] = ref[k]
        after = {**after, "vunet": pconv.unflatten_tree(flat)}
    TT.check_params(after, ref_after)
