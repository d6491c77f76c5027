"""The PyTorch port's original VUNet (variant "org") against the JAX package.

Numpy-seeded weights go to the JAX ``VUNet(variant="org")`` as a flax tree
and to the port through its org converter; the appearance is a 30-channel
part stack (32 px, box_factor 1: a 16x16 appearance), and every normal
draw of the JAX model is replaced by the noise handed to the port, in draw
order.  encode_means, transfer_cached, transfer, test_forward and the
training forward agree within 1e-4 * (1 + max|ref|) in f32 on the CPU,
under both ``rnb_impl`` values (on the CPU the fused route runs the fused
RNB kernel's plain version).  Also: the golden file ``chip_smoke.py`` reads
(``tests/golden/torch_port_org_small.npz``) equals a live JAX run, and the
port reproduces it.
"""
import json
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
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn

import make_torch_port_org_golden as golden_maker
from make_torch_port_org_golden import jax_draws

S, NF0, NF1, B, BOX, CX = 32, 8, 16, 2, 1, 30
ARCH = dict(spatial_size=S, n_channels_x=CX, nf_start=NF0, nf_max=NF1,
            box_factor=BOX, variant="org")
N_SCALES = compute_n_scales(S, 2)                  # 4: 32, 16, 8, 4 px
N_SCALES_X = N_SCALES - BOX                        # 3: 16, 8, 4 px
POSTERIOR = [(B, 4, 4, NF1), (B, 8, 8, NF1)]       # one draw per scale
PRIOR = [(B, 2, 2, NF1), (B, 4, 4, NF1)]           # four groups per scale


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=0,
                               atol=1e-4 * (1 + np.abs(ref).max()))


@pytest.fixture(scope="module")
def nets():
    rng = np.random.RandomState(0)
    net = init_random_(VUNet(**ARCH), rng)
    tree = pconv.vunet_org_to_flax(net.state_dict())
    jnet = JVUNet(**ARCH)
    x = (rng.rand(B, S // 2, S // 2, CX) * 2 - 1).astype(np.float32)
    c = (rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
    post = [rng.randn(*s).astype(np.float32) for s in POSTERIOR]
    prior = [[rng.randn(*s).astype(np.float32) for _ in range(4)]
             for s in PRIOR]
    return net, jnet, tree, x, c, post, prior


def _port(net, rnb_impl):
    if rnb_impl == "cudnn":
        return net
    fused = VUNet(**ARCH, rnb_impl="fused")
    fused.load_state_dict(net.state_dict())
    return fused


def _jax(jnet, tree, method, *args, draws=(), **kw):
    fn = jax.jit(partial(jnet.apply, method=method, **kw))
    with jax_draws(draws):
        return fn({"params": tree},
                  *jax.tree_util.tree_map(jnp.asarray, args),
                  rngs={"sample": jax.random.PRNGKey(0)})


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("rnb_impl", ["cudnn", "fused"])
def test_encode_means_and_transfer_cached_match_jax(nets, rnb_impl):
    net, jnet, tree, x, c, post, _ = nets
    jmeans, jlogstds = _jax(jnet, tree, "encode_means", x, draws=post)
    jframes = _jax(jnet, tree, "transfer_cached",
                   [np.asarray(m) for m in jmeans], c)
    port = _port(net, rnb_impl)
    with torch.no_grad():
        means, logstds = port.encode_means(torch.from_numpy(x), _t(post))
        frames = port.transfer_cached(means, torch.from_numpy(c))
    assert logstds == [] and len(jlogstds) == 0
    for a, b in zip(means, jmeans):
        assert a.shape == b.shape
        _close(a, b)
    assert frames.shape == (B, S, S, 3)
    _close(frames, jframes)


@pytest.mark.parametrize("rnb_impl", ["cudnn", "fused"])
def test_transfer_and_test_forward_match_jax(nets, rnb_impl):
    net, jnet, tree, x, c, post, prior = nets
    jt = _jax(jnet, tree, "transfer", x, c, draws=post)
    jp = _jax(jnet, tree, "test_forward", c, draws=prior[0] + prior[1])
    port = _port(net, rnb_impl)
    with torch.no_grad():
        _close(port.transfer(torch.from_numpy(x), torch.from_numpy(c),
                             _t(post)), jt)
        _close(port.test_forward(torch.from_numpy(c),
                                 [_t(p) for p in prior]), jp)


def test_training_forward_matches_jax(nets):
    """The training path at dropout 0: images, posterior means and the
    autoregressive prior's means (the org KL's inputs)."""
    net, jnet, tree, x, c, post, _ = nets
    jimgs, jmeans, _, jps, _ = _jax(jnet, tree, None, x, c, draws=post)
    with torch.no_grad():
        imgs, means, logstds, ps, _ = net(torch.from_numpy(x),
                                          torch.from_numpy(c), eps=_t(post))
    assert logstds == [] and len(ps) == len(jps) == 2
    for a, b in zip([imgs] + means + ps, [jimgs] + list(jmeans) + list(jps)):
        assert a.shape == b.shape
        _close(a, b)


def test_fused_route_takes_the_blocks_without_aux(nets, monkeypatch):
    """Under rnb_impl "fused" the fused route runs every RNB without
    auxiliary input: EncUp's two a scale, and at the prior's latent
    scales the pre block; a serving transfer skips the prior."""
    net, _, _, x, c, post, prior = nets
    port = _port(net, "fused")
    calls = []
    real = pnn.VunetRNB._forward_fused

    def spy(rnb, v):
        calls.append(tuple(v.shape))
        return real(rnb, v)
    monkeypatch.setattr(pnn.VunetRNB, "_forward_fused", spy)
    with torch.no_grad():
        means, _ = port.encode_means(torch.from_numpy(x), _t(post))
        n_encode = len(calls)
        port.transfer_cached(means, torch.from_numpy(c))
        n_transfer = len(calls) - n_encode
        port.test_forward(torch.from_numpy(c), [_t(p) for p in prior])
    assert n_encode == 2 * N_SCALES_X
    assert n_transfer == 2 * N_SCALES
    assert len(calls) - n_encode - n_transfer == 2 * N_SCALES + 2
    assert (B, 4, 4, NF1) in calls[-N_SCALES - 4:]     # the pre blocks


def test_org_converter_round_trips_and_is_the_reference_layout(nets):
    """The org plan maps the JAX tree to the port's state dict and back,
    and its keys and values equal vunet_org_reference_state_dict's."""
    net, _, tree, _, _, _, _ = nets
    ref = jconv.vunet_org_reference_state_dict(
        {"params": tree}, n_scales=N_SCALES, n_scales_x=N_SCALES_X)
    sd = pconv.vunet_org_from_flax(tree)
    assert set(sd) == set(ref) == set(net.state_dict())
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k])
    back = pconv.flatten_tree(pconv.vunet_org_to_flax(sd))
    flat = pconv.flatten_tree(tree)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    # the JAX package's own converter takes the reference layout back
    jtree = pconv.flatten_tree(jconv.convert_vunet_org(
        ref, n_scales=N_SCALES, n_scales_x=N_SCALES_X)["params"])
    assert jtree.keys() == flat.keys()
    VUNet(**ARCH).load_state_dict(sd, strict=True)


def test_vunet_from_config_builds_the_org_variant():
    cfg = {"data": {"spatial_size": 32, "inplane_normalize": True,
                    "box_factor": 1},
           "architecture": {"nf_start": NF0, "nf_max": NF1},
           "training": {"bf16": False}}
    net = vunet_from_config(cfg, "org", rnb_impl="fused")
    assert net.variant == "org" and net.eu.nin.conv.weight_v.shape[1] == CX
    assert all(b.fused for b in net.eu.blocks) and not any(
        b.fused for b in net.dd.blocks)
    assert set(net.state_dict()) == set(VUNet(**ARCH).state_dict())
    with pytest.raises(ValueError, match="variant"):
        VUNet(spatial_size=S, variant="orig")
    with pytest.raises(ValueError, match="rnb_impl"):
        VUNet(spatial_size=S, rnb_impl="cutlass")


@pytest.fixture(scope="module")
def golden():
    with np.load(golden_maker.OUT) as data:
        return {k: data[k] for k in data.files}


def test_golden_equals_a_live_jax_run(golden):
    """tests/golden/torch_port_org_small.npz is what the maker writes from
    the JAX package now."""
    live = golden_maker.golden_arrays(0)
    assert set(golden) == set(live)
    for k, v in live.items():
        np.testing.assert_allclose(golden[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("rnb_impl", ["cudnn", "fused"])
def test_port_reproduces_the_golden(golden, rnb_impl):
    """What ``chip_smoke.py`` checks on the card, here on the CPU: the
    golden's weights through the org converter, its noise, its outputs."""
    arch = json.loads(golden["config"].tobytes())
    net = VUNet(**arch, rnb_impl=rnb_impl)
    net.load_state_dict(pconv.vunet_org_from_flax(pconv.unflatten_tree({
        k[len("params/vunet/"):]: v.astype(np.float32)
        for k, v in golden.items() if k.startswith("params/vunet/")})))
    post = [torch.from_numpy(golden[f"noise/posterior/{i}"])
            for i in range(2)]
    prior = [[torch.from_numpy(golden[f"noise/prior/{i}/{l}"])
              for l in range(4)] for i in range(2)]
    with torch.no_grad():
        means, _ = net.encode_means(torch.from_numpy(golden["inputs/x"]),
                                    post)
        frames = net.transfer_cached(means, torch.from_numpy(
            golden["inputs/c"]))
        sample = net.test_forward(torch.from_numpy(golden["inputs/c"]),
                                  prior)
    for i, m in enumerate(means):
        _close(m, golden[f"outputs/means/{i}"])
    _close(frames, golden["outputs/transfer_cached"])
    _close(sample, golden["outputs/test_forward"])
