"""The port's VGG19 perceptual features against the JAX package's, on the
CPU.

Random flax VGG19 weights (the JAX module's own init) go to the port
through ``vgg19_from_flax``, once directly and once through a ``.npz`` in
``load_npz_params``'s layout; the six levels of the pyramid agree at
32 px to rtol 1e-4 in f32.  ``perceptual_from_config`` builds the VGG19
for ``perceptual: vgg`` (frozen, seeded without a weights file) and
rejects an unknown name.  The VGG19 helpers: ``load_torchvision_vgg19``
turns a seeded state dict in torchvision's ``vgg19`` layout into the same
flax layers as the JAX function, bit for bit, whose features then agree
with JAX's; a ``.npz`` written by either package's ``save_npz_params``
loads bit for bit in the other's ``load_npz_params``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.models import perceptual as jperc

from behavior_driven_video_synthesis_tpu_torch.models import (
    perceptual as pperc)

from torch_port_threads import one_torch_thread  # noqa: F401

S, B = 32, 2


@pytest.fixture(scope="module")
def vgg_pair():
    variables = jperc.PerceptualVGG19().init(jax.random.PRNGKey(3),
                                             jnp.zeros((1, S, S, 3)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    x = (np.random.RandomState(0).rand(B, S, S, 3) * 2 - 1).astype(
        np.float32)
    ref = jax.tree_util.tree_map(
        np.asarray, jax.jit(jperc.PerceptualVGG19().apply)(variables, x))
    return variables, x, ref


def _check(vgg, x, ref):
    with torch.no_grad():
        out = vgg(torch.from_numpy(x))
    assert list(out) == pperc.feature_names() == list(ref)
    for k, v in ref.items():
        assert tuple(out[k].shape) == v.shape, k
        np.testing.assert_allclose(out[k].numpy(), v, rtol=1e-4,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)


def test_vgg19_features_match_jax(vgg_pair):
    variables, x, ref = vgg_pair
    vgg = pperc.PerceptualVGG19()
    vgg.load_state_dict(pperc.vgg19_from_flax(variables))
    _check(vgg, x, ref)


def test_vgg19_weights_file_through_the_config(vgg_pair, tmp_path):
    variables, x, ref = vgg_pair
    path = str(tmp_path / "vgg19.npz")
    jperc.save_npz_params(variables, path)
    vgg = pperc.perceptual_from_config({"training": {
        "perceptual": "vgg", "vgg_weights_path": path}})
    assert not any(p.requires_grad for p in vgg.parameters())
    _check(vgg, x, ref)


def test_vgg19_default_is_seeded_random_init(capsys):
    cfg = {"training": {}}
    a = pperc.perceptual_from_config(
        cfg, generator=torch.Generator().manual_seed(1))
    assert "RANDOM init" in capsys.readouterr().out
    b = pperc.perceptual_from_config(
        cfg, generator=torch.Generator().manual_seed(1))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    assert float(a.conv1_1.bias.abs().sum()) == 0.0
    assert isinstance(pperc.perceptual_from_config(
        {"training": {"perceptual": "laplacian"}}),
        pperc.LaplacianPyramidFeatures)
    with pytest.raises(ValueError, match="perceptual"):
        pperc.perceptual_from_config({"training": {"perceptual": "lpips"}})


def _torchvision_state_dict(seed=4):
    """A seeded ``torchvision.models.vgg19().state_dict()`` of the layers
    up to conv5_2 (the features' indices of its convs), with one of its
    classifier entries, which the helpers skip."""
    rng = np.random.RandomState(seed)
    sd, cin = {}, 3
    convs = [c for c in pperc.VGG19_CFG if c != "M"]
    for (name, cout), idx in zip(convs, pperc._TORCHVISION_CONV_IDX):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin)).astype(
                np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.randn(cout).astype(np.float32) * 0.01)
        cin = cout
    sd["classifier.0.bias"] = torch.zeros(8)
    return sd


def _same_tree(a, b):
    assert a["params"].keys() == b["params"].keys()
    for layer, p in b["params"].items():
        assert a["params"][layer].keys() == p.keys()
        for k, v in p.items():
            np.testing.assert_array_equal(np.asarray(a["params"][layer][k]),
                                          np.asarray(v), err_msg=layer + k)


def test_torchvision_vgg19_gives_the_jax_layers():
    sd = _torchvision_state_dict()
    mine = pperc.load_torchvision_vgg19(sd)
    ref = jperc.load_torchvision_vgg19({k: v.numpy() for k, v in sd.items()})
    _same_tree(mine, ref)
    assert mine["params"]["conv5_2"]["kernel"].shape == (3, 3, 512, 512)
    vgg = pperc.PerceptualVGG19()
    vgg.load_state_dict(pperc.vgg19_from_flax(mine))
    x = (np.random.RandomState(1).rand(B, S, S, 3) * 2 - 1).astype(
        np.float32)
    out = jax.tree_util.tree_map(np.asarray, jax.jit(
        jperc.PerceptualVGG19().apply)(ref, x))
    _check(vgg, x, out)


def test_npz_params_load_across_packages(vgg_pair, tmp_path):
    variables = vgg_pair[0]
    mine = str(tmp_path / "port.npz")
    pperc.save_npz_params(variables, mine)
    _same_tree(jperc.load_npz_params(mine), variables)
    theirs = str(tmp_path / "jax.npz")
    jperc.save_npz_params(variables, theirs)
    _same_tree(pperc.load_npz_params(theirs), variables)
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
