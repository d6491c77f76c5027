"""The port's VGG19 perceptual features against the JAX package's, on the
CPU.

Random flax VGG19 weights (the JAX module's own init) go to the port
through ``vgg19_from_flax``, once directly and once through a ``.npz`` in
``load_npz_params``'s layout; the six levels of the pyramid agree at
32 px to rtol 1e-4 in f32.  ``perceptual_from_config`` builds the VGG19
for ``perceptual: vgg`` (frozen, seeded without a weights file) and
rejects an unknown name.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.models import perceptual as jperc

from behavior_driven_video_synthesis_tpu_torch.models import (
    perceptual as pperc)

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
