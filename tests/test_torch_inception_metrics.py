"""The port's Inception metrics against the JAX package's, on the CPU.

  * ``InceptionV3Features`` at 128 x 128, B=2, loaded from the JAX
    package's variables through ``convert.inception_from_flax``: features
    and logits within rtol 1e-4 (atol 1e-6) of the JAX network in f32;
    the converter round-trips exactly; a torchvision-keyed state dict
    (with ``AuxLogits``) and a pickle of the JAX variables load;
  * the antialiased resize before Inception (256 -> 128 and 32 -> 128)
    within 1e-6 of ``jax.image.resize(..., "bilinear")``;
  * ``gaussian_stats``, ``fid_from_features`` and the Inception Score on
    the same arrays within 1e-6 relative;
  * the port on the CPU against ``tests/golden/torch_port_image_data_small
    .npz`` (``torch_port_image_data.check_against_golden``, what
    ``chip_smoke.py`` phase [19] runs on the GPU), and the golden's items
    against a live run of the JAX datasets;
  * the cvbae driver's evaluation with ``metrics.compute_is`` and
    ``compute_fid`` on the same VUNet weights, noise, batches and
    Inception weights as the JAX driver's ``_eval_ssim``: ``is_recon``,
    ``is_transfer`` within 1e-4 relative, the features the FID is taken
    of (and those the FID cache holds) within 1e-4.  The network's outputs are compared with
    an absolute tolerance of rtol times their largest magnitude.
"""
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.core import Config, KeySeq
from behavior_driven_video_synthesis_tpu import metrics as jmetrics
from behavior_driven_video_synthesis_tpu.experiments import (
    shape_and_pose_net as jexp_mod)
from behavior_driven_video_synthesis_tpu.metrics import fid as jfid
from behavior_driven_video_synthesis_tpu.metrics import (
    inception_score as jis)
from behavior_driven_video_synthesis_tpu.models.inception import (
    InceptionV3Features as JaxInception)
from behavior_driven_video_synthesis_tpu.models.vunet import (
    vunet_from_config as jvunet_from_config)

from behavior_driven_video_synthesis_tpu_torch.experiments import (
    shape_and_pose_net as sp)
from behavior_driven_video_synthesis_tpu_torch.metrics import (
    fid, inception_score)
from behavior_driven_video_synthesis_tpu_torch.models import convert
from behavior_driven_video_synthesis_tpu_torch.models.inception import (
    InceptionV3Features, inception_features, load_inception_weights)
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_

import make_torch_port_image_data_golden as MG
import torch_port_image_data as TI
from test_torch_vunet_cli import B, NF_MAX, _experiment, _jax_experiment
from torch_port_slice import jax_noise
from torch_port_threads import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "torch_port_image_data_small.npz")


@pytest.fixture(scope="module")
def inception():
    model = TI.seeded_inception()
    return model, convert.inception_to_flax(model.state_dict())


def test_features_and_logits_match_jax(inception):
    model, variables = inception
    x = np.random.RandomState(1).uniform(-1, 1, (B, 128, 128, 3)).astype(
        np.float32)
    with torch.no_grad():
        feats, logits = model(torch.from_numpy(x))
    jf, jl = JaxInception(with_logits=True).apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    assert feats.shape == (B, 2048) and logits.shape == (B, 1000)
    assert float(feats.abs().max()) > 0.05          # alive, not all zero
    for mine, ref in ((feats, jf), (logits, jl)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_the_converter_round_trips_and_weights_files_load(inception,
                                                          tmp_path):
    model, variables = inception
    sd = model.state_dict()
    back = convert.inception_from_flax(variables)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    tree = convert.flatten_tree(convert.inception_to_flax(back))
    assert tree.keys() == convert.flatten_tree(variables).keys()
    # a torchvision state dict: the same keys and AuxLogits beside them
    tv = dict(sd, **{"AuxLogits.fc.weight": torch.zeros(1000, 768),
                     "AuxLogits.conv0.conv.weight": torch.zeros(128, 768, 1,
                                                                1)})
    torch.save(tv, tmp_path / "inception_v3.pth")
    with open(tmp_path / "inception.pkl", "wb") as f:
        pickle.dump(variables, f)
    for path, unused in (("inception_v3.pth", 2), ("inception.pkl", 0)):
        fresh = InceptionV3Features(with_logits=True)
        assert len(load_inception_weights(fresh, str(tmp_path / path))) \
            == unused
        for k, v in fresh.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


@pytest.mark.parametrize("size", [256, 32])
def test_the_resize_before_inception_matches_jax(size):
    img = np.random.RandomState(size).uniform(-1, 1, (B, size, size, 3))
    img = img.astype(np.float32)
    seen = []
    inception_features(lambda x: seen.append(x.numpy()),
                       torch.from_numpy(img))
    ref = jax.image.resize(jnp.asarray(img), (B, 128, 128, 3), "bilinear")
    np.testing.assert_allclose(seen[0], np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fid_and_inception_score_match_jax(dtype):
    rng = np.random.RandomState(0)
    a = rng.randn(40, 16).astype(dtype)
    b = (rng.randn(30, 16) * 1.3 + 0.4).astype(dtype)
    for mine, ref in zip(fid.gaussian_stats(torch.from_numpy(a)),
                         jfid.gaussian_stats(a)):
        np.testing.assert_allclose(mine, ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())
    assert fid.fid_from_features(torch.from_numpy(a), b) == pytest.approx(
        jfid.fid_from_features(a, b), rel=1e-6)
    assert fid.fid_from_features(a, a) == pytest.approx(0.0, abs=1e-4)
    logits = rng.randn(24, 10).astype(dtype) * 3
    for splits in (1, 3):
        np.testing.assert_allclose(
            inception_score.inception_score_from_logits(
                torch.from_numpy(logits), splits),
            jis.inception_score_from_logits(logits, splits), rtol=1e-6)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32)))
    np.testing.assert_allclose(
        inception_score.inception_score_from_probs(probs, 2),
        jis.inception_score_from_probs(probs, 2), rtol=1e-6)


def test_the_evaluation_with_is_and_fid_matches_jax(tmp_path, monkeypatch,
                                                    inception):
    """The cvbae driver's evaluation, IS and FID on, on the same VUNet,
    noise, test batches and Inception weights as the JAX driver's.  Both
    drivers' FID function records the two feature sets it is given and
    returns their count (the 2048-wide matrix square root takes ~10 s on
    the CPU; the function itself is held against JAX above and in the
    golden)."""
    model, variables = inception
    weights = tmp_path / "inception.pkl"
    with open(weights, "wb") as f:
        pickle.dump(variables, f)
    metrics = {"compute_is": True, "compute_fid": True,
               "inception_weights_path": str(weights)}
    exp, cfg, dirs = _experiment(tmp_path / "port", "cvbae", **metrics)
    rng = np.random.RandomState(4)
    vunet, _ = exp._build_models(torch.Generator())
    init_random_(vunet, rng)
    vunet.eval().requires_grad_(False)
    noise = [rng.randn(B, w, w, NF_MAX).astype(np.float32)
             for w in exp._latent_widths()]
    monkeypatch.setattr(exp, "_eps", lambda n: [torch.from_numpy(a)
                                                for a in noise])
    calls = []

    def counted(model, img):
        calls.append(len(img))
        return inception_features(model, img)
    monkeypatch.setattr(sp, "inception_features", counted)
    fid_inputs = {}

    def recorded(name):
        def fid_from_features(a, b):
            fid_inputs[name] = [np.asarray(torch.as_tensor(np.asarray(x)))
                                for x in (a, b)]
            return float(len(a) + len(b))
        return fid_from_features
    monkeypatch.setattr(sp, "fid_from_features", recorded("port"))
    monkeypatch.setattr(jmetrics, "fid_from_features", recorded("jax"))
    mine = exp._eval_metrics(vunet, 0, max_samples=4)
    cache = os.path.join(dirs["ckpt"], "synthetic_images-fid-features.npy")
    assert np.load(cache).shape == (4, 2048)
    # transfers, targets and prior samples of 2 batches (the driver's
    # second evaluation reads the targets' features from the cache:
    # tests/test_torch_image_datasets_cli.py)
    assert calls == [B] * 6

    jdirs = {k: str(tmp_path / "jax" / k) for k in dirs}
    for d in jdirs.values():
        os.makedirs(d, exist_ok=True)
    jexp = _jax_experiment(jexp_mod.ShapePoseExperiment, cfg, jdirs, exp,
                           monkeypatch)
    logged = []
    monkeypatch.setattr(jexp.logger, "log",
                        lambda m, step, prefix="": logged.append(m))
    state = SimpleNamespace(vunet=SimpleNamespace(
        params=convert.vunet_alter_to_flax(vunet.state_dict())))
    with jax_noise(noise):
        jexp._eval_ssim(jvunet_from_config(Config(cfg), "alter"), state, 0,
                        KeySeq(0), max_samples=4)
    ref = logged[-1]
    assert set(mine) == set(ref) == {"ssim", "ssim_n", "is_recon",
                                     "is_transfer", "fid"}
    assert mine["ssim_n"] == ref["ssim_n"] == 4
    assert mine["ssim"] == pytest.approx(ref["ssim"], abs=1e-5)
    for k in ("is_recon", "is_transfer"):
        assert mine[k] == pytest.approx(ref[k], rel=1e-4), k
    assert mine["fid"] == ref["fid"] == 8
    # the transfers' and the targets' features, and the cached targets'
    for a, b in zip(fid_inputs["port"] + [np.load(cache)],
                    fid_inputs["jax"] + [np.load(os.path.join(
                        jdirs["ckpt"], "synthetic_images-fid-features.npy"))]):
        assert a.shape == b.shape == (4, 2048)
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())


def test_the_port_holds_the_image_data_golden(tmp_path):
    with np.load(GOLDEN) as data:
        golden = {k: data[k] for k in data.files}
    worst = TI.check_against_golden(golden, "cpu", str(tmp_path))
    assert worst.pop("images_equal_share") == 1.0
    assert all(v <= 1.0 for v in worst.values()), worst


def test_the_golden_items_equal_a_live_jax_run(tmp_path):
    with np.load(GOLDEN) as data:
        golden = {k: data[k] for k in data.files}
    trees = MG.write_trees(str(tmp_path), *MG.golden_inputs())
    live = MG.jax_items(trees)
    assert live.keys() == {k for k in golden if k.startswith("items/")}
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
    np.testing.assert_array_equal(
        MG.packed(MG.golden_inputs()[0])[0], golden["df/jpeg"])
