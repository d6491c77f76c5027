"""The port's GAN branch of the cvbae step against the JAX package's, on
the CPU.

The same numpy-seeded weights (drawn into the port's modules and carried
to flax trees through ``models/convert.py``) and inputs go through both
packages:

  * ``PatchGANDiscriminator`` (ndf 8, 2 layers, 32 px) and
    ``PartDiscriminator`` forwards in f32 within 1e-5 relative (atol 1e-6),
    and the PatchGAN's map sizes at 256 px (128, 64, 32, 31, 30);
  * ``disc_loss_with_r1`` with and without the R1 penalty, its value and
    its parameter gradients (the penalty's double backward included;
    1e-4 relative plus 1e-6 of the largest gradient),
    ``generator_gan_loss`` and its gradient with respect to the fake (no
    gradient reaches the discriminator) and ``adaptive_gan_weight``, within
    1e-5 relative (atol 1e-6);
  * the discriminators' converters round-trip exactly;
  * ``bdvs-train-torch`` with ``training.use_gan`` (cvbae, 32 px, nf
    4->8, B=2, a PatchGAN of ndf 4 and 2 layers with R1), killed after
    its step-4 save and resumed with ``-r``, ends with the VUNet, the
    regressor, the discriminator and its Adam state equal to those of an
    uninterrupted 6-step run, logs the GAN losses and runs ``-m infer``;
    the org experiment refuses
    ``use_gan``, naming ROADMAP C13.

The GAN step against the JAX step, and its golden, are in
``test_torch_gan_train.py`` (the JAX step's compile takes most of a
file's time).
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.models import (
    synth_discriminators as jsd)

from behavior_driven_video_synthesis_tpu_torch.flax_npz import flatten_tree
from behavior_driven_video_synthesis_tpu_torch.models import convert
from behavior_driven_video_synthesis_tpu_torch.models import (
    synth_discriminators as sd)
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_

from behavior_driven_video_synthesis_tpu_torch import main
from behavior_driven_video_synthesis_tpu_torch.core.config import (
    deep_merge, load_config)
from behavior_driven_video_synthesis_tpu_torch.experiments import (
    shape_and_pose_net as sp)

from torch_port_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6       # f32 forwards and gradients


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(mine, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(
        mine.detach().numpy() if torch.is_tensor(mine) else mine,
        np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def patchgan():
    """(port PatchGAN, its flax tree, images) from numpy seed 0."""
    rng = np.random.RandomState(0)
    disc = init_random_(sd.PatchGANDiscriminator(ndf=8, n_layers=2), rng)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    return disc, convert.patchgan_to_flax(disc.state_dict()), x


def _jax_patchgan():
    return jsd.PatchGANDiscriminator(ndf=8, n_layers=2)


def test_patchgan_forward_matches_jax(patchgan):
    disc, tree, x = patchgan
    ref = _jax_patchgan().apply({"params": tree}, jnp.asarray(x))
    out = disc(_t(x))
    assert out.shape == ref.shape == (2, 6, 6, 1)     # 16, 8, 7, 6
    _close(out, ref)


def test_patchgan_map_sizes_at_256px():
    disc = sd.PatchGANDiscriminator()          # ndf 64, 3 layers
    sizes, h = [], 256
    for conv, stride in zip(disc.convs, disc.strides):
        h = (h + 2 - conv.kernel_size[0]) // stride + 1
        sizes.append(h)
    assert sizes == [128, 64, 32, 31, 30]
    ref = jax.eval_shape(
        lambda x: jsd.PatchGANDiscriminator().init_with_output(
            jax.random.PRNGKey(0), x)[0],
        jax.ShapeDtypeStruct((1, 256, 256, 3), jnp.float32))
    assert ref.shape == (1, 30, 30, 1)


def test_part_discriminator_forward_matches_jax():
    rng = np.random.RandomState(1)
    disc = init_random_(sd.PartDiscriminator(n_scales=2, in_size=18,
                                             max_filters=24), rng)
    tree = convert.part_discriminator_to_flax(disc.state_dict())
    x = rng.uniform(-1, 1, (3, 18, 18, 3)).astype(np.float32)
    ref = jsd.PartDiscriminator(n_scales=2, max_filters=24).apply(
        {"params": tree}, jnp.asarray(x))
    out = disc(_t(x))
    assert out.shape == ref.shape == (3, 1)
    _close(out, ref)


def test_converters_round_trip(patchgan):
    disc, tree, _ = patchgan
    back = convert.patchgan_from_flax(tree)
    assert back.keys() == disc.state_dict().keys()
    for k, v in disc.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    part = init_random_(sd.PartDiscriminator(n_scales=2, in_size=18),
                        np.random.RandomState(2))
    back = convert.part_discriminator_from_flax(
        convert.part_discriminator_to_flax(part.state_dict()))
    assert back.keys() == part.state_dict().keys()
    for k, v in part.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("use_gp", [False, True])
def test_disc_loss_with_r1_matches_jax(patchgan, use_gp):
    disc, tree, real = patchgan
    fake = np.random.RandomState(3).uniform(-1, 1, real.shape).astype(
        np.float32)
    jdisc = _jax_patchgan()

    def jloss(p):
        return jsd.disc_loss_with_r1(
            lambda q, x: jdisc.apply({"params": q}, x), p,
            jnp.asarray(real), jnp.asarray(fake), lambda_gp=10.0,
            use_gp=use_gp)

    (ref_loss, ref_out), ref_grads = jax.value_and_grad(
        jloss, has_aux=True)(tree)
    disc.zero_grad(set_to_none=True)
    loss, out = sd.disc_loss_with_r1(disc, _t(real), _t(fake),
                                     lambda_gp=10.0, use_gp=use_gp)
    loss.backward()
    assert out.keys() == ref_out.keys()
    for k in ref_out:
        _close(out[k], ref_out[k], msg=k)
    if use_gp:
        assert float(out["gp"].detach()) > 0
    grads = convert.patchgan_to_flax(
        {k: p.grad for k, p in disc.named_parameters()})
    # each leaf within 1e-4 relative plus 1e-6 of the largest gradient: the
    # biases ahead of an instance norm have a zero gradient in exact
    # arithmetic and carry only rounding noise of that scale
    ref_flat, flat = flatten_tree(ref_grads), flatten_tree(grads)
    scale = max(float(np.abs(g).max()) for g in ref_flat.values())
    for k, g in ref_flat.items():
        _close(flat[k], g, rtol=1e-4, atol=1e-6 * scale, msg=k)


def test_generator_gan_loss_matches_jax(patchgan):
    disc, tree, _ = patchgan
    fake = np.random.RandomState(4).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    jdisc = _jax_patchgan()
    ref, ref_grad = jax.value_and_grad(
        lambda f: jsd.generator_gan_loss(
            lambda q, x: jdisc.apply({"params": q}, x), tree, f))(
        jnp.asarray(fake))
    disc.zero_grad(set_to_none=True)
    x = _t(fake).requires_grad_(True)
    loss = sd.generator_gan_loss(disc, x)
    loss.backward()
    _close(loss, ref)
    _close(x.grad, ref_grad)
    assert all(p.grad is None and p.requires_grad
               for p in disc.parameters())


def test_adaptive_gan_weight_matches_jax():
    rng = np.random.RandomState(5)
    a, b = rng.randn(2, 16, 3, 3).astype(np.float32)
    out = sd.adaptive_gan_weight(_t(a).requires_grad_(True), _t(b))
    assert not out.requires_grad
    _close(out, jsd.adaptive_gan_weight(jnp.asarray(a), jnp.asarray(b)))


# -- bdvs-train-torch ---------------------------------------------------------
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAN_KEYS = ("dloss", "dloss_r", "dloss_f", "gp", "gen_gan_loss")


def _cfg(base, experiment="cvbae", end_iteration=6):
    name = {"cvbae": "shape_and_pose_net.yaml", "vunet": "vunet.yaml"}
    cfg = load_config(os.path.join(REPO, "configs", name[experiment]))
    return deep_merge(cfg, {
        "general": {"base_dir": str(base), "project_name": "tiny"},
        "data": {"spatial_size": 32, "n_persons": 2,
                 "frames_per_person": 4, "box_factor": 1},
        "architecture": {"nf_start": 4, "nf_max": 8},
        "training": {"batch_size": 2, "end_iteration": end_iteration,
                     "bf16": False, "n_init_batches": 1, "use_gan": True,
                     "grad_pen": True, "gan_weight": 0.1, "lambda_gp": 1.0,
                     "disc_ndf": 4, "disc_layers": 2},
        "metrics": {"n_it_metrics": 1000, "ssim_train_samples": 4},
        "logging": {"ckpt_steps": 1000, "log_steps": 1000}})


def _run(base, cfg, *argv):
    path = os.path.join(str(base), "cfg.yaml")
    os.makedirs(str(base), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return main.main(["-c", path, "--device", "cpu", *argv])


def _same_state(a, b):
    for m in ("vunet", "regressor"):
        for k, v in a[m].state_dict().items():
            torch.testing.assert_close(v, b[m].state_dict()[k], rtol=0,
                                       atol=0, msg=f"{m}.{k}")
    for k, v in a["gan"].disc.state_dict().items():
        torch.testing.assert_close(v, b["gan"].disc.state_dict()[k], rtol=0,
                                   atol=0, msg=k)
    sa, sb = a["gan"].opt.state_dict(), b["gan"].opt.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(v, sb["state"][i][k], rtol=0, atol=0,
                                       msg=f"adam {i}.{k}")


class _Killed(Exception):
    pass


def test_cli_trains_resumes_and_infers_with_the_gan(tmp_path,
                                                    monkeypatch):
    """A run killed after its step-4 save and resumed with -r ends equal,
    bit for bit, to an uninterrupted 6-step run of the same config."""
    # the driver starts its epoch order afresh after -r, and the synthetic
    # dataset its regressor picks, as the JAX driver and dataset do; with
    # one order and one stream of picks for every epoch (8 images, 4
    # batches an epoch, killed after 4 steps) both runs see the same
    # batches, so the resumed run matches only if its checkpoint holds
    # everything the steps read
    def same_epochs(self):
        self.ds.rng = np.random.RandomState(0)
        return self.ds.batches(self.batch_size, seed=2)
    monkeypatch.setattr(sp._Epochs, "__iter__", same_epochs)
    cfg = _cfg(tmp_path / "whole")
    cfg["logging"]["ckpt_steps"] = 2
    whole = _run(tmp_path / "whole", cfg)

    part = tmp_path / "part"
    pcfg = deep_merge(cfg, {"general": {"base_dir": str(part)}})
    make = sp.ShapePoseExperiment._make_step

    def killed_at_4(self, *a):
        step = make(self, *a)

        def run(state, batch, **kw):
            if state.step == 4:
                raise _Killed
            return step(state, batch, **kw)
        return run
    with monkeypatch.context() as mp:
        mp.setattr(sp.ShapePoseExperiment, "_make_step", killed_at_4)
        with pytest.raises(_Killed):
            _run(part, pcfg)
    saves = part / "cvbae" / "ckpt" / "tiny" / "reg_ckpt"
    assert sorted(os.listdir(saves)) == ["step_2.pt", "step_4.pt"]
    saved = torch.load(saves / "step_4.pt", weights_only=False)
    assert {"disc"} <= set(saved["modules"]) & set(saved["optimizers"])
    resumed = _run(part, pcfg, "-r")
    assert resumed["state"].step == whole["state"].step == 6
    assert sorted(os.listdir(saves)) == ["step_2.pt", "step_4.pt",
                                         "step_6.pt"]
    assert any(not torch.equal(v, resumed["gan"].disc.state_dict()[k])
               for k, v in saved["modules"]["disc"].items())
    _same_state(resumed, whole)

    log = part / "cvbae" / "log" / "tiny" / "metrics.jsonl"
    with open(log) as f:
        train = [json.loads(ln) for ln in f if "train/loss" in ln]
    assert train and all(np.isfinite(ln[f"train/{k}"])
                         for ln in train for k in GAN_KEYS)
    summary = _run(part, pcfg, "-m", "infer")
    assert summary and all(np.isfinite(v) for v in summary.values())


def test_org_experiment_refuses_use_gan(tmp_path):
    with pytest.raises(ValueError, match="C13"):
        _run(tmp_path, _cfg(tmp_path, "vunet"))
