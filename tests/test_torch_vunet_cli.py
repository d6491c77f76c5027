"""The VUNet experiments (cvbae and vunet) through the port's training
entry point (``bdvs-train-torch``), and their evaluation against the JAX
package, on the CPU.

At small width (32 px, nf 4->8, B=2, 8 images a split): each experiment
trains 3 steps, resumes with ``-r`` to step 6, runs no step when resumed
again, and is evaluated with ``-m infer``; it writes ``reg_ckpt/``,
``synth.npz``, ``metric_ckpts.json`` and image grids, and the org run's
``synth.npz`` serves through ``bdvs-generate-torch``.  The SSIM summary
equals JAX ``ssim`` on the same images to 1e-5; the post-hoc regressor's
loss equals the JAX driver's on the same VUNet, regressor weights, noise
and batches.  The org run refuses the post-hoc regressor with in-plane
part stacks (ROADMAP C6), beside the JAX driver, which fails on it; IS and
FID raise, naming A10b.
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.core import Config, KeySeq
from behavior_driven_video_synthesis_tpu.experiments import (
    shape_and_pose_net as jexp_mod)
from behavior_driven_video_synthesis_tpu.metrics import ssim as jssim
from behavior_driven_video_synthesis_tpu.models.vunet import (
    vunet_from_config as jvunet_from_config)

from behavior_driven_video_synthesis_tpu_torch import generate, main
from behavior_driven_video_synthesis_tpu_torch.core.config import (
    deep_merge, load_config)
from behavior_driven_video_synthesis_tpu_torch.experiments import (
    shape_and_pose_net as sp)
from behavior_driven_video_synthesis_tpu_torch.metrics.ssim import ssim
from behavior_driven_video_synthesis_tpu_torch.models import convert
from behavior_driven_video_synthesis_tpu_torch.models.behavior import (
    ResidualBehaviorNet)
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_

from torch_port_slice import jax_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, NF_MAX, B = 32, 8, 2
CONFIGS = {"cvbae": "shape_and_pose_net.yaml", "vunet": "vunet.yaml"}


def _cfg(tmp_path, experiment, **metrics):
    cfg = load_config(os.path.join(REPO, "configs", CONFIGS[experiment]))
    return deep_merge(cfg, {
        "general": {"base_dir": str(tmp_path / "runs"),
                    "project_name": "tiny"},
        "data": {"spatial_size": S, "n_persons": 2, "frames_per_person": 4,
                 "box_factor": 1},
        "architecture": {"nf_start": 4, "nf_max": NF_MAX},
        # at 3 steps the org KL ramp runs from step 1 to 2 (at 2 steps it
        # would have no length, and both packages divide by zero)
        "training": {"batch_size": B, "end_iteration": 3, "bf16": False,
                     "n_init_batches": 1},
        "metrics": deep_merge({"n_it_metrics": 3, "ssim_train_samples": 4,
                               "posthoc_regressor": experiment == "cvbae"},
                              metrics),
        "logging": {"ckpt_steps": 3, "log_steps": 3}})


def _write(tmp_path, cfg, name="cfg.yaml"):
    path = tmp_path / name
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _serve(tmp_path, synth_params):
    rng = np.random.RandomState(0)
    behavior = init_random_(ResidualBehaviorNet(48, 16), rng)
    convert.save_flax_npz(str(tmp_path / "behavior.npz"), {
        "net": convert.behavior_net_to_flax(behavior.state_dict())})
    with open(tmp_path / "behavior.json", "w") as f:
        json.dump({"architecture": {"dim_hidden_b": 16}}, f)
    return generate.main([
        "--behavior_params", str(tmp_path / "behavior.npz"),
        "--synth_params", synth_params, "--length", "3", "--batch", "2",
        "--device", "cpu", "--out", str(tmp_path / "served")])


@pytest.mark.parametrize("experiment", ["cvbae", "vunet"])
def test_train_resume_infer(tmp_path, experiment, monkeypatch, capsys):
    steps = []
    make = sp.ShapePoseExperiment._make_step if experiment == "cvbae" \
        else sp.VunetExperiment._make_step

    def counted(self, *a):
        step = make(self, *a)

        def run(state, batch, **kw):
            steps.append(state.step)
            return step(state, batch, **kw)
        return run
    monkeypatch.setattr(sp.VunetExperiment if experiment == "vunet"
                        else sp.ShapePoseExperiment, "_make_step", counted)
    path = _write(tmp_path, _cfg(tmp_path, experiment))
    out = main.main(["-c", path, "--device", "cpu"])
    assert out["state"].step == 3 and steps == [0, 1, 2]
    run = tmp_path / "runs" / experiment
    ckpt, gen = run / "ckpt" / "tiny", run / "generated" / "tiny"
    assert sorted(os.listdir(ckpt / "reg_ckpt")) == ["step_3.pt"]
    with open(ckpt / "metric_ckpts.json") as f:
        records = json.load(f)
    assert list(records) == ["3"] and 0 < records["3"]["ssim"] <= 1
    assert any(n.startswith("grid_0000003.") for n in os.listdir(gen))
    grid_path = [gen / n for n in os.listdir(gen) if n.startswith("grid")][0]

    # -r goes on from step 3 to the end_iteration of the run's config
    dumped = run / "config" / "tiny" / "config.yaml"
    cfg = load_config(str(dumped))
    assert cfg["general"]["tf32"] is False
    cfg["training"]["end_iteration"] = 6
    with open(dumped, "w") as f:
        yaml.safe_dump(cfg, f)
    capsys.readouterr()
    out = main.main(["-c", path, "--device", "cpu", "-r"])
    assert "Restored reg_ckpt checkpoint at step 3" in capsys.readouterr().out
    assert out["state"].step == 6 and steps == list(range(6))
    assert sorted(os.listdir(ckpt / "reg_ckpt")) == ["step_3.pt",
                                                      "step_6.pt"]
    with open(run / "log" / "tiny" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    train = [ln for ln in lines if "train/loss" in ln]
    assert [ln["step"] for ln in train] == [3, 6]
    if experiment == "vunet":   # the KL ramp (steps 3 to 4 of 6) went on
        assert train[1]["train/kl_weight"] == pytest.approx(  # from step 3
            (1e-6 + 2.0) / 3)
    out = main.main(["-c", path, "--device", "cpu", "-r"])
    assert out["state"].step == 6 and len(steps) == 6

    summary = main.main(["-c", path, "--device", "cpu", "-m", "infer"])
    want = {"ssim"} | ({"loss_regressor_posthoc"} if experiment == "cvbae"
                       else set())
    assert set(summary) == want
    assert all(np.isfinite(v) for v in summary.values())
    with open(run / "log" / "tiny" / "metrics.jsonl") as f:
        last = json.loads(f.readlines()[-1])
    assert last["infer/ssim"] == summary["ssim"]
    if experiment == "cvbae":
        pytest.importorskip("matplotlib")
        assert (gen / "loss_course_eval.png").exists()
    assert os.path.getsize(grid_path) > 0

    tree = convert.load_flax_npz(str(ckpt / "synth.npz"))
    from_flax = (convert.vunet_org_from_flax if experiment == "vunet"
                 else convert.vunet_alter_from_flax)
    for k, v in from_flax(tree["vunet"]).items():
        torch.testing.assert_close(v, out["vunet"].state_dict()[k],
                                   rtol=0, atol=0)
    if experiment == "vunet":
        man = _serve(tmp_path, str(ckpt / "synth.npz"))
        assert man["variant"] == "org" and len(man["videos"]) == 2


def test_infer_without_a_checkpoint_raises(tmp_path):
    path = _write(tmp_path, _cfg(tmp_path, "cvbae"))
    with pytest.raises(FileNotFoundError, match="reg_ckpt"):
        main.main(["-c", path, "--device", "cpu", "-m", "infer"])


def test_ssim_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(3, 24, 24, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    for x, y in ((a, b), (a, a), (b, rng.rand(*a.shape).astype(np.float32))):
        mine = ssim(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(mine, np.asarray(jssim(x, y)),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(ssim(torch.from_numpy(a),
                                    torch.from_numpy(a)).numpy(), 1.0,
                               atol=1e-6)


def _experiment(tmp_path, experiment, **metrics):
    cfg = _cfg(tmp_path, experiment, **metrics)
    dirs = {d: str(tmp_path / d) for d in ("ckpt", "config", "generated",
                                           "log")}
    cls = sp.VunetExperiment if experiment == "vunet" \
        else sp.ShapePoseExperiment
    exp = cls(cfg, dirs, "cpu")
    exp.generator = torch.Generator().manual_seed(0)
    return exp, cfg, dirs


def test_ssim_summary_matches_jax_on_the_same_images(tmp_path, monkeypatch):
    exp, _, _ = _experiment(tmp_path, "vunet")
    vunet, _ = exp._build_models(torch.Generator().manual_seed(1))
    seen = []

    def spy(x, y):
        seen.append((x.numpy(), y.numpy()))
        return ssim(x, y)
    monkeypatch.setattr(sp, "ssim", spy)
    val = exp._eval_ssim(vunet, 0, max_samples=6)
    assert len(seen) == 3 and sum(len(x) for x, _ in seen) == 6
    ref = np.concatenate([np.asarray(jssim(x, y)) for x, y in seen])
    assert abs(val - float(ref.mean())) <= 1e-5


class _NumpyView:
    """The port's dataset as the JAX driver reads one: numpy batches."""

    def __init__(self, ds):
        self.ds, self.norm_keypoints = ds, ds.norm_keypoints

    def __len__(self):
        return len(self.ds)

    def batches(self, batch_size, seed=0):
        for b in self.ds.batches(batch_size, seed=seed):
            yield {k: v.numpy() for k, v in b.items()}


def _jax_experiment(cls, cfg, dirs, port_exp, monkeypatch):
    """The JAX driver on the port's test batches, in the same order."""
    jexp = cls(Config(cfg), dirs)
    jexp.debug = True
    _, ds = port_exp._build_data("test")
    monkeypatch.setattr(jexp, "_build_data", lambda mode: (
        sp._Epochs(_NumpyView(ds), B, 1000), _NumpyView(ds)))
    return jexp


def test_posthoc_regressor_matches_jax(tmp_path, monkeypatch):
    exp, cfg, dirs = _experiment(tmp_path, "cvbae")
    exp.debug = True
    rng = np.random.RandomState(4)
    vunet, _ = exp._build_models(torch.Generator())
    init_random_(vunet, rng)
    vunet.eval().requires_grad_(False)
    regressor = init_random_(exp._new_regressor(36, torch.Generator()), rng)
    # copies: the port's run updates the regressor's tensors in place
    rtree = jax.tree_util.tree_map(np.array, convert.vunet_regressor_to_flax(
        regressor.state_dict()))
    noise = [rng.randn(B, w, w, NF_MAX).astype(np.float32)
             for w in exp._latent_widths()]
    monkeypatch.setattr(exp, "_eps", lambda n: [torch.from_numpy(a)
                                                for a in noise])
    monkeypatch.setattr(exp, "_new_regressor", lambda n, g: regressor)
    mine = exp._posthoc_latent_regressor(vunet)["loss_regressor_posthoc"]

    class SeededRegressor(jexp_mod.VunetRegressor):
        def init(self, key, x):
            return {"params": jax.tree_util.tree_map(jnp.asarray, rtree)}
    monkeypatch.setattr(jexp_mod, "VunetRegressor", SeededRegressor)
    jexp = _jax_experiment(jexp_mod.ShapePoseExperiment, cfg, dirs, exp,
                           monkeypatch)
    state = SimpleNamespace(vunet=SimpleNamespace(
        params=convert.vunet_alter_to_flax(vunet.state_dict())))
    jvunet = jvunet_from_config(Config(cfg), "alter")
    with jax_noise(noise):
        ref = jexp._posthoc_latent_regressor(jvunet, state, KeySeq(0))
    assert np.isclose(mine, ref["loss_regressor_posthoc"], rtol=1e-4), (
        mine, ref)


def test_posthoc_regressor_with_part_stacks_is_refused_as_jax_fails(
        tmp_path, monkeypatch):
    """ROADMAP C6: the JAX post-hoc regressor encodes the 3-channel pose
    image with the 30-channel appearance encoder; the port refuses the
    input before any work."""
    exp, cfg, dirs = _experiment(tmp_path, "vunet", posthoc_regressor=True)
    with pytest.raises(ValueError, match="C6"):
        exp.run_inference()
    path = _write(tmp_path, cfg)
    with pytest.raises(ValueError, match="C6"):
        main.main(["-c", path, "--device", "cpu", "-m", "infer"])
    vunet, _ = exp._build_models(torch.Generator().manual_seed(0))
    jexp = _jax_experiment(jexp_mod.VunetExperiment, cfg, dirs, exp,
                           monkeypatch)
    state = SimpleNamespace(vunet=SimpleNamespace(
        params=convert.vunet_org_to_flax(vunet.state_dict())))
    jvunet = jvunet_from_config(Config(cfg), "org", n_channels_x=30)
    with pytest.raises(Exception, match="ScopeParamShapeError|shape"):
        jexp._posthoc_latent_regressor(jvunet, state, KeySeq(0))


@pytest.mark.parametrize("metric", ["compute_is", "compute_fid"])
def test_is_and_fid_name_their_roadmap_item(tmp_path, metric):
    path = _write(tmp_path, _cfg(tmp_path, "cvbae", **{metric: True}))
    with pytest.raises(NotImplementedError, match="A10b"):
        main.main(["-c", path, "--device", "cpu"])
