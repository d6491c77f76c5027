"""The port's figures (``experiments/visualize.py``) against the JAX
package's, on the CPU.

Sequence figures: the device rollouts of ``visualize_transfer3d``,
``latent_interpolate_videos``, ``make_behavior_startpose_grid`` and
``visualize_mtvae`` give the world poses that the JAX functions hand to
their skeleton drawer (recorded there), to atol 1e-4, with the JAX draws
handed over (the posterior noise and prior codes by shape, the MT-VAE's
by call order).  RGB figures: ``render_rgb_videos``,
``make_enrollment_figures``, ``latent_interpolate_eval_figures`` and
``sample_examples_single_figures`` run the small serving slice
(``tests/torch_port_slice.py``) in both packages; each pipeline call's
poses agree to atol 1e-4 and its frames to a mean of 1e-3 (the slice
test's end-to-end tolerance), with the appearance noise handed over.
Every figure returns the JAX function's keys and file names.  The
behavior net is ``tests/torch_port_behavior.py``'s (9 keypoints, H 16,
T 8), the MT-VAE ``tests/torch_port_mtvae.py``'s.

Also: the JAX figures fail for an org synthesis run (ROADMAP C17), which
the port refuses up front.
"""
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.experiments import (
    visualize as jax_vis)
from behavior_driven_video_synthesis_tpu.geometry import (
    normalization as jax_norm)

from behavior_driven_video_synthesis_tpu_torch.experiments import visualize
from behavior_driven_video_synthesis_tpu_torch.geometry import normalization
from behavior_driven_video_synthesis_tpu_torch.models import convert
import torch_port_behavior as TB
import torch_port_mtvae as TM
import torch_port_slice as TS
from torch_port_threads import one_torch_thread  # noqa: F401

pytest.importorskip("cv2")
FULL = 12      # the keypoints' full dimension; 9 of the 12 are used


def _stats():
    rng = np.random.RandomState(11)
    arrays = dict(mean=(rng.randn(FULL) * 0.1).astype(np.float32),
                  std=(rng.rand(FULL) * 0.5 + 0.5).astype(np.float32),
                  dim_to_use=np.delete(np.arange(FULL), [0, 5, 9]),
                  dim_to_ignore=np.asarray([0, 5, 9]))
    return (normalization.NormStats(**arrays),
            jax_norm.NormStats(**arrays))


@pytest.fixture(scope="module")
def behavior():
    trees, batch, _ = TB.make_inputs(0)
    net = TB.port_modules()["net"]
    net.load_state_dict(TB.from_flax("net", trees["net"]))
    rng = np.random.RandomState(3)
    batch = {"keypoints": batch["keypoints"],
             "paired_keypoints": batch["keypoints"][rng.permutation(TB.B)]}
    return trees["net"], TB._jax_setup()[1]["net"], net.eval(), batch


class Drawn:
    """Stands in for the JAX module's skeleton drawer: records the poses
    and returns small blank frames."""

    def __init__(self):
        self.poses = []

    def __call__(self, poses, out_path=None, fps=25, lines=None,
                 figsize=(4, 4)):
        self.poses.append(np.asarray(poses))
        return np.zeros((poses.shape[0], 4, 4, 3), np.uint8)


def _names(paths, root):
    if isinstance(paths, str):
        return os.path.relpath(paths, root)
    return {k: os.path.relpath(v, root) for k, v in paths.items()}


def _jax_drawn(fn, *args, **kw):
    drawn = Drawn()
    with mock.patch.object(jax_vis, "create_video_3d", drawn):
        out = fn(*args, **kw)
    return out, drawn.poses


def _close(mine, ref):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref),
                               atol=1e-4, rtol=0)


def test_transfer3d_rollouts(behavior, tmp_path):
    tree, jnet, net, batch = behavior
    stats, jstats = _stats()
    rng = np.random.RandomState(4)
    eps = rng.randn(2, TB.H).astype(np.float32)
    z = rng.randn(2 * 3, TB.H).astype(np.float32)
    with TS.jax_noise([eps, z]):
        ref_paths, drawn = _jax_drawn(
            jax_vis.visualize_transfer3d, jnet, tree, batch,
            str(tmp_path / "jax"), jax.random.PRNGKey(0), seq_len=TB.T,
            norm_stats=jstats, tag="e000_")
    mine = visualize.transfer3d_rollouts(
        net, batch, TB.T, stats, eps=torch.from_numpy(eps),
        z=torch.from_numpy(z))
    for i in range(2):
        gt, recon, swap, *samples = drawn[6 * i:6 * (i + 1)]
        _close(mine["gt"][i], gt)
        _close(mine["recon"][i], recon)
        _close(mine["swap"][i], swap)
        _close(mine["samples"][i], np.stack(samples))
    assert mine["samples"].shape == (2, 3, TB.T, FULL // 3, 3)
    paths = visualize.visualize_transfer3d(
        net, batch, str(tmp_path / "port"), TB.T, norm_stats=stats,
        tag="e000_", eps=torch.from_numpy(eps), z=torch.from_numpy(z))
    assert _names(paths, tmp_path / "port") == _names(ref_paths,
                                                      tmp_path / "jax")


def test_interpolation_and_startpose_grid(behavior, tmp_path):
    tree, jnet, net, batch = behavior
    stats, jstats = _stats()
    key = jax.random.PRNGKey(1)
    ref_path, drawn = _jax_drawn(
        jax_vis.latent_interpolate_videos, jnet, tree, batch,
        str(tmp_path / "jax"), key, seq_len=TB.T, norm_stats=jstats,
        tag="e001_")
    _close(visualize.interpolation_rollouts(net, batch, TB.T, stats),
           np.stack(drawn))
    path = visualize.latent_interpolate_videos(
        net, batch, str(tmp_path / "port"), TB.T, norm_stats=stats,
        tag="e001_")
    assert _names(path, tmp_path / "port") == _names(ref_path,
                                                     tmp_path / "jax")

    ref_path, drawn = _jax_drawn(
        jax_vis.make_behavior_startpose_grid, jnet, tree, batch,
        str(tmp_path / "jax"), key, seq_len=TB.T, norm_stats=jstats)
    grid, gt = visualize.startpose_grid_rollouts(net, batch, TB.T, stats)
    assert grid.shape[:2] == (3, 3)
    # the header (the blank cell's template, then the start poses), then
    # per behavior its source and its 3 rollouts
    _close(gt[:3], np.stack(drawn[1:4]))
    for r in range(3):
        row = drawn[4 + 4 * r:8 + 4 * r]
        _close(gt[r], row[0])
        _close(grid[r], np.stack(row[1:]))
    path = visualize.make_behavior_startpose_grid(
        net, batch, str(tmp_path / "port"), TB.T, norm_stats=stats)
    assert _names(path, tmp_path / "port") == _names(ref_path,
                                                     tmp_path / "jax")


def test_mtvae_rollouts(tmp_path):
    tree, batch, _ = TM.make_inputs()
    model = TM.port_model()
    model.load_state_dict(convert.mtvae_from_flax(tree))
    stats, jstats = _stats()
    rng = np.random.RandomState(5)
    noise = [{k: rng.randn(2, *s[1:]).astype(np.float32)
              for k, s in model.noise_shapes(2).items()} for _ in range(4)]
    with TM.jax_noise_in_order([n[k] for n in noise
                                for k in ("h0", "c0", "z", "cycle")]):
        ref_paths, drawn = _jax_drawn(
            jax_vis.visualize_mtvae, TM.jax_model(), tree, batch,
            str(tmp_path / "jax"), jax.random.PRNGKey(2),
            norm_stats=jstats, tag="e000_")
    torch_noise = [{k: torch.from_numpy(v) for k, v in n.items()}
                   for n in noise]
    mine = visualize.mtvae_rollouts(model.eval(), batch, stats,
                                    noise=torch_noise)
    for i in range(2):
        gt, recon, *samples = drawn[5 * i:5 * (i + 1)]
        _close(mine["gt"][i], gt)
        _close(mine["recon"][i], recon)
        _close(mine["samples"][i], np.stack(samples))
    paths = visualize.visualize_mtvae(model, batch, str(tmp_path / "port"),
                                      norm_stats=stats, tag="e000_",
                                      noise=torch_noise)
    assert _names(paths, tmp_path / "port") == _names(ref_paths,
                                                      tmp_path / "jax")


# -- RGB figures through both pipelines -------------------------------------


def _vunet_noise(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, *s[1:]).astype(np.float32)
            for s in TS.NOISE_SHAPES]


class Recorded:
    """Records a pipeline method's outputs."""

    def __init__(self, pipe, name):
        self.outs = []
        fn = getattr(pipe, name)

        def call(*a, **kw):
            out = fn(*a, **kw)
            self.outs.append(out)
            return out
        setattr(pipe, name, call)


@pytest.fixture(scope="module")
def pipelines():
    trees, inputs, _ = TS.make_slice(0)
    return (trees, inputs, TS.jax_pipeline(inputs=inputs),
            TS.port_pipeline(trees, inputs))


def _same_outputs(mine, ref):
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        _close(a["poses_3d"].float(), b["poses_3d"])
        assert np.mean(np.abs(a["frames"].float().numpy()
                              - np.asarray(b["frames"], np.float32))) <= 1e-3


FIGURES = {
    # name: (method, batch of the pipeline call, run(module, pipe, ...))
    "rgb_videos": ("generate", 2),
    "enrollment": ("reenact", 2),
    "interpolation": ("generate", 3 * 2),
    "samples": ("generate", 2 + 2),
}


@pytest.mark.parametrize("figure", sorted(FIGURES))
def test_pipeline_figures(pipelines, tmp_path, figure):
    trees, inputs, jpipe, ppipe = pipelines
    method, n = FIGURES[figure]
    noise = _vunet_noise(n, seed=n)
    cams = TS.camera_args(inputs)
    key = jax.random.PRNGKey(3)
    z = np.random.RandomState(6).randn(2, TS.HID).astype(np.float32)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = {"eps": [torch.from_numpy(a) for a in noise]}
    src, kps2 = inputs["x_source"][0], inputs["x_source"][1]
    if figure == "rgb_videos":
        def ref():
            return jax_vis.render_rgb_videos(
                jpipe, trees, z, inputs["x_start"], *cams, key, jdir,
                length=TS.T)

        def port():
            return visualize.render_rgb_videos(
                ppipe, z, inputs["x_start"], *cams, pdir, length=TS.T, **kw)
    elif figure == "enrollment":
        def ref():
            return jax_vis.make_enrollment_figures(
                jpipe, trees, src, inputs["x_start"][1], *cams, key, jdir,
                length=TS.T, disc_step=2)

        def port():
            return visualize.make_enrollment_figures(
                ppipe, src, inputs["x_start"][1], *cams, pdir, length=TS.T,
                disc_step=2, **kw)
    elif figure == "interpolation":
        def ref():
            return jax_vis.latent_interpolate_eval_figures(
                jpipe, jpipe.behavior_model, trees, src, kps2, *cams, key,
                jdir, n_steps=3, length=TS.T, disc_step=2)

        def port():
            return visualize.latent_interpolate_eval_figures(
                ppipe, ppipe.behavior_model, src, kps2, *cams, pdir,
                n_steps=3, length=TS.T, disc_step=2, **kw)
    else:
        def ref():
            return jax_vis.sample_examples_single_figures(
                jpipe, jpipe.behavior_model, trees, src, kps2,
                *(a[0] for a in cams), key, jdir, n_samples=2, length=TS.T,
                disc_step=2)

        def port():
            return visualize.sample_examples_single_figures(
                ppipe, ppipe.behavior_model, src, kps2,
                *(a[0] for a in cams), pdir, n_samples=2, length=TS.T,
                disc_step=2, z=torch.from_numpy(z), **kw)
    rec_j, rec_p = Recorded(jpipe, method), Recorded(ppipe, method)
    try:
        with TS.jax_noise(noise + [z]):
            ref_paths = ref()
        paths = port()
    finally:
        for p in (jpipe, ppipe):
            del p.__dict__[method]
    _same_outputs(rec_p.outs, rec_j.outs)
    assert rec_p.outs[0]["frames"].shape[0] == n
    assert _names(paths, pdir) == _names(ref_paths, jdir)
    for p in paths.values():
        assert os.path.getsize(p) > 0


# -- -s of an org run (ROADMAP C17) -----------------------------------------


def _org_config(spatial):
    return {"general": {"experiment": "vunet"},
            "data": {"spatial_size": spatial, "inplane_normalize": True,
                     "box_factor": 1},
            "architecture": {"nf_start": TS.NF_START, "nf_max": TS.NF_MAX},
            "training": {"bf16": False}}


def test_jax_figures_fail_for_an_org_synthesis_run(pipelines):
    """The JAX ``_maybe_render_rgb`` builds an org VUNet from an org run's
    config and hands it RGB appearances, which it cannot take (its
    catch-all prints "synth rendering skipped")."""
    from flax.errors import ScopeParamShapeError

    from behavior_driven_video_synthesis_tpu.core import Config
    from behavior_driven_video_synthesis_tpu.models.vunet import (
        vunet_from_config)

    trees, inputs, jpipe, _ = pipelines
    vunet = vunet_from_config(Config(_org_config(TS.S)), "org")
    shapes = jax.eval_shape(vunet.init, {
        k: jax.random.PRNGKey(0) for k in ("params", "sample", "dropout")},
        jnp.zeros((1, TS.S // 2, TS.S // 2, 30)),
        jnp.zeros((1, TS.S, TS.S, 3)))["params"]
    params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                    shapes)
    org = TS.jax_pipeline(inputs=inputs)
    org.vunet = vunet
    with pytest.raises(ScopeParamShapeError, match="30"):
        org.generate({**trees, "vunet": params}, inputs["z"],
                     inputs["x_start"], *TS.camera_args(inputs),
                     jax.random.PRNGKey(0), length=TS.T)


def test_port_refuses_an_org_synthesis_run(tmp_path):
    from behavior_driven_video_synthesis_tpu_torch.core.checkpoint import (
        CheckpointManager)
    from behavior_driven_video_synthesis_tpu_torch.core.config import (
        save_config)
    from behavior_driven_video_synthesis_tpu_torch.experiments import (
        behavior_net)

    run = tmp_path / "runs" / "vunet"
    save_config(_org_config(64), run / "config" / "p" / "config.yaml")
    CheckpointManager(str(run / "ckpt" / "p" / "reg_ckpt")).save(1, {})
    for run_dir in (run, run / "ckpt" / "p"):
        cfg = {**TB.config(), "logging": {"synth_params": str(run_dir)}}
        dirs = {k: str(tmp_path / k) for k in ("ckpt", "log", "generated")}
        with pytest.raises(ValueError, match="C17"):
            behavior_net.BehaviorNetExperiment(cfg, dirs, "cpu")
    with pytest.raises(FileNotFoundError, match="reg_ckpt"):
        visualize.load_synth_params(str(tmp_path / "none"))
