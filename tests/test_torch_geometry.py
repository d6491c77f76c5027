"""The PyTorch port's camera and stickman raster against the JAX package.

Camera: <= 1e-5 on numpy inputs.  Stickman: both rasterize identical pixel
coordinates; a pixel whose centre lies within an ulp of a line's edge may
flip, so the images may differ in at most 0.1 % of their pixels.
"""
import dataclasses

import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu.data.human36m import (
    detailed_joint_model as jdetailed)
from behavior_driven_video_synthesis_tpu.generate import (
    chain_joint_model as jchain)
from behavior_driven_video_synthesis_tpu.geometry import camera as jcam
from behavior_driven_video_synthesis_tpu.geometry.stickman import (
    render_stickman as jrender)

from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
    detailed_joint_model)
from behavior_driven_video_synthesis_tpu_torch.generate import (
    chain_joint_model)
from behavior_driven_video_synthesis_tpu_torch.geometry import camera
from behavior_driven_video_synthesis_tpu_torch.geometry.stickman import (
    render_stickman)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_camera_matches_jax(rng):
    pts = rng.randn(2, 3, 17, 3).astype(np.float32)
    M = rng.randn(2, 1, 1, 3, 4).astype(np.float32)
    cam = (rng.randn(2, 3, 17, 3) + [0, 0, 6.0]).astype(np.float32)
    intr = (np.abs(rng.randn(2, 1, 4)) * 50 + 10).astype(np.float32)
    np.testing.assert_allclose(
        camera.apply_affine_transform(_t(pts), _t(M)).numpy(),
        np.asarray(jcam.apply_affine_transform(pts, M)), atol=1e-5)
    np.testing.assert_allclose(
        camera.camera_projection(_t(cam), _t(intr)).numpy(),
        np.asarray(jcam.camera_projection(cam, intr)), rtol=1e-6, atol=1e-5)
    extr = rng.randn(2, 3, 4).astype(np.float32)
    extr[..., 2, 3] += 8.0
    world = rng.randn(2, 17, 3).astype(np.float32)
    np.testing.assert_allclose(
        camera.project_world_to_image(_t(world), _t(extr),
                                      _t(intr[:, 0])).numpy(),
        np.asarray(jcam.project_world_to_image(world, extr, intr[:, 0])),
        rtol=1e-5, atol=1e-4)


def test_joint_models_match_jax():
    jm, ref = detailed_joint_model(True), jdetailed(True)
    for f in dataclasses.fields(jm):
        assert getattr(jm, f.name) == getattr(ref, f.name), f.name
    for n in (5, 17):
        assert dataclasses.asdict(chain_joint_model(n)) == {
            k: v for k, v in dataclasses.asdict(jchain(n)).items()
            if k != "norm_T"}


@pytest.mark.parametrize("model,size,thick", [("h36m", 64, 3.0),
                                              ("chain", 48, 2.0)])
def test_stickman_matches_jax(rng, model, size, thick):
    if model == "h36m":
        jm, jjm, k = detailed_joint_model(True), jdetailed(True), 17
    else:
        jm, jjm, k = chain_joint_model(9), jchain(9), 9
    joints = (rng.rand(3, 4, k, 2) * size * 1.1 - size * 0.05).astype(
        np.float32)
    joints[0, 0, 2] = -1.0  # an invalid joint is skipped
    out = render_stickman(_t(joints), jm, size, thickness=thick,
                          frames_per_chunk=5)
    ref = np.asarray(jrender(joints, jjm, size, thickness=thick))
    assert out.shape == ref.shape == (3, 4, size, size, 3)
    assert set(np.unique(out.numpy())) <= {0.0, 127.0, 255.0}
    mismatch = np.mean(np.any(out.numpy() != ref, axis=-1))
    assert mismatch <= 1e-3
    assert ref.any()  # something was drawn
