"""The PyTorch port's camera and stickman raster against the JAX package.

Camera: <= 1e-5 on numpy inputs.  Stickman: both rasterize identical pixel
coordinates; a pixel whose centre lies within an ulp of a line's edge may
flip, so the images may differ in at most 0.1 % of their pixels.
"""
import dataclasses
import json

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

from behavior_driven_video_synthesis_tpu_torch.data.deepfashion import (
    deepfashion_joint_model)
from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
    detailed_joint_model)
from behavior_driven_video_synthesis_tpu_torch.generate import (
    chain_joint_model)
from behavior_driven_video_synthesis_tpu_torch.geometry import camera
from behavior_driven_video_synthesis_tpu_torch.data.market import (
    market_joint_model)
from behavior_driven_video_synthesis_tpu_torch.geometry.stickman import (
    render_stickman, render_stickman_plain)
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (
    stickman as SK)

import make_torch_port_stickman_golden as stick_golden


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


def _part_warps(norm_T):
    """The part builders of a joint model by name and keywords (the two
    packages hold their own functions)."""
    return [(getattr(f, "func", f).__name__, getattr(f, "keywords", {}))
            for f in norm_T]


def test_joint_models_match_jax():
    jm, ref = detailed_joint_model(True), jdetailed(True)
    for f in dataclasses.fields(jm):
        if f.name == "norm_T":
            assert _part_warps(jm.norm_T) == _part_warps(ref.norm_T)
            continue
        assert getattr(jm, f.name) == getattr(ref, f.name), f.name
    for n in (5, 17):
        assert dataclasses.asdict(chain_joint_model(n)) == {
            k: v for k, v in dataclasses.asdict(jchain(n)).items()
            if k != "norm_T"} | {"norm_T": []}


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


PORT_JOINT_MODELS = {"h36m_world": lambda: detailed_joint_model(True),
                     "h36m_image": lambda: detailed_joint_model(False),
                     "market": market_joint_model,
                     "deepfashion": deepfashion_joint_model,
                     "chain": lambda: chain_joint_model(9)}


@pytest.mark.parametrize("i", range(len(stick_golden.CASES)),
                         ids=[c["name"] for c in stick_golden.CASES])
def test_stickman_golden_equals_a_live_jax_run(i):
    """tests/golden/torch_port_stickman_small.npz, which the GPU tests hold
    the raster kernel against, is what the maker writes now; the port's
    CPU path holds it as the kernel does (at most 0.1 % of the pixels
    differ; where the raster agrees, the bf16 VUNet input is the JAX
    pipeline's bit for bit)."""
    case = stick_golden.CASES[i]
    with np.load(stick_golden.OUT) as data:
        cases = json.loads(bytes(data["cases"]).decode())
        joints, stick, normalized = (data[f"{case['name']}/{k}"] for k in
                                     ("joints", "stick", "normalized"))
    assert cases[i] == {k: case[k] for k in ("name", "model", "S",
                                             "thickness")}
    np.testing.assert_array_equal(joints, stick_golden.golden_joints(
        case["frames"], stick_golden.MODELS[case["model"]][1], case["S"],
        stick_golden.SEED + i))
    live_stick, live_normalized = stick_golden.render(case, joints)
    np.testing.assert_array_equal(live_stick, stick)
    np.testing.assert_array_equal(live_normalized, normalized)
    jm = PORT_JOINT_MODELS[case["model"]]()
    out = render_stickman(_t(joints), jm, case["S"], case["thickness"])
    bits = render_stickman(_t(joints), jm, case["S"], case["thickness"],
                           normalized=True).view(torch.int16).numpy()
    differ = np.any(out.numpy() != stick, axis=-1)
    assert differ.mean() <= 1e-3, f"{int(differ.sum())} pixels differ"
    np.testing.assert_array_equal(bits.view(np.uint16)[~differ],
                                  normalized[~differ])
    assert stick.any()  # something was drawn


def _joints(rng, n, k, size):
    joints = (rng.rand(n, k, 2) * size * 1.1 - size * 0.05).astype(
        np.float32)
    joints[0, 2] = -1.0
    return _t(joints)


def test_stickman_on_the_cpu_takes_the_plain_path(rng):
    jm, joints = detailed_joint_model(True), _joints(rng, 6, 17, 32)
    before = SK.stickman_launches
    for normalized in (False, True):
        out = render_stickman(joints, jm, 32, 4.0, frames_per_chunk=4,
                              normalized=normalized)
        ref = render_stickman_plain(joints, jm, 32, 4.0, normalized=normalized)
        assert out.dtype == ref.dtype and torch.equal(out, ref)
    assert SK.stickman_launches == before
    with pytest.raises(ValueError):
        SK.stickman_raster(joints, jm, 32, 4.0)


@pytest.mark.parametrize("frames_per_chunk", [3, 128])
def test_stickman_normalized_is_the_bf16_vunet_input(rng, frames_per_chunk):
    jm, joints = detailed_joint_model(True), _joints(rng, 7, 17, 32)
    joints = joints.reshape(1, 7, 17, 2)
    out = render_stickman(joints, jm, 32, 4.0,
                          frames_per_chunk=frames_per_chunk, normalized=True)
    stick = render_stickman(joints, jm, 32, 4.0)
    assert out.shape == stick.shape == (1, 7, 32, 32, 3)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ((stick - 127.5) / 127.5).to(torch.bfloat16))
    assert set(out.float().unique().tolist()) <= {-1.0, -0.003936767578125,
                                                  1.0}


@pytest.mark.parametrize("model", ["h36m_world", "h36m_image", "market",
                                   "chain"])
def test_stickman_topology_table(model):
    jm = {"h36m_world": lambda: detailed_joint_model(True),
          "h36m_image": lambda: detailed_joint_model(False),
          "market": market_joint_model,
          "chain": lambda: chain_joint_model(9)}[model]()
    table, n_seg, n_body, top = SK.topology_table(jm, "cpu")
    assert SK.topology_table(jm, "cpu").table is table  # cached
    assert table.dtype == torch.int32 and table.shape == (n_seg + n_body, 4)
    rows = [tuple(r) for r in table.tolist()]
    lines = ([(SK.RIGHT, a, b, -1) for a, b in jm.right_lines]
             + [(SK.LEFT, a, b, -1) for a, b in jm.left_lines])
    if len(jm.head_lines):
        lines += [(SK.HEAD, a, b, -1) for a, b in jm.head_lines]
    else:
        lines.append((SK.NECK, jm.rshoulder, jm.lshoulder, jm.headup))
    assert rows[:n_seg] == lines
    assert rows[n_seg:] == [(SK.BODY, v, -1, -1) for v in jm.body]
    assert top == max(max(r[1:]) for r in lines + [(0, *jm.body)])
