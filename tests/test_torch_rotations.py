"""The port's rotation geometry, kinematics and Euler metric against the
JAX package, on the CPU.

The same numpy-seeded float32 inputs go through both packages:

  * every function of ``geometry/rotations.py`` within 1e-5 (unit-scale
    values in float32), the gimbal-lock rows (|R[0, 2]| = 1) included, and
    the expmap -> rotmat -> expmap round trip for angles below pi;
  * ``forward_kinematics`` (expmap and Euler) and
    ``revert_coordinate_space`` within 1e-3 mm of joint positions up to
    ~5 m from the origin (float32 rounds 4096 mm to 4.9e-4) and 1e-5 of the
    channels;
  * ``mse_euler_per_action`` within 1e-5 relative;
  * a Human3.6M dataset with ``keypoint_type: angle_world_expmap`` and
    stickmen from 3D draws the stickman of the JAX dataset's own calls on
    the 32 joints, exactly (the JAX dataset itself fails there, ROADMAP
    C14).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.data.human36m import (
    Human36mDataset as JaxHuman36m)
from behavior_driven_video_synthesis_tpu.geometry import kinematics as jkin
from behavior_driven_video_synthesis_tpu.geometry import rotations as jrot
from behavior_driven_video_synthesis_tpu.metrics.sequence import (
    mse_euler_per_action as jmse_euler)

from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
    Human36mDataset)
from behavior_driven_video_synthesis_tpu_torch.geometry import kinematics
from behavior_driven_video_synthesis_tpu_torch.geometry import rotations
from behavior_driven_video_synthesis_tpu_torch.metrics.sequence import (
    mse_euler_per_action)

from torch_port_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5          # unit-scale rotation values in float32
MM_ATOL = 1e-3       # joint positions in mm, up to ~5000 mm


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(mine, ref, atol=ATOL):
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


def _locked():
    """Rotation matrices with R[0, 2] = -1 and +1 exactly (gimbal lock)."""
    mats = []
    for s, phi in ((-1.0, 0.3), (1.0, -1.2), (-1.0, 2.9)):
        c, n = np.cos(phi), np.sin(phi)
        mats.append([[0.0, 0.0, s], [c, n, 0.0], [-s * n, s * c, 0.0]])
    return np.asarray(mats, np.float32)


@pytest.fixture(scope="module")
def mats():
    rng = np.random.RandomState(0)
    angles = rng.uniform(-80, 80, (4, 5, 3)).astype(np.float32)
    R = np.asarray(jrot.euler_to_rotmat(jnp.asarray(angles)))
    return angles, np.concatenate([R.reshape(-1, 3, 3), _locked()])


@pytest.mark.parametrize("order", ["zxy", "xyz"])
@pytest.mark.parametrize("deg", [True, False])
def test_euler_to_rotmat_matches_jax(mats, order, deg):
    angles = mats[0] if deg else np.deg2rad(mats[0]).astype(np.float32)
    _close(rotations.euler_to_rotmat(_t(angles), deg=deg, order=order),
           jrot.euler_to_rotmat(jnp.asarray(angles), deg=deg, order=order))


def test_rotmat_to_euler_matches_jax_with_gimbal_lock(mats):
    R = mats[1]
    out = rotations.rotmat_to_euler(_t(R))
    _close(out, jrot.rotmat_to_euler(jnp.asarray(R)))
    # the locked rows: third angle 0, second -+pi/2 by the sign of R[0, 2]
    locked = out[-3:].numpy()
    np.testing.assert_array_equal(locked[:, 2], 0.0)
    np.testing.assert_allclose(locked[:, 1], -np.pi / 2 * R[-3:, 0, 2],
                               atol=ATOL)


def test_quaternions_and_expmaps_match_jax(mats):
    R = mats[1]
    q = rotations.rotmat_to_quat(_t(R))
    _close(q, jrot.rotmat_to_quat(jnp.asarray(R)))
    _close(rotations.quat_to_expmap(q),
           jrot.quat_to_expmap(jnp.asarray(q.numpy())))
    _close(rotations.rotmat_to_expmap(_t(R)),
           jrot.rotmat_to_expmap(jnp.asarray(R)))


def test_expmap_round_trip_and_rodrigues_match_jax():
    rng = np.random.RandomState(1)
    axis = rng.randn(3, 7, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    r = (axis * rng.uniform(0.05, 3.0, (3, 7, 1))).astype(np.float32)
    R = rotations.expmap_to_rotmat(_t(r))
    _close(R, jrot.expmap_to_rotmat(jnp.asarray(r)))
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), R.shape)
    np.testing.assert_allclose((R @ R.transpose(-1, -2)).numpy(), eye,
                               atol=ATOL)
    _close(rotations.rotmat_to_expmap(R), r, atol=1e-4)


def _expmap_channels(rng, shape, scale=0.4):
    a = rng.randn(*shape, 99).astype(np.float32) * scale
    a[..., :3] = rng.randn(*shape, 3) * 200.0 + [0.0, 0.0, 4000.0]
    return a.astype(np.float32)


def test_forward_kinematics_expmap_matches_jax():
    a = _expmap_channels(np.random.RandomState(2), (2, 3))
    for use_pos in (True, False):
        _close(kinematics.forward_kinematics(_t(a), use_pos=use_pos),
               jkin.forward_kinematics(jnp.asarray(a), use_pos=use_pos),
               atol=MM_ATOL)


def test_forward_kinematics_euler_matches_jax():
    a = np.random.RandomState(3).uniform(-60, 60, (5, 78)).astype(np.float32)
    out = kinematics.forward_kinematics(_t(a), use_euler=True)
    assert out.shape == (5, 32, 3)
    _close(out, jkin.forward_kinematics(jnp.asarray(a), use_euler=True),
           atol=MM_ATOL)


def test_revert_coordinate_space_matches_jax():
    rng = np.random.RandomState(4)
    ch = _expmap_channels(rng, (9,), scale=0.3)
    ch[:, :3] = rng.randn(9, 3) * 20.0
    R0 = np.asarray(jrot.expmap_to_rotmat(jnp.asarray(
        rng.randn(3).astype(np.float32) * 0.5)))
    T0 = rng.randn(3).astype(np.float32) * 10.0
    for args in ((), (R0, T0)):
        mine = kinematics.revert_coordinate_space(
            _t(ch), *(_t(x) for x in args))
        ref = np.asarray(jkin.revert_coordinate_space(
            jnp.asarray(ch), *(jnp.asarray(x) for x in args)))
        # the translation accumulates in mm over 9 frames; the rest is
        # expmaps and the untouched channels
        _close(mine[:, :3], ref[:, :3], atol=MM_ATOL)
        _close(mine[:, 3:], ref[:, 3:], atol=1e-4)
        np.testing.assert_array_equal(mine[:, 6:].numpy(), ch[:, 6:])


def test_mse_euler_per_action_matches_jax():
    rng = np.random.RandomState(5)
    gt = _expmap_channels(rng, (6, 4), scale=0.5)
    pred = gt + rng.randn(*gt.shape).astype(np.float32) * 0.05
    actions = np.array([2, 4, 2, 7, 4, 2])
    mine = mse_euler_per_action(_t(pred), _t(gt), torch.from_numpy(actions))
    ref = jmse_euler(pred, gt, actions)
    assert mine.keys() == ref.keys() == {2, 4, 7}
    for a in ref:
        assert np.isclose(mine[a], ref[a], rtol=1e-5, atol=0), (
            a, mine[a], ref[a])


def _angle_columns(rng, n_per_video=12):
    """Human3.6M-like columns with expmap joint angles: 2 subjects x 2
    train actions, one camera 1000 x 1000 looking down +z, the root ~4 m
    in front of it (mm, as the H3.6M angles are)."""
    cols = {k: [] for k in ("angle_world_expmap", "p_ids", "f_ids",
                            "action", "subaction", "camera_id",
                            "image_size", "intrinsics_univ",
                            "extrinsics_univ", "img_paths")}
    vid = 0
    for pid in (1, 5):
        for act in (2, 4):
            t = np.arange(n_per_video)[:, None]
            a = np.tile(rng.randn(1, 99) * 0.3, (n_per_video, 1))
            a += 0.1 * np.sin(0.3 * t + rng.uniform(0, 6, (1, 99)))
            a[:, :3] = [rng.randn() * 100, 200.0, 4000.0] + 20.0 * t
            n = n_per_video
            cols["angle_world_expmap"].append(a.astype(np.float32))
            cols["p_ids"].append(np.full(n, pid))
            cols["f_ids"].append(np.arange(n) + 1)
            cols["action"].append(np.full(n, act))
            cols["subaction"].append(np.full(n, 1))
            cols["camera_id"].append(np.full(n, 54138969))
            cols["image_size"].append(np.tile([1000, 1000], (n, 1)))
            cols["intrinsics_univ"].append(
                np.tile([1145.0, 500.0, 1143.0, 500.0], (n, 1)))
            cols["extrinsics_univ"].append(np.tile(
                np.hstack([np.eye(3), np.zeros((3, 1))]), (n, 1, 1)))
            cols["img_paths"].append(np.asarray(
                [f"video_{vid}/frame_{i:06d}.jpg" for i in range(n)]))
            vid += 1
    return {k: np.concatenate(v) for k, v in cols.items()}


def test_stickman_from_joint_angles_equals_jax():
    """The JAX dataset keeps 17 of the 32 joints before drawing with a
    joint model numbered over 32 and fails (ROADMAP C14); the port draws
    all 32, which is the JAX dataset's own chain of calls (unnormalize,
    ``forward_kinematics``, the projection, ``make_joint_img``) on them."""
    from behavior_driven_video_synthesis_tpu.geometry.normalization import (
        unnormalize as junnormalize)
    from behavior_driven_video_synthesis_tpu.geometry.stickman import (
        make_joint_img as jmake_joint_img)

    cols = _angle_columns(np.random.RandomState(6))
    kw = dict(keypoint_type="angle_world_expmap", use_3d_for_stickman=True,
              train_synthesis=True, spatial_size=64, stickman_scale=16)
    mine = Human36mDataset(None, ["stickman"], (0, 0), **kw)
    ref = JaxHuman36m(None, ["stickman"], (0, 0), **kw)
    mine.populate_from_arrays(cols)
    ref.populate_from_arrays(cols)
    assert len(mine) == len(ref) > 0
    with pytest.raises(IndexError):
        ref._output_dict["stickman"]([0])
    ids = [0, 7, len(ref) - 1]
    want = []
    for i in ids:
        full = np.asarray(junnormalize(
            ref.datadict["angle_world_expmap"][i][None], ref.norm_stats))
        xyz = np.asarray(jkin.forward_kinematics(full))[0] / 1000.0
        img = jmake_joint_img((64, 64, 3), ref._project_to_pixels(i, xyz),
                              ref.joint_model, line_colors=ref.line_colors,
                              scale_factor=ref.stickman_scale)
        want.append(ref._to_float(img))
    got = np.asarray(mine._output_dict["stickman"](ids))
    assert got.shape == (3, 64, 64, 3)
    assert (got > -1).mean() > 0.01                    # something drawn
    np.testing.assert_array_equal(got, np.stack(want))
