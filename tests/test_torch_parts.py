"""The port's in-plane part stacks against the JAX package's, on the CPU.

The homography builders (``t5p``, ``t4p``, ``t3p``, ``t2p``) against the
JAX ones, which call OpenCV's ``getPerspectiveTransform``, to 1e-6
relative, with their fallbacks; the device warp and its plain numpy
version against JAX ``normalize_parts`` on one uint8 image, and the whole
in-plane stack of a small synthetic dataset against JAX
``normalize_parts`` on the port's own renders: within 1 uint8 level at
>= 99.9 % of values and never more than 8 apart.
"""
from functools import partial

import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu.data import deepfashion as jdf
from behavior_driven_video_synthesis_tpu.data import parts as jparts

from behavior_driven_video_synthesis_tpu_torch.data import parts
from behavior_driven_video_synthesis_tpu_torch.data.deepfashion import (
    deepfashion_joint_model)
from behavior_driven_video_synthesis_tpu_torch.data.synthetic_images import (
    SyntheticImageDataset)

JM = deepfashion_joint_model()
JJM = jdf.deepfashion_joint_model()
S, PART = 64, 16


def _jax_fn(fn):
    """The JAX builder of the port's ``fn`` (a function or a partial)."""
    if isinstance(fn, partial):
        return partial(getattr(jparts, fn.func.__name__), **fn.keywords)
    return getattr(jparts, fn.__name__)


def _keypoints(seed):
    return np.random.RandomState(seed).uniform(8, S - 8, (18, 2))


def _close(mine, ref):
    if ref is None:
        assert mine is None
        return
    np.testing.assert_allclose(mine, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


def check_stack(mine, ref):
    """Within 1 level at >= 99.9 % of values, none more than 8 apart."""
    d = np.abs(np.asarray(mine, int) - np.asarray(ref, int))
    assert mine.shape == ref.shape and mine.dtype == np.uint8
    assert (d <= 1).mean() >= 0.999 and d.max() <= 8, (
        (d <= 1).mean(), d.max())


@pytest.mark.parametrize("seed", range(6))
def test_homographies_match_jax(seed):
    kps = _keypoints(seed)
    for fn in JM.norm_T:
        _close(fn(kps, jm=JM, wh=(PART, PART), oh=S),
               _jax_fn(fn)(kps, jm=JJM, wh=(PART, PART), oh=S))
    # t5p on the detailed body, as the Human3.6M joint model has it
    jm5 = JM.__class__(**{**JM.__dict__, "body": [8, 2, 1, 5, 11]})
    _close(parts.t5p(kps, jm5, (PART, PART), S),
           jparts.t5p(kps, jm5, (PART, PART), S))


def test_homography_fallbacks_match_jax():
    kps = _keypoints(7)
    wh = (PART, PART)
    # t5p: shoulders parallel to a hip-shoulder line -> None
    flat = kps.copy()
    flat[[8, 2, 1, 5, 11]] = [[10, 40], [10, 10], [20, 10], [30, 10],
                              [30, 40]]
    flat[2] = [10, 10]
    flat[5] = [10, 10]
    jm5 = JM.__class__(**{**JM.__dict__, "body": [8, 2, 1, 5, 11]})
    assert jparts.t5p(flat, jm5, wh, S) is None
    assert parts.t5p(flat, jm5, wh, S) is None
    # t3p: an invalid head point -> the shoulder segment
    head = kps.copy()
    head[JM.headup] = -1.0
    _close(parts.t3p(head, JM, wh, S), jparts.t3p(head, JJM, wh, S))
    no_shoulder = head.copy()
    no_shoulder[JM.rshoulder] = -1.0
    assert parts.t3p(no_shoulder, JM, wh, S) is None
    assert jparts.t3p(no_shoulder, JJM, wh, S) is None
    # t2p: one leg point invisible -> the visible one down to row oh - 1
    for hidden in (9, 10):
        leg = kps.copy()
        leg[hidden] = 0.0
        _close(parts.t2p(leg, [9, 10], wh, S), jparts.t2p(leg, [9, 10],
                                                          wh, S))
    leg = kps.copy()
    leg[[9, 10]] = 0.0
    assert parts.t2p(leg, [9, 10], wh, S) is None
    assert jparts.t2p(leg, [9, 10], wh, S) is None
    # the destination square carries the -1 offset
    T = parts.t2p(kps, [9, 10], wh, S)
    p = T @ np.append(kps[9] + 0.25 * np.array(
        [-(kps[10] - kps[9])[1], (kps[10] - kps[9])[0]]), 1.0)
    np.testing.assert_allclose(p[:2] / p[2], [-1.0, -1.0], atol=1e-4)


def test_warp_matches_jax_normalize_parts():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (S, S, 3)).astype(np.uint8)
    kps = _keypoints(3)
    kps[4] = 0.0                       # one limb takes its fallback
    ref = jparts.normalize_parts(img, kps, JJM, PART)
    mats, valid = parts.part_transforms([kps], JM, PART, S)
    device = parts.warp_parts(torch.from_numpy(img)[None], mats, valid,
                              PART)[0].numpy()
    plain = parts.warp_parts_plain(img[None], mats, valid, PART)[0]
    check_stack(device, ref)
    check_stack(plain, ref)
    # an undefined part is black in both
    kps[[5, 6]] = -1.0
    mats, valid = parts.part_transforms([kps], JM, PART, S)
    assert not valid[0, 4]
    out = parts.warp_parts(torch.from_numpy(img)[None], mats, valid, PART)
    assert not out[0, :, :, 12:15].any()
    check_stack(out[0].numpy(), jparts.normalize_parts(img, kps, JJM, PART))


def test_synthetic_stack_matches_jax_on_the_port_renders():
    ds = SyntheticImageDataset(n_persons=3, frames_per_person=4,
                               spatial_size=S, inplane_normalize=True,
                               box_factor=2)
    renders = ((ds.photos + 1) * 127.5).round().to(torch.uint8).numpy()
    stacks = ((ds.apps + 1) * 127.5).round().to(torch.uint8).numpy()
    assert stacks.shape == (ds.n, PART, PART, 30)
    ref = np.stack([jparts.normalize_parts(renders[i],
                                           ds.norm_keypoints[i] * S, JJM,
                                           PART) for i in range(ds.n)])
    check_stack(stacks, ref)
    mats, valid = parts.part_transforms(ds.norm_keypoints * S, JM, PART, S)
    check_stack(parts.warp_parts_plain(renders, mats, valid, PART), ref)
    # a batch's appearance is the stack of its map_ids frame
    batch = next(ds.batches(4, seed=2))
    ids = ds.map_ids[batch["sample_ids"].numpy()]
    torch.testing.assert_close(batch["app_img"], ds.apps[ids])
