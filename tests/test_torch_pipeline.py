"""The PyTorch port's behavior-transfer slice against the JAX pipeline.

Same weights (numpy-seeded, passed through the port's converters), same
inputs and the same appearance noise go through both packages' generate
and reenact on the CPU in f32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_slice import (B, S, T, camera_args, jax_noise, jax_pipeline,
                              make_slice, port_pipeline)


def _np(v):
    return np.asarray(v.float() if isinstance(v, torch.Tensor) else v,
                      np.float32)


def _check_outputs(port, ref, port_pipe, inputs, noise):
    np.testing.assert_allclose(_np(port["poses_3d"]), _np(ref["poses_3d"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(port["keypoints_2d"]),
                               _np(ref["keypoints_2d"]), atol=1e-2, rtol=0)
    stick_p, stick_r = _np(port["stickman"]), _np(ref["stickman"])
    assert np.mean(np.any(stick_p != stick_r, axis=-1)) <= 1e-3
    # the port's VUNet on the JAX stickman isolates the synthesis stage
    means, _ = port_pipe.vunet.encode_means(
        torch.from_numpy(inputs["app_img"]),
        [torch.from_numpy(n) for n in noise])
    frames_r = _np(ref["frames"])
    with torch.inference_mode():
        frames_p = port_pipe.vunet.transfer_cached(
            [torch.repeat_interleave(m, T, dim=0) for m in means],
            torch.from_numpy(stick_r.reshape((B * T,) + stick_r.shape[2:])))
    np.testing.assert_allclose(_np(frames_p).reshape(frames_r.shape),
                               frames_r, rtol=0,
                               atol=1e-4 * (1 + np.abs(frames_r).max()))
    # end to end, stickman mismatches included
    assert np.mean(np.abs(_np(port["frames"]) - frames_r)) <= 1e-3


@pytest.fixture(scope="module")
def slice_():
    trees, inputs, noise = make_slice(0)
    return trees, inputs, noise, port_pipeline(trees, inputs)


def test_generate_matches_jax(slice_):
    trees, inputs, noise, pipe = slice_
    key = jax.random.PRNGKey(0)
    with jax_noise(noise):
        ref = jax_pipeline(inputs=inputs).generate(
            trees, jnp.asarray(inputs["z"]),
            jnp.asarray(inputs["x_start"]), *camera_args(inputs), key,
            length=T)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    port = pipe.generate(inputs["z"], inputs["x_start"],
                         *camera_args(inputs), length=T,
                         eps=[torch.from_numpy(n) for n in noise])
    assert port["frames"].shape == (B, T, S, S, 3)
    assert port["poses_3d"].shape == (B, T, 17, 3)
    assert np.isfinite(_np(port["frames"])).all()
    _check_outputs(port, ref, pipe, inputs, noise)


def test_reenact_matches_jax(slice_):
    trees, inputs, noise, pipe = slice_
    key = jax.random.PRNGKey(1)
    with jax_noise(noise):
        ref = jax_pipeline(inputs=inputs).reenact(
            trees, jnp.asarray(inputs["x_source"]),
            jnp.asarray(inputs["x_start"]), *camera_args(inputs), key,
            length=T)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    port = pipe.reenact(inputs["x_source"], inputs["x_start"],
                        *camera_args(inputs), length=T,
                        eps=[torch.from_numpy(n) for n in noise])
    _check_outputs(port, ref, pipe, inputs, noise)


@pytest.mark.parametrize("arch,nin,kernel_path", [
    ("lstm", False, True), ("lstm", True, False), ("gru", False, False)])
def test_rollout_kernel_routing(monkeypatch, arch, nin, kernel_path):
    """The rollout wrapper is taken exactly where the JAX pipeline takes
    its Pallas kernel: LSTM decoders without nin."""
    from behavior_driven_video_synthesis_tpu_torch import pipeline as P

    trees, inputs, noise = make_slice(1, decoder_arch=arch, use_nin=nin)
    pipe = port_pipeline(trees, inputs, decoder_arch=arch, use_nin=nin)
    calls = []
    real = P.decoder_rollout_kernel

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(P, "decoder_rollout_kernel", spy)
    assert pipe.use_rollout_kernel == kernel_path
    pipe.generate(inputs["z"], inputs["x_start"], *camera_args(inputs),
                  length=2, eps=[torch.from_numpy(n) for n in noise])
    assert len(calls) == int(kernel_path)


def test_chunk_size_table():
    trees, inputs, _ = make_slice(0)
    table = {(5, 12): (4, 12), (128, 12): (12, 12), (8, 13): (8, 16),
             (4, 14): (4, 16), (128, 1000): (125, 1000),
             (128, 150): (75, 150), (128, 129): (128, 256)}
    for (chunk, n), want in table.items():
        pipe = port_pipeline(trees, inputs, vunet_chunk=chunk)
        ref = jax_pipeline(inputs=inputs, vunet_chunk=chunk)
        assert pipe._chunk_size(n) == ref._chunk_size(n) == want, (chunk, n)


@pytest.mark.parametrize("chunk", [4, 5])
def test_chunked_matches_unchunked(slice_, chunk):
    """Chunked VUNet stage against one batch: B*T = 12 frames split into
    exact chunks (4 divides 12; for chunk 5 the divisor 4 is taken) and,
    at T+1 (14 frames), into zero-padded chunks."""
    trees, inputs, noise, _ = slice_
    eps = [torch.from_numpy(n) for n in noise]
    for length in (T, T + 1):
        outs = [port_pipeline(trees, inputs, vunet_chunk=c).generate(
            inputs["z"], inputs["x_start"], *camera_args(inputs),
            length=length, eps=eps)["frames"] for c in (chunk, 128)]
        np.testing.assert_allclose(_np(outs[0]), _np(outs[1]), atol=1e-5,
                                   rtol=1e-5)
