"""The small behavior-transfer slice, built for both packages from one numpy
seed.

Shared by the PyTorch-port parity tests and ``make_torch_port_golden.py``.
Shapes follow ``tests/test_pipeline.py``: 32 px, HID 32, T 6, B 2, VUNet
nf 8->16, a 2-flow LatentFlow with mid width 64, 48 of 51 keypoints.  The
weights are drawn into the port's modules with numpy, exported as flax
trees, and those trees feed both packages.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np

S, HID, T, B = 32, 32, 6, 2
K_FULL, K_USE = 51, 48
NF_START, NF_MAX = 8, 16
FLOW_MID, N_FLOWS = 64, 2
# shapes of the appearance posterior noise, one per latent scale
NOISE_SHAPES = [(B, 4, 4, NF_MAX), (B, 8, 8, NF_MAX)]


def port_modules(decoder_arch="lstm", use_nin=False):
    from behavior_driven_video_synthesis_tpu_torch.models import (
        ResidualBehaviorNet)
    from behavior_driven_video_synthesis_tpu_torch.models.flows import (
        LatentFlow)
    from behavior_driven_video_synthesis_tpu_torch.models.vunet import VUNet

    return (ResidualBehaviorNet(K_USE, HID, decoder_arch=decoder_arch,
                                use_nin_dec=use_nin),
            VUNet(spatial_size=S, nf_start=NF_START, nf_max=NF_MAX),
            LatentFlow(HID, FLOW_MID, n_flows=N_FLOWS))


def make_slice(seed: int = 0, decoder_arch="lstm", use_nin=False):
    """(flax trees, inputs, appearance noise) from numpy seed ``seed``."""
    from behavior_driven_video_synthesis_tpu_torch.models import convert
    from behavior_driven_video_synthesis_tpu_torch.models.init import (
        init_random_)

    rng = np.random.RandomState(seed)
    pb, pv, pf = port_modules(decoder_arch, use_nin)
    for m in (pb, pv, pf):
        init_random_(m, rng)
        # float16-representable weights, so the golden file can store
        # them at half the size without changing them
        for p in m.parameters():
            p.data = p.data.half().float()
    trees = {
        "behavior": convert.behavior_net_to_flax(pb.state_dict()),
        "vunet": convert.vunet_alter_to_flax(pv.state_dict()),
        "flow": convert.latent_flow_to_flax(pf.state_dict()),
    }
    f32 = np.float32
    inputs = {
        "z": rng.randn(B, HID).astype(f32),
        "x_start": (rng.randn(B, K_USE) * 0.3).astype(f32),
        "x_source": (rng.randn(B, T, K_USE) * 0.3).astype(f32),
        "app_img": (rng.rand(B, S, S, 3) * 2 - 1).astype(f32),
        "extrinsics": np.tile(np.hstack([np.eye(3), [[0], [0], [4.0]]]),
                              (B, 1, 1)).astype(f32),
        "intrinsics": np.tile([40.0, S / 2, 40.0, S / 2], (B, 1)).astype(f32),
        "image_size": np.full((B, 2), float(S), f32),
        "norm_mean": (rng.randn(K_FULL) * 0.1).astype(f32),
        "norm_std": (np.abs(rng.rand(K_FULL)) * 0.2 + 0.1).astype(f32),
        "dim_to_use": np.arange(K_FULL)[np.arange(K_FULL) % 17 != 0][:K_USE],
    }
    noise = [rng.randn(*s).astype(f32) for s in NOISE_SHAPES]
    return trees, inputs, noise


@contextlib.contextmanager
def jax_noise(noise):
    """Make ``jax.random.normal`` return the given arrays for their shapes,
    so the JAX package draws the noise the port is handed."""
    import jax
    import jax.numpy as jnp

    orig = jax.random.normal
    by_shape = {tuple(n.shape): n for n in noise}

    def normal(key, shape=(), dtype=jnp.float32):
        n = by_shape.get(tuple(shape))
        return orig(key, shape, dtype) if n is None else jnp.asarray(n, dtype)

    with mock.patch("jax.random.normal", normal):
        yield


def jax_pipeline(decoder_arch="lstm", use_nin=False, inputs=None,
                 vunet_chunk=128):
    from behavior_driven_video_synthesis_tpu.data.human36m import (
        detailed_joint_model)
    from behavior_driven_video_synthesis_tpu.models import (
        ResidualBehaviorNet)
    from behavior_driven_video_synthesis_tpu.models.flows import LatentFlow
    from behavior_driven_video_synthesis_tpu.models.vunet import VUNet
    from behavior_driven_video_synthesis_tpu.pipeline import (
        BehaviorTransferPipeline)

    return BehaviorTransferPipeline(
        ResidualBehaviorNet(n_kps=K_USE, dim_hidden_b=HID,
                            decoder_arch=decoder_arch, use_nin_dec=use_nin),
        VUNet(spatial_size=S, nf_start=NF_START, nf_max=NF_MAX,
              variant="alter"),
        detailed_joint_model(world_coords=True), inputs["norm_mean"],
        inputs["norm_std"], inputs["dim_to_use"], spatial_size=S,
        flow_model=LatentFlow(flow_in_channels=HID,
                              flow_mid_channels=FLOW_MID, n_flows=N_FLOWS),
        vunet_chunk=vunet_chunk)


def port_pipeline(trees, inputs, decoder_arch="lstm", use_nin=False,
                  vunet_chunk=128):
    from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
        detailed_joint_model)
    from behavior_driven_video_synthesis_tpu_torch.models import convert
    from behavior_driven_video_synthesis_tpu_torch.pipeline import (
        BehaviorTransferPipeline)

    pb, pv, pf = port_modules(decoder_arch, use_nin)
    pb.load_state_dict(convert.behavior_net_from_flax(trees["behavior"]))
    pv.load_state_dict(convert.vunet_alter_from_flax(trees["vunet"]))
    pf.load_state_dict(convert.latent_flow_from_flax(trees["flow"]))
    return BehaviorTransferPipeline(
        pb, pv, detailed_joint_model(world_coords=True),
        inputs["norm_mean"], inputs["norm_std"], inputs["dim_to_use"],
        spatial_size=S, flow_model=pf, vunet_chunk=vunet_chunk)


def camera_args(inputs):
    return (inputs["app_img"], inputs["extrinsics"], inputs["intrinsics"],
            inputs["image_size"])
