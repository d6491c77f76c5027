"""The bilinear VUNet upsample (``architecture.subpixel_upsampling:
false``) against the JAX package, on the CPU.

  * ``Upsample(subpixel=False)`` (a 3x3 NormConv2d to ``features``, then a
    2x bilinear resize with half-pixel centres) equals JAX ``Upsample`` on
    the same weights within 1e-5 relative (atol 1e-6, f32), the border rows
    and columns included, and ``F.interpolate`` equals
    ``jax.image.resize(..., "bilinear")`` at 2x;
  * alter and org VUNets with ``subpixel_upsampling: false`` (32 px, nf
    8->16: the decoder's third upsample is bilinear) carry the (3, 3, cin,
    C) kernel of that variant through the converters and agree with JAX in
    ``encode_means`` and ``transfer_cached`` within 1e-4 * (1 + max|ref|);
  * one ``bdvs-train-torch`` step of such a cvbae run writes a
    ``synth.npz`` that one ``bdvs-generate-torch`` request serves.
"""
import json
import os
from functools import partial

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

import jax
import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.models.vunet import VUNet as JVUNet
from behavior_driven_video_synthesis_tpu.ops import nn as jnn

from behavior_driven_video_synthesis_tpu_torch import generate, main
from behavior_driven_video_synthesis_tpu_torch.core.config import (
    deep_merge, load_config)
from behavior_driven_video_synthesis_tpu_torch.models import convert
from behavior_driven_video_synthesis_tpu_torch.models.behavior import (
    ResidualBehaviorNet)
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.vunet import VUNet
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn

from torch_port_slice import jax_noise
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, NF0, NF1, B = 32, 8, 16, 2


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=0,
                               atol=1e-4 * (1 + np.abs(ref).max()))


def test_bilinear_resize_matches_jax_at_the_borders():
    x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3),
                                      method="bilinear"))
    out = F.interpolate(_t(x).permute(0, 3, 1, 2), scale_factor=2,
                        mode="bilinear", align_corners=False
                        ).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    # half-pixel centres renormalised at the edge: the outer rows and
    # columns repeat the border pixels
    np.testing.assert_allclose(out[:, 0, 0], x[:, 0, 0], rtol=1e-6)
    np.testing.assert_allclose(out[:, -1, -1], x[:, -1, -1], rtol=1e-6)


def test_upsample_without_subpixel_matches_jax():
    rng = np.random.RandomState(1)
    up = init_random_(pnn.Upsample(6, 4, subpixel=False), rng)
    assert up.up.conv.weight_v.shape == (4, 6, 3, 3)
    tree = convert.to_flax(up.state_dict(),
                           convert._norm_conv("up", ("NormConv2d_0",)))
    x = rng.randn(2, 5, 6, 6).astype(np.float32)
    ref = jnn.Upsample(features=4, subpixel=False).apply(
        {"params": tree}, jnp.asarray(x))
    out = up(_t(x))
    assert out.shape == ref.shape == (2, 10, 12, 4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", ["alter", "org"])
def test_vunet_without_subpixel_matches_jax(variant):
    rng = np.random.RandomState(2)
    arch = dict(spatial_size=S, nf_start=NF0, nf_max=NF1, variant=variant,
                subpixel_upsampling=False)
    if variant == "org":
        arch.update(n_channels_x=30, box_factor=1)
    net = init_random_(VUNet(**arch), rng)
    to_flax = (convert.vunet_org_to_flax if variant == "org"
               else convert.vunet_alter_to_flax)
    from_flax = (convert.vunet_org_from_flax if variant == "org"
                 else convert.vunet_alter_from_flax)
    tree = to_flax(net.state_dict())
    # the decoder's last upsample (16 -> 32 px) is bilinear: a 3x3 conv
    # from 16 to 8 channels, (3, 3, 16, 8) in flax, where a subpixel one
    # has 4x the outputs
    ups = {n: (m.subpixel, tuple(m.up.conv.weight_v.shape))
           for n, m in net.named_modules() if isinstance(m, pnn.Upsample)}
    assert ups["dd.ups.2"] == (False, (8, 16, 3, 3))
    assert all(sub for n, (sub, _) in ups.items() if n != "dd.ups.2")
    assert tree["dd"]["Upsample_2"]["NormConv2d_0"]["v"].shape == (
        3, 3, 16, 8)
    back = from_flax(tree)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)

    jnet = JVUNet(**arch)
    hw, cx = (S // 2, 30) if variant == "org" else (S, 3)
    x = (rng.rand(B, hw, hw, cx) * 2 - 1).astype(np.float32)
    c = (rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
    noise = [rng.randn(B, 4, 4, NF1).astype(np.float32),
             rng.randn(B, 8, 8, NF1).astype(np.float32)]

    def jax_call(method, *args, draws=()):
        fn = jax.jit(partial(jnet.apply, method=method))
        with jax_noise(list(draws)):
            return fn({"params": tree},
                      *jax.tree_util.tree_map(jnp.asarray, args),
                      rngs={"sample": jax.random.PRNGKey(0)})

    jmeans, _ = jax_call("encode_means", x, draws=noise)
    jframes = jax_call("transfer_cached", [np.asarray(m) for m in jmeans], c)
    with torch.no_grad():
        means, _ = net.encode_means(_t(x), [_t(n) for n in noise])
        frames = net.transfer_cached(means, _t(c))
    for a, b in zip(means, jmeans):
        _close(a, b)
    assert frames.shape == (B, S, S, 3)
    _close(frames, jframes)


def test_train_one_step_then_serve(tmp_path):
    cfg = load_config(os.path.join(REPO, "configs",
                                   "shape_and_pose_net.yaml"))
    cfg = deep_merge(cfg, {
        "general": {"base_dir": str(tmp_path / "runs"),
                    "project_name": "tiny"},
        "data": {"spatial_size": S, "n_persons": 2, "frames_per_person": 2},
        "architecture": {"nf_start": 4, "nf_max": 8,
                         "subpixel_upsampling": False},
        "training": {"batch_size": 2, "end_iteration": 1, "bf16": False},
        "metrics": {"n_it_metrics": 1000},
        "logging": {"ckpt_steps": 1000, "log_steps": 1000}})
    path = tmp_path / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = main.main(["-c", str(path), "--device", "cpu"])
    assert out["state"].step == 1
    ups = [m for m in out["vunet"].modules() if isinstance(m, pnn.Upsample)]
    assert any(not m.subpixel for m in ups)

    behavior = init_random_(ResidualBehaviorNet(48, 16),
                            np.random.RandomState(0))
    convert.save_flax_npz(str(tmp_path / "behavior.npz"), {
        "net": convert.behavior_net_to_flax(behavior.state_dict())})
    with open(tmp_path / "behavior.json", "w") as f:
        json.dump({"architecture": {"dim_hidden_b": 16}}, f)
    man = generate.main(["--behavior_params", str(tmp_path / "behavior.npz"),
                         "--synth_params", out["synth_params"],
                         "--length", "3", "--batch", "2", "--device", "cpu",
                         "--out", str(tmp_path / "served")])
    assert man["spatial"] == S and len(man["videos"]) == 2
