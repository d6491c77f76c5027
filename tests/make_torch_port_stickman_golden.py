"""Write tests/golden/torch_port_stickman_small.npz: the JAX package's
device stickman raster on fixed joints, with the VUNet input the JAX
pipeline makes of it.

    JAX_PLATFORMS=cpu python tests/make_torch_port_stickman_golden.py

``tests/test_torch_kernels_gpu.py`` holds the port's raster kernel on the
GPU against this file and needs no JAX to read it;
``tests/test_torch_geometry.py`` checks that it still equals a live JAX run.

Keys: ``cases`` (a JSON list of ``{"name", "model", "S", "thickness"}``,
uint8), and for each case ``<name>/joints`` (frames, K, 2) f32,
``<name>/stick`` the raster (frames, S, S, 3) as uint8 (its values are 0,
127 and 255) and ``<name>/normalized`` the pipeline's ``(stick / 127.5 -
1).astype(bfloat16)`` as its uint16 bit patterns.
"""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from behavior_driven_video_synthesis_tpu.data.deepfashion import (  # noqa: E402
    deepfashion_joint_model)
from behavior_driven_video_synthesis_tpu.data.human36m import (  # noqa: E402
    detailed_joint_model)
from behavior_driven_video_synthesis_tpu.data.market import (  # noqa: E402
    market_joint_model)
from behavior_driven_video_synthesis_tpu.generate import (  # noqa: E402
    chain_joint_model)
from behavior_driven_video_synthesis_tpu.geometry.stickman import (  # noqa: E402
    render_stickman)

OUT = os.path.join(HERE, "golden", "torch_port_stickman_small.npz")
# model name -> (JAX joint model, joints a frame)
MODELS = {"h36m_world": (lambda: detailed_joint_model(True), 17),
          "h36m_image": (lambda: detailed_joint_model(False), 32),
          "market": (market_joint_model, 18),
          "deepfashion": (deepfashion_joint_model, 18),
          "chain": (lambda: chain_joint_model(9), 9)}
# the served raster (the detailed H36M model in world coordinates, 256 px,
# thickness 4) and the other joint models, sizes and thicknesses
CASES = [dict(name="h36m_world_s256_t4", model="h36m_world", S=256,
              thickness=4.0, frames=16),
         dict(name="h36m_world_s128_t1", model="h36m_world", S=128,
              thickness=1.0, frames=8),
         dict(name="h36m_image_s128_t5", model="h36m_image", S=128,
              thickness=5.0, frames=8),
         dict(name="market_s64_t4", model="market", S=64, thickness=4.0,
              frames=8),
         dict(name="deepfashion_s64_t5", model="deepfashion", S=64,
              thickness=5.0, frames=8),
         dict(name="chain_s64_t1", model="chain", S=64, thickness=1.0,
              frames=8)]
SEED = 23


def golden_joints(frames, K, S, seed):
    """frames of K joints, some outside the image, with invalid joints, a
    degenerate segment, a joint far past the image and a frame whose body
    has fewer than 3 valid vertices."""
    rng = np.random.RandomState(seed)
    j = rng.rand(frames, K, 2) * S * 1.3 - S * 0.15
    j[rng.rand(frames, K) < 0.08] = -1.0
    j[1, 1] = j[1, 0]
    j[2, 0] = [7e4, S * 0.5]
    j[3, :K // 2] = -1.0
    return j.astype(np.float32)


def render(case, joints):
    """The JAX raster of ``joints`` and the pipeline's bf16 VUNet input,
    jitted as the JAX pipeline runs them."""
    jm = MODELS[case["model"]][0]()

    @jax.jit
    def run(j):
        stick = render_stickman(j, jm, case["S"],
                                thickness=case["thickness"])
        return stick, (stick / 127.5 - 1.0).astype(jnp.bfloat16)
    stick, normalized = run(jnp.asarray(joints))
    return np.asarray(stick), np.asarray(normalized).view(np.uint16)


def main():
    jax.config.update("jax_platforms", "cpu")
    out = {"cases": np.frombuffer(json.dumps(
        [{k: c[k] for k in ("name", "model", "S", "thickness")}
         for c in CASES]).encode(), np.uint8)}
    for i, case in enumerate(CASES):
        joints = golden_joints(case["frames"], MODELS[case["model"]][1],
                               case["S"], SEED + i)
        stick, normalized = render(case, joints)
        assert set(np.unique(stick)) <= {0.0, 127.0, 255.0}
        out[f"{case['name']}/joints"] = joints
        out[f"{case['name']}/stick"] = stick.astype(np.uint8)
        out[f"{case['name']}/normalized"] = normalized
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
