"""Write tests/golden/torch_port_org_small.npz: a small original VUNet's
(variant "org") weights, inputs, noise and JAX-package outputs.

    JAX_PLATFORMS=cpu python tests/make_torch_port_org_golden.py

The VUNet is 32 px, nf 4->8, with a 30-channel part-stack appearance at
16x16 (box_factor 1), numpy-seeded weights made float16-representable.  The
JAX ``VUNet(variant="org")`` computes, on the CPU in f32, with every normal
draw replaced by the stored noise: ``encode_means`` of the appearance,
``transfer_cached`` from those means, and ``test_forward`` (the
autoregressive prior).  ``chip_smoke.py`` holds the PyTorch port on the
GPU against this file and needs no JAX to read it;
``tests/test_torch_vunet_org.py`` checks that it still equals a live JAX
run.

Keys: ``config`` (the VUNet's arguments, JSON bytes),
``params/vunet/...`` (the flax tree, "/"-joined, in float16),
``inputs/{x,c}``, ``noise/posterior/<i>`` (one per latent scale),
``noise/prior/<i>/<group>`` (four groups per latent scale), and
``outputs/{means/<i>,transfer_cached,test_forward}``.
"""
import contextlib
import json
import os
import sys
from functools import partial
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

OUT = os.path.join(HERE, "golden", "torch_port_org_small.npz")
S, NF_START, NF_MAX, B, CX = 32, 4, 8, 2, 30
ARCH = dict(spatial_size=S, n_channels_x=CX, nf_start=NF_START,
            nf_max=NF_MAX, box_factor=1, variant="org")
POSTERIOR = [(B, 4, 4, NF_MAX), (B, 8, 8, NF_MAX)]   # one draw a scale
PRIOR = [(B, 2, 2, NF_MAX), (B, 4, 4, NF_MAX)]       # four groups a scale


@contextlib.contextmanager
def jax_draws(draws):
    """``jax.random.normal`` returns the given arrays of each shape in
    turn (a real draw once they run out)."""
    import jax
    import jax.numpy as jnp

    orig = jax.random.normal
    queues = {}
    for d in draws:
        queues.setdefault(tuple(d.shape), []).append(d)

    def normal(key, shape=(), dtype=jnp.float32):
        q = queues.get(tuple(shape))
        return jnp.asarray(q.pop(0), dtype) if q else orig(key, shape, dtype)

    with mock.patch("jax.random.normal", normal):
        yield


def make_inputs(seed: int = 0):
    """(flax tree, inputs, posterior noise, prior noise) from a numpy seed."""
    from behavior_driven_video_synthesis_tpu_torch.models import convert
    from behavior_driven_video_synthesis_tpu_torch.models.init import (
        init_random_)
    from behavior_driven_video_synthesis_tpu_torch.models.vunet import VUNet

    rng = np.random.RandomState(seed)
    net = init_random_(VUNet(**ARCH), rng)
    for p in net.parameters():
        p.data = p.data.half().float()
    tree = convert.vunet_org_to_flax(net.state_dict())
    f32 = np.float32
    inputs = {"x": (rng.rand(B, S // 2, S // 2, CX) * 2 - 1).astype(f32),
              "c": (rng.rand(B, S, S, 3) * 2 - 1).astype(f32)}
    post = [rng.randn(*s).astype(f32) for s in POSTERIOR]
    prior = [[rng.randn(*s).astype(f32) for _ in range(4)] for s in PRIOR]
    return tree, inputs, post, prior


def jax_outputs(tree, inputs, post, prior):
    """The JAX org VUNet's means, transfer_cached frames and test_forward
    samples in f32 on the CPU."""
    import jax
    import jax.numpy as jnp

    from behavior_driven_video_synthesis_tpu.models.vunet import VUNet

    net = VUNet(**ARCH)

    def run(method, *args, draws=()):
        fn = jax.jit(partial(net.apply, method=method))
        with jax_draws(draws):
            return fn({"params": tree}, *args,
                      rngs={"sample": jax.random.PRNGKey(0)})
    means, _ = run("encode_means", jnp.asarray(inputs["x"]), draws=post)
    frames = run("transfer_cached", list(means), jnp.asarray(inputs["c"]))
    sample = run("test_forward", jnp.asarray(inputs["c"]),
                 draws=[g for groups in prior for g in groups])
    return {"means": {str(i): np.asarray(m) for i, m in enumerate(means)},
            "transfer_cached": np.asarray(frames),
            "test_forward": np.asarray(sample)}


def golden_arrays(seed: int = 0):
    from behavior_driven_video_synthesis_tpu_torch.models.convert import (
        flatten_tree)

    tree, inputs, post, prior = make_inputs(seed)
    outputs = jax_outputs(tree, inputs, post, prior)
    out = flatten_tree({
        "params": {"vunet": {k: v.astype(np.float16) for k, v in
                             flatten_tree(tree).items()}},
        "inputs": inputs,
        "noise": {"posterior": {str(i): n for i, n in enumerate(post)},
                  "prior": {str(i): {str(l): g for l, g in enumerate(gs)}
                            for i, gs in enumerate(prior)}},
        "outputs": outputs})
    out["config"] = np.frombuffer(json.dumps(ARCH).encode(), np.uint8)
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = golden_arrays(0)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
