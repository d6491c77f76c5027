"""Write tests/golden/torch_port_slice_small.npz: the small behavior-transfer
slice's weights, inputs and JAX-package outputs.

    JAX_PLATFORMS=cpu python tests/make_torch_port_golden.py

The slice is the one of ``tests/torch_port_slice.py`` (32 px, HID 32, T 6,
B 2), with numpy-seeded weights.  The JAX package computes, on the CPU in
f32: ``generate`` (flow sample mode) and ``reenact``, and the decoder
rollout of the flow's output through its f32 scan.  ``chip_smoke.py`` holds
the PyTorch port on the GPU against this file; it needs no JAX to read it.

Keys: ``params/{behavior,vunet,flow}/...`` (flax trees, "/"-joined, in
float16, which holds the float32 weights exactly), ``inputs/<name>``,
``noise/<i>`` (appearance posterior noise per latent scale),
``generate/<output>``, ``reenact/<output>``, ``rollout/{b,xs}``.
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from behavior_driven_video_synthesis_tpu.models.behavior import (  # noqa
    decoder_rollout_kernel)
from behavior_driven_video_synthesis_tpu_torch.models.convert import (  # noqa
    flatten_tree)
from torch_port_slice import (T, camera_args, jax_noise,  # noqa
                              jax_pipeline, make_slice)

OUT = os.path.join(HERE, "golden", "torch_port_slice_small.npz")


def main():
    jax.config.update("jax_platforms", "cpu")
    trees, inputs, noise = make_slice(0)
    pipe = jax_pipeline(inputs=inputs)
    params = trees
    key = jax.random.PRNGKey(0)
    with jax_noise(noise):
        gen = pipe.generate(params, jnp.asarray(inputs["z"]),
                            jnp.asarray(inputs["x_start"]),
                            *camera_args(inputs), key, length=T)
        ren = pipe.reenact(params, jnp.asarray(inputs["x_source"]),
                           jnp.asarray(inputs["x_start"]),
                           *camera_args(inputs), key, length=T)
    b = pipe.flow_model.apply(trees["flow"], jnp.asarray(inputs["z"]),
                              method=pipe.flow_model.reverse)
    xs = decoder_rollout_kernel(trees["behavior"]["decoder"], b,
                                jnp.asarray(inputs["x_start"]), T,
                                use_pallas=False)
    # the weights are float16-representable (torch_port_slice.make_slice)
    params = {k: v.astype(np.float16) if v.dtype == np.float32 else v
              for k, v in flatten_tree(trees).items()}
    out = flatten_tree({
        "params": params, "inputs": inputs,
        "noise": {str(i): n for i, n in enumerate(noise)},
        "generate": {k: np.asarray(v, np.float32) for k, v in gen.items()},
        "reenact": {k: np.asarray(v, np.float32) for k, v in ren.items()},
        "rollout": {"b": b, "xs": xs},
    })
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
