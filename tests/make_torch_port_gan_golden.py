"""Write tests/golden/torch_port_gan_small.npz: two steps of the JAX
package's cvbae training step with the GAN branch at small width, with
their inputs.

    JAX_PLATFORMS=cpu python tests/make_torch_port_gan_golden.py

The setup is ``tests/torch_port_train.py``'s with ``gan=True`` (32 px, nf
4->8, B=2, R=2, Laplacian pyramid, f32, dropout 0, n_init_batches 1,
regressor on; a PatchGAN of ndf 8 and 2 layers, ``gan_weight`` 0.1, the R1
penalty with ``lambda_gp`` 1, Adam 2e-3 with betas (0.5, 0.9)).
``chip_smoke.py`` holds the PyTorch port's step on the GPU against this
file and needs no JAX to read it; ``tests/test_torch_gan.py`` checks that
it still equals a live JAX run.

Keys: ``config`` (the run config as JSON, uint8), ``params/{vunet,
regressor,disc}/...`` (the flax trees before the steps), ``batch/<key>``,
``noise/<batch size>/<scale>``, ``metrics/<step>/<name>`` and
``after/{vunet,regressor,disc}/...`` (the trees after the steps).
"""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

from behavior_driven_video_synthesis_tpu_torch.flax_npz import (  # noqa
    flatten_tree)
import torch_port_train as T  # noqa: E402

OUT = os.path.join(HERE, "golden", "torch_port_gan_small.npz")


def golden_arrays(run=None):
    """The golden's arrays, from ``run`` (the JAX step's (metrics, trees
    after) on ``T.make_inputs(0, gan=True)``) or a live run of it."""
    trees, batch, noise = T.make_inputs(0, gan=True)
    metrics, after = run if run is not None else T.jax_steps(
        trees, batch, noise)
    return flatten_tree({
        "config": np.frombuffer(json.dumps(T.config(gan=True)).encode(),
                                np.uint8),
        "params": trees, "batch": batch,
        "noise": {b: {str(i): n for i, n in enumerate(ns)}
                  for b, ns in noise.items()},
        "metrics": {str(i): {k: np.float64(v) for k, v in m.items()}
                    for i, m in enumerate(metrics)},
        "after": after,
    })


def main():
    jax.config.update("jax_platforms", "cpu")
    out = golden_arrays()
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
