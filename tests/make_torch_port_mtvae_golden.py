"""Write tests/golden/torch_port_mtvae_small.npz: two steps of the JAX
package's MT-VAE training step at small width, with the means to rebuild
their inputs.

    JAX_PLATFORMS=cpu python tests/make_torch_port_mtvae_golden.py

The setup is ``tests/torch_port_mtvae.py``'s (9 keypoints, dim 32, z 16,
n_cond 3, T=8, B=4, f32, the KL ramp over 4 steps).  ``chip_smoke.py``
holds the PyTorch port's steps on the GPU against this file and needs no
JAX to read it; ``tests/test_torch_mtvae_train.py`` checks that it still
equals a live JAX run.

Keys: ``config`` (the run config as JSON, uint8), ``seed`` (the numpy
seed of ``make_inputs``, which rebuilds the weights, batch and draws
without JAX), ``digest/{params,batch,noise}`` (float64 sums of |value|,
a check of that rebuild), ``metrics/<step>/<name>`` and ``update/...``
(each leaf's update over the steps, after minus before, in float16).
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

import torch_port_mtvae as TM  # noqa: E402

OUT = os.path.join(HERE, "golden", "torch_port_mtvae_small.npz")


def main():
    jax.config.update("jax_platforms", "cpu")
    tree, batch, noise = TM.make_inputs(TM.SEED)
    out = TM.golden_arrays(tree, batch, noise,
                           *TM.jax_steps(tree, batch, noise))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
