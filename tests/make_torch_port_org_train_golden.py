"""Write tests/golden/torch_port_org_train_small.npz: steps of the JAX
package's original-VUNet (org) training step at small width, with their
inputs.

    JAX_PLATFORMS=cpu python tests/make_torch_port_org_train_golden.py

The setup is ``tests/torch_port_org_train.py``'s (32 px, nf 4->8, B=2, a
30-channel 16x16 part stack, Laplacian pyramid, f32, dropout 0, three
steps over the KL ramp).  ``chip_smoke.py`` holds the PyTorch port's step
on the GPU against this file and needs no JAX to read it;
``tests/test_torch_org_train.py`` checks that it still equals a live JAX
run.

Keys: ``config`` (the run config as JSON, uint8), ``seed`` (the numpy
seed of ``make_inputs``, which rebuilds the weights, batch and noise
without JAX), ``digest/{params,batch,noise}`` (float64 sums of |value|,
a check of that rebuild), ``metrics/<step>/<name>`` and
``update/...`` (each leaf's update over the steps, after minus before, in
float16: the golden stays under 1 MB).
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
import torch_port_org_train as T  # noqa: E402

OUT = os.path.join(HERE, "golden", "torch_port_org_train_small.npz")


SEED = 0


def golden_arrays(tree, batch, noise, metrics, after):
    before, after = flatten_tree(tree), flatten_tree(after)
    return flatten_tree({
        "config": np.frombuffer(json.dumps(T.config()).encode(), np.uint8),
        "seed": np.int64(SEED),
        "digest": T.digests(tree, batch, noise),
        "metrics": {str(i): {k: np.float64(v) for k, v in m.items()}
                    for i, m in enumerate(metrics)},
        "update": {k: (np.asarray(after[k], np.float64) - v).astype(
            np.float16) for k, v in before.items()},
    })


def main():
    jax.config.update("jax_platforms", "cpu")
    tree, batch, noise = T.make_inputs(SEED)
    out = golden_arrays(tree, batch, noise, *T.jax_steps(tree, batch, noise))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
