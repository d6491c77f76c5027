"""Write tests/golden/torch_port_infer_small.npz: the JAX package's
behavior_net ``-m infer`` summary at small width, with its draws.

    JAX_PLATFORMS=cpu python tests/make_torch_port_infer_golden.py

The setup is ``tests/torch_port_infer.py``'s (9 keypoints,
``dim_hidden_b`` 16, T=8, B=4, 3 flows, S=3 samples over 2 batches, a
cache of 8 sequences, 3 post-hoc iterations, f32).  ``chip_smoke.py``
holds the PyTorch port's inference on the GPU against this file and needs
no JAX to read it; ``tests/test_torch_behavior_infer.py`` checks that it
still equals a live JAX run.

Keys: ``config`` (the run config as JSON, uint8), ``params_seed`` and
``digest/<module>`` (the weights come from that numpy seed through
``torch_port_infer.make_trees``; the digests check the rebuild),
``probe_seed`` and ``probe_digest/<probe>`` (the post-hoc classifiers'
and regressor's initial weights, from ``torch_port_infer.probe_trees``),
``draws/<site>/<i>`` (each draw of inference, in order),
``posthoc/indices/<probe>`` ((iterations, restarts, batch) int16), and
``summary/<key>``.
"""
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

import torch_port_infer as TI  # noqa: E402

OUT = os.path.join(HERE, "golden", "torch_port_infer_small.npz")
SEED = 0


def live_arrays():
    """The golden's arrays (all but ``config``) from a live JAX run."""
    trees = TI.make_trees(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        summary, recorded, key = TI.jax_run_inference(trees, tmp)
    posthoc = TI.jax_posthoc_draws(key, (TI.MAX_CACHE, TI.T, TI.K))
    return TI.golden_arrays(SEED, summary, recorded, posthoc)


def main():
    jax.config.update("jax_platforms", "cpu")
    out = live_arrays()
    out["config"] = np.frombuffer(json.dumps(TI.config("")).encode(),
                                  np.uint8)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
