"""Write tests/golden/torch_port_behavior_small.npz: two steps of the JAX
package's behavior cVAE step and then two of its flow step, at small
width, with their inputs and draws.

    JAX_PLATFORMS=cpu python tests/make_torch_port_behavior_golden.py

The setup is ``tests/torch_port_behavior.py``'s (9 keypoints,
``dim_hidden_b`` 16, T=8, B=4, 3 actions, 3 flows of mid width 32, f32).
``chip_smoke.py`` holds the PyTorch port's steps on the GPU against this
file and needs no JAX to read it; ``tests/test_torch_behavior_train.py``
checks that it still equals a live JAX run.

Keys: ``config`` (the run config as JSON, uint8), ``params/<module>/...``
(the flax trees before the steps: net, regressor, cls_action,
cls_action2, cls_beta, flow), ``batch/<key>``,
``draws/{cvae,flow}/<step>/...``, ``metrics/{cvae,flow}/<step>/<name>``
and ``after/<module>/...`` (the trees after the steps).
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
import torch_port_behavior as TB  # noqa: E402

OUT = os.path.join(HERE, "golden", "torch_port_behavior_small.npz")


def live_arrays(inputs, run):
    """The golden's arrays (all but ``config``) from the inputs and a live
    run of the JAX steps."""
    trees, batch, draws = inputs
    metrics, after = run
    return flatten_tree({
        "params": trees, "batch": batch,
        "draws": {s: {str(i): d for i, d in enumerate(ds)}
                  for s, ds in draws.items()},
        "metrics": {s: {str(i): m for i, m in enumerate(ms)}
                    for s, ms in metrics.items()},
        "after": after})


def main():
    jax.config.update("jax_platforms", "cpu")
    inputs = TB.make_inputs(0)
    out = live_arrays(inputs, TB.jax_steps(*inputs))
    out["config"] = np.frombuffer(json.dumps(TB.config()).encode(),
                                  np.uint8)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
