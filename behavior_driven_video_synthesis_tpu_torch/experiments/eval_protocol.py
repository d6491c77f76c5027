"""Evaluation of the behavior experiment.

Counterpart of ``ks_test_flow_gaussianity`` in
``behavior_driven_video_synthesis_tpu/experiments/eval_protocol.py``; the
rest of the inference protocol (``-m infer``) is not ported yet (ROADMAP
A6b).
"""
from __future__ import annotations

import numpy as np
from scipy.stats import kstest


def ks_test_flow_gaussianity(z: np.ndarray) -> float:
    """Mean over dims of KS-test p-values of flow codes vs N(0,1)."""
    z = np.asarray(z)
    ps = [kstest(z[:, d], "norm")[1] for d in range(z.shape[1])]
    return float(np.mean(ps))
