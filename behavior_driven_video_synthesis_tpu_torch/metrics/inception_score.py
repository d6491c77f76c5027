"""The Inception Score of class probabilities.

Counterpart of ``behavior_driven_video_synthesis_tpu/metrics/
inception_score.py``: exp(mean KL(p(y|x) || p(y))) in each of ``splits``
parts; returns (mean, std) over the parts.
"""
from __future__ import annotations

import numpy as np
import torch


def inception_score_from_probs(probs, splits: int = 1):
    """probs (N, n_classes) softmax outputs, numpy."""
    probs = np.asarray(probs)
    N = probs.shape[0]
    scores = []
    for k in range(splits):
        part = probs[k * (N // splits):(k + 1) * (N // splits)]
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(float(np.exp(kl.sum(axis=1).mean())))
    return float(np.mean(scores)), float(np.std(scores))


def inception_score_from_logits(logits, splits: int = 1):
    """The score of softmax(logits), a tensor or an array."""
    probs = torch.softmax(torch.as_tensor(logits), dim=-1)
    return inception_score_from_probs(probs.cpu().numpy(), splits)
