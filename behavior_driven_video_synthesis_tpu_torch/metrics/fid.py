"""The Frechet Inception Distance of two sets of Inception features.

Counterpart of ``behavior_driven_video_synthesis_tpu/metrics/fid.py``:
||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrtm(C1 C2)).  The means and sample
covariances (:func:`gaussian_stats`) are computed by torch on the
features' device, in float32 (float64 for float64 input); the matrix
square root runs on the host in float64 (scipy ``sqrtm``; 2048 x 2048,
once an evaluation).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy import linalg


def gaussian_stats(features) -> Tuple[np.ndarray, np.ndarray]:
    """features (N, D), a tensor or an array -> (mu (D,), cov (D, D))
    float64 numpy, the covariance with N - 1."""
    feats = torch.as_tensor(features)
    feats = feats.to(torch.float64 if feats.dtype == torch.float64
                     else torch.float32)
    mu = feats.mean(dim=0)
    centered = feats - mu
    cov = (centered.T @ centered) / (feats.shape[0] - 1)
    return (mu.cpu().numpy().astype(np.float64),
            cov.cpu().numpy().astype(np.float64))


def fid_from_stats(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    cov1, cov2 = np.atleast_2d(cov1), np.atleast_2d(cov2)
    diff = mu1 - mu2
    # sqrtm's ``disp`` (which the JAX package passes) is gone from scipy
    # 1.18; without it sqrtm returns the root alone in every version
    covmean = linalg.sqrtm(cov1.dot(cov2))
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = linalg.sqrtm((cov1 + offset).dot(cov2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"imaginary component "
                             f"{np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(cov1) + np.trace(cov2)
                 - 2 * np.trace(covmean))


def fid_from_features(feats1, feats2) -> float:
    mu1, c1 = gaussian_stats(feats1)
    mu2, c2 = gaussian_stats(feats2)
    return fid_from_stats(mu1, c1, mu2, c2)
