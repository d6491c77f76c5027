"""Structural similarity (Wang et al.) of image batches.

Counterpart of ``behavior_driven_video_synthesis_tpu/metrics/ssim.py``:
skimage's configuration (a Gaussian window of sigma 1.5 truncated at 3.5
sigma, 11 taps, applied separably without padding; population covariance;
``data_range`` 1), per channel, averaged over each image.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(sigma: float = 1.5, truncate: float = 3.5):
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _filter2d_sep(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The 'valid' separable filter of NCHW img, H then W, per channel."""
    c, n = img.shape[1], kernel.numel()
    out = F.conv2d(img, kernel.reshape(1, 1, n, 1).expand(c, 1, n, 1),
                   groups=c)
    return F.conv2d(out, kernel.reshape(1, 1, 1, n).expand(c, 1, 1, n),
                    groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
         sigma: float = 1.5, truncate: float = 3.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """img1, img2: (B, H, W, C) in [0, data_range] -> (B,) mean SSIM, in
    float32."""
    kernel = torch.as_tensor(_gaussian_kernel(sigma, truncate),
                             device=img1.device)
    a = img1.float().permute(0, 3, 1, 2)
    b = img2.float().permute(0, 3, 1, 2)
    mu1, mu2 = _filter2d_sep(a, kernel), _filter2d_sep(b, kernel)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # variances are >= 0; clamp the cancellation error of E[x^2] - mu^2
    sigma1_sq = torch.clamp(_filter2d_sep(a * a, kernel) - mu1_sq, min=0.0)
    sigma2_sq = torch.clamp(_filter2d_sep(b * b, kernel) - mu2_sq, min=0.0)
    sigma12 = _filter2d_sep(a * b, kernel) - mu12
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * mu12 + c1) * (2 * sigma12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    return torch.mean(num / den, dim=(1, 2, 3))
