"""Perceptual feature pyramids for the VUNet likelihood.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/perceptual.py``
for ``training.perceptual: laplacian``, the weight-free pyramid; the VGG19
features (``perceptual: vgg``) are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def feature_names():
    return ["input", "relu1_2", "relu2_2", "relu3_2", "relu4_2", "relu5_2"]


class LaplacianPyramidFeatures:
    """Laplacian band-pass levels plus image gradients, NHWC, shaped like
    the VGG19 pyramid (6 named levels) so it drops into ``vgg_loss``
    (JAX ``models/perceptual.py:115-169``).  Deterministic and free of
    parameters: level 1 is the image gradients, levels 2.. the band-pass
    ``g - blur(g)`` times 2^i, with a 5-tap binomial blur under reflect
    padding, and g halved after each level."""

    def __init__(self, n_levels: int = 5):
        self.n_levels = n_levels

    @staticmethod
    def _blur(v: torch.Tensor) -> torch.Tensor:
        """Separable [1, 4, 6, 4, 1]/16 blur of NHWC v, H then W."""
        c = v.shape[-1]
        k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=v.dtype,
                         device=v.device) / 16.0
        h = v.permute(0, 3, 1, 2)
        h = F.conv2d(F.pad(h, (0, 0, 2, 2), mode="reflect"),
                     k.reshape(1, 1, 5, 1).expand(c, 1, 5, 1), groups=c)
        h = F.conv2d(F.pad(h, (2, 2, 0, 0), mode="reflect"),
                     k.reshape(1, 1, 1, 5).expand(c, 1, 1, 5), groups=c)
        return h.permute(0, 2, 3, 1)

    def __call__(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {"input": x}
        g = x.float()
        for i, name in enumerate(feature_names()[1:self.n_levels + 1]):
            if i == 0:
                gx = g[:, :, 1:] - g[:, :, :-1]
                gy = g[:, 1:] - g[:, :-1]
                out[name] = torch.cat([gx[:, :-1], gy[:, :, :-1]],
                                      dim=-1) * 2.0
                continue
            low = self._blur(g)
            out[name] = (g - low) * (2.0 ** i)
            if min(low.shape[1:3]) >= 2:
                low = low[:, ::2, ::2]
            g = low
        return out


def perceptual_from_config(config: dict):
    """The feature net that ``training.perceptual`` names."""
    mode = str(config.get("training", {}).get("perceptual", "vgg")).lower()
    if mode == "laplacian":
        return LaplacianPyramidFeatures()
    raise NotImplementedError(f"perceptual {mode!r} is not ported yet "
                              "(only 'laplacian' is)")
