"""Perceptual feature pyramids for the VUNet likelihood.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/perceptual.py``:
``training.perceptual: laplacian``, the weight-free pyramid, and ``vgg``
(the default), the VGG19 trunk up to relu5_2.  VGG19 weights come from a
``.npz`` of flax parameters (``training.vgg_weights_path``, the layout
``load_npz_params`` reads and ``save_npz_params`` writes, the JAX
package's) through :func:`vgg19_from_flax`, or, without one, from a
seeded random init: no pretrained weights exist here and nothing is
downloaded (WEIGHTS.md).  ``load_torchvision_vgg19`` turns a torchvision
``vgg19`` state dict into that flax tree, once and offline.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .init import init_like_jax_


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


# VGG19's conv layers up to conv5_2 ("M": a 2x2 max pool) and the taps
# taken after the ReLU of five of them
VGG19_CFG = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    "M",
    ("conv5_1", 512), ("conv5_2", 512),
]
VGG19_TAPS = {"conv1_2": "relu1_2", "conv2_2": "relu2_2",
              "conv3_2": "relu3_2", "conv4_2": "relu4_2",
              "conv5_2": "relu5_2"}
# torchvision's features.* indices of VGG19's conv layers, in order
_TORCHVISION_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30]
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class PerceptualVGG19(nn.Module):
    """VGG19 up to relu5_2 on NHWC input in [-1, 1] (rescaled to [0, 1],
    then ImageNet-normalized), returning the feature pyramid
    {input, relu1_2, ..., relu5_2}, NHWC, in float32.  Layers are named
    as the flax module's (``conv1_1.weight`` is its ``conv1_1/kernel``)."""

    def __init__(self, device=None):
        super().__init__()
        cin = 3
        for item in VGG19_CFG:
            if item != "M":
                name, ch = item
                self.add_module(name, nn.Conv2d(cin, ch, 3, padding=1,
                                                device=device))
                cin = ch
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN,
                                                  device=device),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD,
                                                 device=device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {"input": x}
        h = ((x.float() + 1.0) / 2.0 - self.mean) / self.std
        h = h.permute(0, 3, 1, 2)
        for item in VGG19_CFG:
            if item == "M":
                h = F.max_pool2d(h, 2, 2)
                continue
            h = torch.relu(getattr(self, item[0])(h))
            if item[0] in VGG19_TAPS:
                out[VGG19_TAPS[item[0]]] = h.permute(0, 2, 3, 1)
        return out


def load_torchvision_vgg19(state_dict) -> Dict:
    """A torchvision ``vgg19`` state dict (``features.N.weight/bias``,
    tensors or arrays) -> the flax variables ``{"params": {layer: {kernel
    (HWIO), bias}}}`` of the layers up to conv5_2, as numpy arrays."""
    params = {}
    conv_names = [item[0] for item in VGG19_CFG if item != "M"]
    for name, idx in zip(conv_names, _TORCHVISION_CONV_IDX):
        w = np.asarray(state_dict[f"features.{idx}.weight"])       # OIHW
        params[name] = {"kernel": np.ascontiguousarray(
                            w.transpose(2, 3, 1, 0)),
                        "bias": np.asarray(state_dict[f"features.{idx}.bias"])}
    return {"params": params}


def save_npz_params(variables: Dict, path: str) -> None:
    """Flax variables ``{"params": {layer: {name: array}}}`` -> a ``.npz``
    with keys ``<layer>.<name>`` (what :func:`load_npz_params` reads)."""
    np.savez(path, **{f"{lname}.{k}": np.asarray(v)
                      for lname, p in variables["params"].items()
                      for k, v in p.items()})


def load_npz_params(path: str) -> Dict:
    """The flax variables ``{"params": {layer: {kernel, bias}}}`` of a
    ``.npz`` whose keys are ``<layer>.<kernel|bias>``."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as data:
        for key in data.files:
            lname, k = key.rsplit(".", 1)
            params.setdefault(lname, {})[k] = np.asarray(data[key])
    return {"params": params}


def vgg19_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """A flax VGG19 tree (HWIO kernels) -> :class:`PerceptualVGG19`'s
    state dict (OIHW weights)."""
    params = variables.get("params", variables)
    sd = {}
    for lname, p in params.items():
        sd[f"{lname}.weight"] = torch.tensor(
            np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1))
        sd[f"{lname}.bias"] = torch.tensor(np.asarray(p["bias"],
                                                      np.float32))
    return sd


def perceptual_from_config(config: dict, device=None, generator=None):
    """The feature net that ``training.perceptual`` names: the Laplacian
    pyramid, or VGG19 (the default) with the weights of
    ``training.vgg_weights_path`` or, without it, the JAX package's
    initializers drawn from ``generator``.  The VGG19 is frozen."""
    tr = config.get("training", {})
    mode = str(tr.get("perceptual", "vgg")).lower()
    if mode == "laplacian":
        print("perceptual: laplacian pyramid (weight-free)")
        return LaplacianPyramidFeatures()
    if mode != "vgg":
        raise ValueError(f"unknown perceptual {mode!r}; expected 'vgg' or "
                         "'laplacian'")
    vgg = PerceptualVGG19(device=device)
    weights_path = tr.get("vgg_weights_path")
    if weights_path:
        print(f"perceptual: VGG19 with weights from {weights_path}")
        vgg.load_state_dict(vgg19_from_flax(load_npz_params(
            str(weights_path))))
    else:
        print("perceptual: VGG19 with RANDOM init (no pretrained "
              "weights in this environment; metrics are not "
              "literature-comparable — see WEIGHTS.md)")
        init_like_jax_(vgg, generator)
    return vgg.eval().requires_grad_(False)
