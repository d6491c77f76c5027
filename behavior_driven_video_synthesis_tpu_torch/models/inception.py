"""InceptionV3 features and logits for the Inception Score and the FID.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/inception.py``:
the torchvision / tf-slim InceptionV3 trunk to Mixed_7c, average-pooled to
2048 features, and with ``with_logits`` the 1000-way ``fc`` on them.  As in
the JAX package: each BasicConv2d is a bias-free conv, a BatchNorm with
eps 1e-3 on its running statistics (always, in train mode too) and a
ReLU; the branches' average pools exclude the padding
(``count_include_pad=False``, unlike torchvision); the max pools and the
unpadded convs are VALID.  Input NHWC in [-1, 1], any size >= 75.

The modules carry torchvision's ``Inception3`` key names
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_mean``,
``fc.weight``), so a torchvision state dict loads with only its
``AuxLogits`` keys unused (:func:`load_inception_weights`), and the JAX
package's variables convert through ``models/convert.py``
(``inception_from_flax``, ``inception_to_flax``).  Without weights the
network is randomly initialized: IS and FID are then relative numbers
only (WEIGHTS.md).
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# the side the VUNet drivers' evaluation resizes images to (the JAX
# driver's jax.image.resize to 128 x 128)
EVAL_SIZE = 128

# the BasicConv2d of each kind of mixed block, in the order it runs
BLOCK_CONVS = {
    "A": ("branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
          "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"),
    "B": ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
    "C": ("branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
          "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
          "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"),
    "D": ("branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
          "branch7x7x3_3", "branch7x7x3_4"),
    "E": ("branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
          "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
          "branch3x3dbl_3b", "branch_pool"),
}
STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
        "Conv2d_4a_3x3")
MIXED = (("Mixed_5b", "A"), ("Mixed_5c", "A"), ("Mixed_5d", "A"),
         ("Mixed_6a", "B"), ("Mixed_6b", "C"), ("Mixed_6c", "C"),
         ("Mixed_6d", "C"), ("Mixed_6e", "C"), ("Mixed_7a", "D"),
         ("Mixed_7b", "E"), ("Mixed_7c", "E"))


def basic_conv_names() -> List[str]:
    """The module path of every BasicConv2d, stem first."""
    return list(STEM) + [f"{m}.{b}" for m, kind in MIXED
                         for b in BLOCK_CONVS[kind]]


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        return F.relu(F.batch_norm(self.conv(x), bn.running_mean,
                                   bn.running_var, bn.weight, bn.bias,
                                   False, 0.0, bn.eps))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avg_pool(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        return torch.cat([
            self.branch1x1(x),
            self.branch3x3_2a(b3), self.branch3x3_2b(b3),
            self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
            self.branch_pool(_avg_pool(x))], dim=1)


class InceptionV3Features(nn.Module):
    """NHWC images in [-1, 1] -> (B, 2048) pooled features, and with
    ``with_logits`` (features, (B, 1000) logits)."""

    def __init__(self, with_logits: bool = False, device=None):
        super().__init__()
        self.with_logits = with_logits
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        if with_logits:
            self.fc = nn.Linear(2048, 1000)
        if device is not None:
            self.to(device)

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(h)))
        h = F.max_pool2d(h, 3, stride=2)
        h = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(h))
        h = F.max_pool2d(h, 3, stride=2)
        for name, _ in MIXED:
            h = getattr(self, name)(h)
        feats = h.mean(dim=(2, 3))
        if self.with_logits:
            return feats, self.fc(feats)
        return feats


def inception_features(model: InceptionV3Features, img: torch.Tensor):
    """The model's output on NHWC images resized to ``EVAL_SIZE`` as
    ``jax.image.resize(..., "bilinear")`` resizes (antialiased when it
    shrinks), in float32."""
    x = F.interpolate(img.float().permute(0, 3, 1, 2),
                      size=(EVAL_SIZE, EVAL_SIZE), mode="bilinear",
                      antialias=True, align_corners=False)
    return model(x.permute(0, 2, 3, 1))


def load_inception_weights(model: InceptionV3Features, path: str
                           ) -> Tuple[str, ...]:
    """Load ``path`` into ``model``: a torch state dict (``.pt``, ``.pth``;
    torchvision's ``inception_v3`` keys) or a pickle of the JAX package's
    ``{"params", "batch_stats"}`` numpy trees.  Returns the keys of the
    file that were not used (torchvision's ``AuxLogits``)."""
    from .convert import inception_from_flax

    if str(path).endswith((".pt", ".pth")):
        sd: Dict[str, torch.Tensor] = torch.load(path, map_location="cpu",
                                                 weights_only=True)
    else:
        with open(path, "rb") as f:
            sd = inception_from_flax(pickle.load(f))
    unused = tuple(k for k in sd if k.startswith("AuxLogits."))
    missing, unexpected = model.load_state_dict(
        {k: v for k, v in sd.items() if k not in unused}, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"{path}: missing {missing[:5]}, unexpected "
                         f"{list(unexpected)[:5]}")
    return unused
