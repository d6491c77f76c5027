"""The float32 precision the entry points run under.

torch computes float32 matrix products in full float32 by default but
lets cuDNN run float32 convolutions in TF32, which keeps about three
decimal digits.  The port is held against the JAX package in full float32
and measured that way on the card, so both CLIs turn TF32 off for matrix
products and convolutions alike, right after parsing their arguments.
"""
from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Run float32 matrix products and cuDNN convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_enabled() -> bool:
    """Whether either TF32 switch is on, for a run's record."""
    return bool(torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)
