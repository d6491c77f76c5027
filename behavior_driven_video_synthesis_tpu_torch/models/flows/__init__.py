from .blocks import (ActNorm, CouplingFlowBlock, DoubleCoupling, Shuffle,
                     UnconditionalFlow)
from .transformer import LatentFlow, flow_loss, gaussian_reference_nll

__all__ = ["ActNorm", "CouplingFlowBlock", "DoubleCoupling", "LatentFlow",
           "Shuffle", "UnconditionalFlow", "flow_loss",
           "gaussian_reference_nll"]
