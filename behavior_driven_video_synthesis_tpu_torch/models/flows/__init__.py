from .blocks import (COUPLING_TYPES, ActNorm, CouplingFlowBlock,
                     DoubleCoupling, GINCoupling, NICECoupling, Shuffle,
                     UnconditionalFlow)
from .concat import ConditionalTransformer, DenseEmbedder, Embedder
from .conditional import (ConditionalCoupling, ConditionalFlow,
                          ConditionalFlowBlock, InvLeakyRelu)
from .made import ARFullyConnectedNet, MaskedDense
from .spline import RQSCoupling, rational_quadratic_spline
from .transformer import LatentFlow, flow_loss, gaussian_reference_nll

# the spline coupling builds on blocks.py, so it registers here
COUPLING_TYPES["rqs"] = RQSCoupling

__all__ = ["ARFullyConnectedNet", "ActNorm", "COUPLING_TYPES",
           "ConditionalCoupling", "ConditionalFlow", "ConditionalFlowBlock",
           "ConditionalTransformer", "CouplingFlowBlock", "DenseEmbedder",
           "DoubleCoupling", "Embedder", "GINCoupling", "InvLeakyRelu",
           "LatentFlow", "MaskedDense", "NICECoupling", "RQSCoupling",
           "Shuffle", "UnconditionalFlow", "flow_loss",
           "gaussian_reference_nll", "rational_quadratic_spline"]
