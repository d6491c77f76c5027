from .behavior import (BehaviorEncoder, ResidualBehaviorNet, ResidualDecoder,
                       decoder_rollout_kernel)

__all__ = ["BehaviorEncoder", "ResidualBehaviorNet", "ResidualDecoder",
           "decoder_rollout_kernel"]
