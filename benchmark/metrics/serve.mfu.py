"""serve.mfu: in the bulk cells, a request's model FLOPs (the flow's
products, the rollout's gate and output products, the VUNet's
convolutions, counted from the configuration's shapes) over its untraced
latency, as a share of the card's bf16 dense tensor peak."""
from benchmark.readers import mfu_pct


def read(run):
    return mfu_pct(run)
