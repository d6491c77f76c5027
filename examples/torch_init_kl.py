"""The cvbae VUNet's KL term at initialization, in both packages.

    JAX_PLATFORMS=cpu python examples/torch_init_kl.py [--size 256] [--seeds 2]

Each package initializes the full-width VUNet-alter (nf 32->128) with its
own initializers (flax's for the JAX package, ``init_like_jax_`` for the
PyTorch port) from a few seeds, and runs one training forward (dropout 0)
on the same random appearance and stickman images in f32 on the CPU.  It
prints ``compute_kl_with_prior`` of the posterior and the mean |image|:
the two initializers match in distribution, so the magnitudes should agree
within seed-to-seed spread.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from behavior_driven_video_synthesis_tpu.models.vunet import (  # noqa: E402
    VUNet as JaxVUNet)
from behavior_driven_video_synthesis_tpu.train.losses import (  # noqa: E402
    compute_kl_with_prior as jax_kl)
from behavior_driven_video_synthesis_tpu_torch.models.init import (  # noqa
    init_like_jax_)
from behavior_driven_video_synthesis_tpu_torch.models.vunet import (  # noqa
    VUNet)
from behavior_driven_video_synthesis_tpu_torch.train.losses import (  # noqa
    compute_kl_with_prior)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seeds", type=int, default=2)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    S, B = args.size, args.batch
    rng = np.random.RandomState(0)
    x = (rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
    c = (rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
    jnet = JaxVUNet(spatial_size=S, nf_start=32, nf_max=128, variant="alter")
    fwd = jax.jit(lambda v: jnet.apply(
        v, x, c, train=True, rngs={"sample": jax.random.PRNGKey(3)}))
    for seed in range(args.seeds):
        v = jnet.init({"params": jax.random.PRNGKey(seed),
                       "sample": jax.random.PRNGKey(1),
                       "dropout": jax.random.PRNGKey(2)}, x, c)
        imgs, means, logstds, _, _ = fwd(v)
        print(f"jax   seed {seed}: kl {float(jax_kl(means, logstds)):.4e}, "
              f"mean |img| {float(jnp.abs(imgs).mean()):.4e}")
        net = init_like_jax_(VUNet(spatial_size=S, nf_start=32, nf_max=128),
                             torch.Generator().manual_seed(seed))
        with torch.no_grad():
            imgs, means, logstds, _, _ = net(
                torch.from_numpy(x), torch.from_numpy(c),
                generator=torch.Generator().manual_seed(3))
        print(f"torch seed {seed}: kl "
              f"{float(compute_kl_with_prior(means, logstds)):.4e}, "
              f"mean |img| {float(imgs.abs().mean()):.4e}")


if __name__ == "__main__":
    main()
