"""Why every leaf of an FSDP-sharded flow is sharded: on the card, one
flow (3 flows of width 1024, mid 2048, B=64) trained 3 steps

  - replicated with PyTorch's multi-tensor Adam (the reference),
  - replicated with the per-tensor Adam (``foreach=False``),
  - FSDP on a 1-rank NCCL group with the small leaves left whole (the
    multi-tensor Adam refuses a mix of sharded and whole parameters, so
    the per-tensor one),
  - FSDP with every leaf sharded (``parallel/sharding_rules.py:shard_fsdp``)
    and the multi-tensor Adam,

printing each step's largest gradient difference to the reference (over
1 + the gradient's max) and the largest parameter difference after the 3
steps.  Run on a machine with one CUDA device:

    python3 examples/torch_fsdp_adam_probe.py
"""
import copy
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from behavior_driven_video_synthesis_tpu_torch.core import precision  # noqa
from behavior_driven_video_synthesis_tpu_torch.models import flows  # noqa
from behavior_driven_video_synthesis_tpu_torch.models.init import (  # noqa
    init_like_jax_)
from behavior_driven_video_synthesis_tpu_torch.parallel import (  # noqa
    mesh, sharding_rules)


def run(base, xs, fsdp, foreach, whole_small=False):
    """(gradients of each step, full parameters after them)."""
    f = copy.deepcopy(base)
    if fsdp and whole_small:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard
        n = dist.get_world_size()
        dims = {p: sharding_rules.fsdp_leaf_dim(p.shape, n)
                for p in f.parameters()}
        fully_shard(f, shard_placement_fn=lambda p: Shard(dims[p]),
                    ignored_params={p for p, d in dims.items() if d is None})
    elif fsdp:
        sharding_rules.shard_fsdp(f)
    opt = torch.optim.Adam(f.parameters(), lr=4.5e-7 * 64, betas=(0.5, 0.9),
                           foreach=foreach)
    grads = []
    for x in xs:
        z, logdet = f(x)
        opt.zero_grad(set_to_none=True)
        flows.flow_loss(z, logdet).backward()
        grads.append({n: (p.grad.full_tensor()
                          if mesh.is_dtensor(p.grad)
                          else p.grad).detach().clone()
                      for n, p in f.named_parameters()})
        opt.step()
    return grads, sharding_rules.full_state(f)[0]


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    precision.disable_tf32()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    base = flows.LatentFlow(1024, 2048, 2, 3, device=dev)
    init_like_jax_(base, torch.Generator(device=dev).manual_seed(1))
    base.initialize_(torch.randn(64, 1024, generator=g, device=dev) * 0.5)
    xs = [torch.randn(64, 1024, generator=g, device=dev) * 0.5
          for _ in range(3)]
    dist.init_process_group("nccl", init_method=f"file://"
                            f"{tempfile.mkdtemp()}/pg", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        ref_grads, ref_params = run(base, xs, False, None)
        for name, kw in (
                ("replicated, per-tensor Adam", dict(fsdp=False,
                                                     foreach=False)),
                ("FSDP, small leaves whole, per-tensor Adam",
                 dict(fsdp=True, foreach=False, whole_small=True)),
                ("FSDP, every leaf sharded, multi-tensor Adam",
                 dict(fsdp=True, foreach=None))):
            grads, params = run(base, xs, **kw)
            for step, (a, b) in enumerate(zip(grads, ref_grads)):
                worst = max(float((a[k] - b[k]).abs().max())
                            / (1 + float(b[k].abs().max())) for k in b)
                print(f"{name}: step {step} gradient {worst:.3e}")
            worst = max(float((params[k].float() - ref_params[k].float())
                              .abs().max()) for k in ref_params)
            print(f"{name}: parameters after 3 steps {worst:.3e}")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
