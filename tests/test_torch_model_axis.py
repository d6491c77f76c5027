"""The port's "model"-axis rules against the JAX package's.

Leaf by leaf, the port's placements (``infer_param_placements`` on a
module's converter plan) against JAX's ``infer_param_shardings`` on the
flax tree the converter exports, for modules of every converter layout
and two model-axis sizes; then a ConditionalTransformer placed by
``shard_module_state`` on 2 and 4 spawned gloo ranks
(``tests/torch_port_model_axis.py``) against the same module unplaced:
the forward, the gradients and one Adam step bit-equal (with the
optimizer built before the placement and moved over, or after it), and
the moments' placements following their parameters'.  On a ("data",
"model") mesh each data rank takes a batch of its own, and the unplaced
step takes the mean of their gradients.
"""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from behavior_driven_video_synthesis_tpu.parallel.sharding_rules import (
    infer_param_shardings)

from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models import (
    discriminators, rim)
from behavior_driven_video_synthesis_tpu_torch.models.behavior import (
    ResidualBehaviorNet)
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.parallel import sharding_rules

import torch_port_model_axis as axis
from torch_port_threads import one_torch_thread  # noqa: F401

MIN_DIM = axis.MIN_DIM


def _modules():
    """(module, plan) of every converter layout: Dense "T", conv "hwio",
    weight-norm "dense_v" and "g", ActNorm "c4", Conv1d "conv1d", the
    C-major "fc_cmajor", "id" leaves of 1 and 3 dims, Shuffle "perm"."""
    transformer, plan, _ = axis.build("image")
    return {
        "conditional_transformer": (transformer, plan),
        "rim": (rim.RIM(6, 8, 4, 2, n_layers=2, bidirectional=True),
                pconv.rim_plan(4)),
        "midisc_conv": (discriminators.MIDiscConv(10, 2, 24),
                        pconv.midisc_conv_plan(2)),
        "sequence_disc_michael": (
            discriminators.SequenceDiscMichael(12, 16, layers=(2, 1)),
            pconv.sequence_disc_michael_plan((2, 1))),
        "behavior_net": (ResidualBehaviorNet(4, 16),
                         pconv.behavior_net_plan()),
    }


MODULES = _modules()


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_placements_match_infer_param_shardings(name, n):
    module, plan = MODULES[name]
    init_random_(module, np.random.RandomState(0))
    sd = module.state_dict()
    tree = pconv.to_flax(sd, plan)
    params = tree["params"] if "params" in tree else tree
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(1, n), ("data", "model"))
    specs = infer_param_shardings(params, mesh, min_dim=MIN_DIM)
    dims = sharding_rules.infer_param_placements(module, plan, n, MIN_DIM)
    assert dims.keys() == dict(module.named_parameters()).keys()
    seen = {"sharded": 0, "replicated": 0, "indivisible": 0}
    for key, path, kind in plan:
        if key not in dims:                  # a buffer: replicated
            assert kind == "perm"
            continue
        path = path[1:] if path[0] == "params" else path
        spec = tuple(_leaf(specs, path).spec)
        sharded = "model" in spec
        assert sharded == (dims[key] is not None), (key, spec, dims[key])
        seen["sharded" if sharded else "replicated"] += 1
        flax_shape = _leaf(params, path).shape
        if (not sharded and len(flax_shape) >= 2
                and flax_shape[-1] >= MIN_DIM):
            seen["indivisible"] += 1     # replicated: n does not divide it
        if sharded:
            # the torch dim is the flax leaf's last axis: an index along it
            # converts to an index along that axis
            assert spec[-1] == "model" and spec.count("model") == 1
            d, shape = dims[key], sd[key].shape
            index = np.broadcast_to(np.arange(shape[d]).reshape(
                [-1 if i == d else 1 for i in range(len(shape))]), shape)
            flax = pconv._TO_FLAX[kind](index)
            np.testing.assert_array_equal(flax, np.broadcast_to(
                np.arange(flax.shape[-1]), flax.shape), err_msg=key)
    # n = 2 shards some leaves of every module; n = 3 divides few widths
    assert seen["replicated"] and seen["sharded"] + seen["indivisible"]
    assert seen["sharded"] or n != 2, seen


def test_a_mesh_without_a_model_axis_replicates_everything(tmp_path):
    """As in JAX: no "model" dimension, no sharding (one gloo rank in this
    process)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        module, plan, (x, cond) = axis.build("dense")
        ref = [o.detach() for o in module(x, cond)]
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        dims = sharding_rules.shard_module_state(module, mesh, plan,
                                                 min_dim=MIN_DIM)
        assert not any(d is not None for d in dims.values())
        out = module(x, cond)
        for a, b in zip(out, ref):
            assert not hasattr(a, "placements")
            np.testing.assert_array_equal(a.detach().numpy(), b.numpy())
    finally:
        dist.destroy_process_group()


# (name, kind, unplaced steps before the placement, mesh shape): one
# "model" dimension over both ranks, or a ("data", "model") mesh whose
# data dimension gives each rank a batch of its own
JOBS = [("dense", "dense", 0, (2,)), ("image", "image", 0, (2,)),
        ("dense_moved", "dense", 1, (2,)),
        ("dense_data", "dense", 0, (2, 1)),
        ("image_data", "image", 0, (2, 1)),
        ("dense_data_model", "dense", 0, (2, 2))]


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    out = {}
    for world in (2, 4):
        store = str(tmp_path_factory.mktemp(f"model_axis_{world}"))
        out.update(axis.run_ranks(world, store, [
            j for j in JOBS if int(np.prod(j[3])) == world]))
    return out


@pytest.mark.parametrize("name,kind,before,shape", JOBS,
                         ids=[j[0] for j in JOBS])
def test_placed_step_equals_the_unplaced_step(placed, name, kind, before,
                                              shape):
    """On a ("data", "model") mesh the unplaced step takes the mean of the
    gradients of the data ranks' batches: the placement averages them
    over the data dimension, as GSPMD sums them in JAX."""
    got = placed[name]
    parts = shape[0] if len(shape) == 2 else 1
    want = axis.train(kind, steps_before=before, parts=parts)
    assert any(d is not None for d in got["dims"].values())
    assert not all(d is not None for d in got["dims"].values())
    # the placed forward computes on the gathered parameters, the same
    # values as the unplaced one: everything is equal, bit for bit
    for k in ("z", "logdet", "reverse"):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)
    for k, g in want["grads"].items():
        np.testing.assert_array_equal(got["grads"][k].numpy(), g.numpy(),
                                      f"grad {k}")
    for k, p in want["params"].items():
        np.testing.assert_array_equal(got["params"][k].numpy(), p.numpy(),
                                      k)
    # every parameter and its moments: sharded over "model" on its dim, or
    # replicated, and replicated over "data"
    data = ("Replicate(), " if len(shape) == 2 else "")
    for k, dim in got["dims"].items():
        model = f"Shard(dim={dim})" if dim is not None else "Replicate()"
        want_placement = f"({data}{model},)" if not data \
            else f"({data}{model})"
        assert got["placements"][k] == want_placement, k
        assert got["moments"][k] == {"exp_avg": want_placement,
                                     "exp_avg_sq": want_placement}, k
