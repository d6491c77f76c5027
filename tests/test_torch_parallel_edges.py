"""The port's multi-device training at the edges of its layout and launch.

- ``placement_dim``: where ``shard_fsdp`` puts each flow parameter, also
  when the world size divides none of its dimensions (unevenly on
  dimension 0, the one dimension FSDP pads).
- A behavior_net ``--debug`` run on 3 spawned gloo ranks
  (``tests/torch_port_parallel.py``), whose FSDP flow stage shards every
  test-size flow leaf unevenly on dimension 0 (sizes 8 and 32 over 3
  ranks, and ActNorm's (1, 16, 1, 1), which leaves ranks 1 and 2 an empty
  shard, as the full flow's (1, 1024, 1, 1) does over 3 ranks), equals
  one process's replicated run on the joined batch of 6, within
  ``test_torch_parallel.py``'s tolerances (1e-4 of a parameter's scale,
  1e-2 of a moment's: f32 rounding of sums in another order).
- ``-m infer`` on 2 ranks whose collective timeout is 4 s while rank 0's
  evaluation takes 8 s: the other rank does not wait for rank 0 in a
  collective, so the launch ends cleanly.
"""
import os

import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu_torch import main
from behavior_driven_video_synthesis_tpu_torch.parallel.sharding_rules import (
    fsdp_leaf_dim, placement_dim)

from test_torch_parallel import BEHAVIOR, MTVAE, TOL, TOL_MOMENT, _config
from torch_port_parallel import (assert_same_lines, assert_same_state,
                                 run_ranks)
from torch_port_threads import one_torch_thread  # noqa: F401

# -- placement ----------------------------------------------------------------


@pytest.mark.parametrize("shape,n,dim", [
    ((1, 1024, 1, 1), 2, 1), ((1, 1024, 1, 1), 3, 0), ((2048, 512), 3, 0),
    ((512, 2048), 3, 0), ((512, 2048), 8, 1), ((2048, 2048), 7, 0),
    ((1, 16, 1, 1), 3, 0), ((32, 8), 3, 0), ((8,), 3, 0), ((6, 4), 4, 1),
    ((5, 4), 2, 1), ((1024,), 1, 0)])
def test_placement_dim(shape, n, dim):
    """The largest dimension that n divides, else dimension 0."""
    assert placement_dim(shape, n) == dim


def test_placement_dim_is_a_layout_fsdp_takes():
    """FSDP splits only dimension 0 unevenly: every placement is dimension
    0 or a dimension that n divides, and JAX's where JAX shards."""
    rng = np.random.RandomState(0)
    for _ in range(200):
        shape = tuple(int(v) for v in rng.randint(1, 40, rng.randint(1, 5)))
        n = int(rng.randint(1, 9))
        d = placement_dim(shape, n)
        assert d == 0 or shape[d] % n == 0, (shape, n, d)
        jax_dim = fsdp_leaf_dim(shape, n, 0)
        assert d == (0 if jax_dim is None else jax_dim)
    with pytest.raises(ValueError, match="0-d"):
        placement_dim((), 2)


# -- 3 ranks, uneven FSDP shards ----------------------------------------------

THREE = 3
BEHAVIOR_3 = {"data": {"n_samples": 18}, "training": {"batch_size": 6}}


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    ranks, one = (tmp_path_factory.mktemp(n) for n in ("ranks3", "one3"))
    argv = {r: ["-c", _config(r, "behavior", "behavior_net.yaml", BEHAVIOR,
                              **BEHAVIOR_3), "-d", "--device", "cpu"]
            for r in (ranks, one)}
    out = run_ranks(THREE, str(ranks / "store"), [("main", argv[ranks])])
    main.main(argv[one])
    return {"ranks": ranks, "one": one, "out": out}


def test_fsdp_flow_stage_on_three_ranks_equals_one_process(three_ranks):
    ranks, one = three_ranks["ranks"], three_ranks["one"]
    assert "FSDP sharding of flow params + optimizer moments over 3 " \
           "devices" in three_ranks["out"][0]
    for role in ("reg_ckpt", "flow_ckpt"):
        assert_same_state(ranks, one, "behavior_net", "debug", role, TOL,
                          TOL_MOMENT)
    assert_same_lines(ranks, one, "behavior_net", "debug")
    npz = [dict(np.load(r / "runs" / "behavior_net" / "ckpt" / "debug"
                        / "behavior.npz")) for r in (ranks, one)]
    assert npz[0].keys() == npz[1].keys()
    for k, v in npz[1].items():
        np.testing.assert_allclose(npz[0][k], v, rtol=0,
                                   atol=TOL * (1 + np.abs(v).max()))


# -- -m infer outlasting the collective timeout -------------------------------

def test_infer_on_rank_zero_outlasts_the_collective_timeout(tmp_path):
    """Rank 0 evaluates for 8 s under a 4 s collective timeout; rank 1
    returns at once, and both ranks end without an error."""
    cfg = _config(tmp_path, "mtvae", "mt_vae.yaml", MTVAE)
    out = run_ranks(2, str(tmp_path / "store"), [
        ("timeout", 4), ("slow_infer", 8),
        ("main", ["-c", cfg, "-d", "-m", "infer", "--device", "cpu"])])
    assert len(out) == 2
    assert os.path.isfile(tmp_path / "runs" / "mtvae" / "config" / "debug"
                          / "config.yaml")
