"""The port's original-VUNet (org) training step against the JAX
package's, on the CPU.

Three steps of ``make_org_vunet_train_step`` in each package from the
same numpy-seeded weights, batch and posterior noise
(``torch_port_org_train.py``: 32 px, nf 4->8, B=2, a 30-channel part
stack, Laplacian pyramid, f32, dropout 0, the KL ramp stepping from
``kl_init`` to ``kl_max`` on the third step): the metrics at rtol 1e-4,
every leaf's update (after minus before) within 5 % of the JAX update.
Also: ``kl_ramp`` equals the JAX schedule; ``grad_accum`` 2 equals 1;
remat (``rnb`` and ``subnet``) equals remat off with dropout on, under
both dropout routes (the ELU+dropout kernel's plain version on the CPU);
and the golden file ``chip_smoke.py`` reads equals a live JAX run.
"""
import json

import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu.core import schedules as jsched

from behavior_driven_video_synthesis_tpu_torch.core import schedules
from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
    flatten_tree, unflatten_tree)

import make_torch_port_org_train_golden as golden_maker
import torch_port_org_train as T
from torch_port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def inputs():
    return T.make_inputs(0)


@pytest.fixture(scope="module")
def jax_run(inputs):
    return T.jax_steps(*inputs)


def test_kl_ramp_matches_jax():
    total = 40
    for step in range(total + 3):
        for kw in ({}, {"kl_init": 0.01, "kl_max": 0.5}):
            mine = schedules.kl_ramp(step, total, **kw)
            ref = float(jsched.kl_ramp(step, total, **kw))
            assert np.isclose(mine, ref, rtol=1e-6, atol=0), (step, kw)
    assert schedules.kl_ramp(0, total) == 1e-6
    assert schedules.kl_ramp(total, total) == 1.0
    assert np.isclose(schedules.kl_ramp(25, total), 0.5 + 0.5e-6)


def test_org_steps_match_jax(inputs, jax_run):
    tree, _, _ = inputs
    metrics, after = T.port_steps(*inputs)
    ref_metrics, ref_after = jax_run
    T.check_metrics(metrics, ref_metrics)
    T.check_updates(tree, after, ref_after)
    assert [m["kl_weight"] for m in metrics] == pytest.approx(
        [0.01, 0.01, 1.0])
    m = metrics[-1]
    assert np.isclose(m["loss"], m["likelihood_loss"] + m["kl_loss"],
                      rtol=1e-6)


def test_grad_accum_two_equals_one(inputs):
    tree, _, _ = inputs
    one, after_one = T.port_steps(*inputs)
    two, after_two = T.port_steps(*inputs, grad_accum=2)
    for a, b in zip(two, one):
        for k in b:
            assert np.isclose(a[k], b[k], rtol=1e-5, atol=1e-6), k
    errs = T.update_errors(tree, after_two, after_one)
    assert max(errs.values()) <= 1e-3


@pytest.mark.parametrize("dropout_impl", ["flax", "pallas"])
@pytest.mark.parametrize("remat", ["rnb", "subnet"])
def test_remat_matches_remat_off(inputs, remat, dropout_impl):
    """Remat recomputes every block in the backward pass; with dropout on,
    the recomputation must draw the forward's masks (the generators are
    explicit, so torch's own RNG stash does not cover them)."""
    runs = {}
    for r in (False, remat):
        cfg = T.config(dropout_prob=0.2, dropout_impl=dropout_impl,
                       remat=r)
        gens = (torch.Generator().manual_seed(1),
                torch.Generator().manual_seed(2))
        runs[r] = T.port_steps(*inputs, n_steps=2, cfg=cfg,
                               generators=gens)
    (m_off, after_off), (m_on, after_on) = runs[False], runs[remat]
    for a, b in zip(m_on, m_off):
        for k in b:
            assert np.isclose(a[k], b[k], rtol=1e-6, atol=0), k
    fa, fb = flatten_tree(after_on), flatten_tree(after_off)
    for k in fb:
        np.testing.assert_allclose(fa[k], fb[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_golden_equals_a_live_jax_run(inputs, jax_run):
    """tests/golden/torch_port_org_train_small.npz is what the maker
    writes from the JAX step now, and its seed rebuilds the inputs."""
    with np.load(golden_maker.OUT) as data:
        golden = unflatten_tree({k: data[k] for k in data.files})
    assert json.loads(bytes(golden["config"]).decode()) == T.config()
    tree, _, _ = T.golden_inputs(golden)
    metrics, after = jax_run
    stored = golden_maker.golden_arrays(*inputs, metrics, after)
    live = flatten_tree(golden)
    assert set(stored) == set(live)
    for k, v in stored.items():
        np.testing.assert_allclose(
            np.asarray(live[k], np.float64), np.asarray(v, np.float64),
            rtol=2e-3 if k.startswith("update/") else 1e-6,
            atol=2e-3 * np.abs(np.asarray(v, np.float64)).max()
            if k.startswith("update/") else 1e-7, err_msg=k)
    # the port holds the golden as chip_smoke holds it on the card
    mine, mine_after = T.port_steps(tree, *T.make_inputs(0)[1:])
    worst_m, worst_u = T.check_against_golden(mine, tree, mine_after,
                                              golden)
    assert worst_m <= 1.0 and worst_u <= 1.0, (worst_m, worst_u)
