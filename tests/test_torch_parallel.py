"""The port's multi-device training (``parallel/``) on the CPU.

``fsdp_leaf_dim`` is JAX ``infer_fsdp_shardings``' rule, shape by shape.
Then ``bdvs-train-torch --device cpu`` runs on 2 spawned processes joined
by gloo (``tests/torch_port_parallel.py``) and in this process without a
process group, on the same configs, and the 2-rank run must equal the
1-process run on the joined batch: a cvbae run of 3 steps with
``dropout_impl: pallas_sharded`` (the plain Philox at each rank's element
offset), an MT-VAE ``--debug`` run, a behavior_net ``--debug`` run whose
flow stage is sharded by FSDP (``training.fsdp``; the 1-process run
keeps the replicated layout), and a cvbae run of 2 steps resumed with
``-r`` for a third.  Equal means: the same steps and generator states,
every parameter and gamma within 1e-4 * (1 + max|ref|) and every Adam
moment within 1e-2 * (1 + max|ref|), and the same metric lines within
1e-4 relative.  The tolerances are f32 rounding: the ranks average their
gradients, a sum in another order (one cvbae step differs by 5e-6 of the
largest moment), and the tiny configs' losses reach 1e7 (gamma * KL at
random init), where the moments' small elements are cancellations of
large terms; Adam's division by sqrt(v) turns a gradient's rounding into
a step of up to its lr where the gradient is near zero.  Rank 0 alone
prints, logs and writes checkpoints.
"""
import os

import numpy as np
import pytest
import torch
import yaml

from jax.sharding import PartitionSpec as P

from behavior_driven_video_synthesis_tpu.parallel import (
    infer_fsdp_shardings, make_mesh)

from behavior_driven_video_synthesis_tpu_torch import main
from behavior_driven_video_synthesis_tpu_torch.core.config import (
    deep_merge, load_config)
from behavior_driven_video_synthesis_tpu_torch.ops import batch_draws
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import elu_dropout
from behavior_driven_video_synthesis_tpu_torch.parallel import (
    fsdp_leaf_dim, mesh)

from torch_port_parallel import (assert_same_lines, assert_same_state,
                                latest, run_ranks)
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TOL, TOL_MOMENT = 1e-4, 1e-2

CVBAE = {
    "data": {"spatial_size": 32, "n_persons": 2, "frames_per_person": 4},
    "architecture": {"nf_start": 4, "nf_max": 8},
    "training": {"batch_size": 4, "end_iteration": 3, "bf16": False,
                 "dropout_prob": 0.1, "dropout_impl": "pallas_sharded",
                 "n_init_batches": 1},
    "logging": {"ckpt_steps": 2, "log_steps": 2}}
MTVAE = {
    "data": {"n_kps": 9, "seq_length": [7, 8], "n_samples": 16},
    "training": {"batch_size": 4, "n_epochs": 2, "n_cond": 3}}
BEHAVIOR = {
    "data": {"n_kps": 9, "n_actions": 3, "seq_length": [8, 9],
             "n_samples": 16},
    "architecture": {"dim_hidden_b": 16, "n_flows": 2},
    "training": {"batch_size": 4, "n_epochs": 2, "information_max": 1.0,
                 "gamma_step": 0.01, "fsdp": True, "fsdp_min_size": 256}}


# -- the FSDP rule ------------------------------------------------------------

SHAPES = [(128, 256), (512, 7), (256,), (129, 131), (), (16, 32, 4),
          (2048, 1024), (64, 64), (3, 4096)]


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("min_size", [1024, 1 << 14])
def test_fsdp_leaf_dim_matches_jax(n, min_size):
    """The dimension FSDP shards each leaf on (None: replicated) is the
    one JAX's spec names, over meshes of 2 and 8 devices."""
    tree = {f"l{i}": np.zeros(s, np.float32) for i, s in enumerate(SHAPES)}
    specs = infer_fsdp_shardings(tree, make_mesh(n), min_size=min_size)
    for i, s in enumerate(SHAPES):
        spec = specs[f"l{i}"].spec
        dim = fsdp_leaf_dim(s, n, min_size)
        want = P() if dim is None else P(*[
            "data" if d == dim else None for d in range(len(s))])
        assert spec == want, (s, spec, dim)


# -- the offset ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [2, 3])
def test_dropout_with_offset_is_the_slice_of_the_global_mask(dtype, rows):
    """Each rank's rows run at offset rank * n_local (any offset, also one
    inside a Philox block of 4) equal the same rows of one call on the
    global batch, forward and backward."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(WORLD * rows, 5, 3, generator=g).to(dtype)
    ct = torch.randn(x.shape, generator=g).to(dtype)
    seed = torch.tensor([11, -4], dtype=torch.int32)
    full = elu_dropout.elu_dropout_plain(x, seed, 0.3)
    dfull = elu_dropout.elu_dropout_backward_plain(x, ct, seed, 0.3)
    n_local = rows * 5 * 3
    for r in range(WORLD):
        sl = slice(r * rows, (r + 1) * rows)
        part = elu_dropout.elu_dropout_forward(x[sl], seed, 0.3,
                                               r * n_local)
        dpart = elu_dropout.elu_dropout_backward(x[sl], ct[sl], seed, 0.3,
                                                 r * n_local)
        assert torch.equal(part, full[sl])
        assert torch.equal(dpart, dfull[sl])
    bits = elu_dropout.dropout_bits(seed, 4 * n_local)
    for off in (1, 2, 3, 5, n_local):
        assert torch.equal(elu_dropout.dropout_bits(seed, 7, off),
                           bits[off:off + 7])
    with pytest.raises(ValueError, match="offset"):
        elu_dropout.dropout_bits(seed, 7, -1)


def test_draws_inside_a_shard_are_the_rows_of_the_global_draw(monkeypatch):
    """ops/batch_draws.py's randn / bernoulli / element_offset inside
    mesh.batch_shard on rank 1 of 2: the rows of the global draw, from a
    generator seeded alike."""
    monkeypatch.setattr(mesh, "world_size", lambda: WORLD)
    monkeypatch.setattr(mesh, "rank", lambda: 1)
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    full = torch.randn(6, 4, generator=g1)
    mask = torch.empty(6, 4).bernoulli_(0.7, generator=g1)
    with mesh.batch_shard():
        part = batch_draws.randn((3, 4), generator=g2)
        pmask = batch_draws.bernoulli(torch.zeros(3, 4), 0.7, generator=g2)
        assert batch_draws.element_offset(12) == 12
    assert torch.equal(part, full[3:]) and torch.equal(pmask, mask[3:])
    assert batch_draws.element_offset(12) == 0
    assert mesh.shard_slice(6) == slice(3, 6)
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_slice(5)


# -- 2 ranks against 1 process ------------------------------------------------

def _config(tmp, name, yaml_name, sections, project="tiny", **over):
    cfg = deep_merge(load_config(os.path.join(REPO, "configs", yaml_name)),
                     deep_merge(sections, over))
    cfg["general"]["base_dir"] = str(tmp / "runs")
    cfg["general"]["project_name"] = project
    path = tmp / f"{name}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _jobs(tmp):
    """(name, [job]) of each scenario, its runs under ``tmp``."""
    cvbae = _config(tmp, "cvbae", "shape_and_pose_net.yaml", CVBAE)
    resume = _config(tmp, "resume", "shape_and_pose_net.yaml", CVBAE,
                     project="resume", training={"end_iteration": 2})
    dumped = str(tmp / "runs" / "cvbae" / "config" / "resume"
                 / "config.yaml")
    cpu = ["--device", "cpu"]
    return [
        ("cvbae", [("main", ["-c", cvbae] + cpu)]),
        ("mtvae", [("main", ["-c", _config(tmp, "mtvae", "mt_vae.yaml",
                                           MTVAE), "-d"] + cpu)]),
        ("behavior", [("main", ["-c", _config(
            tmp, "behavior", "behavior_net.yaml", BEHAVIOR), "-d"] + cpu)]),
        ("resume", [("main", ["-c", resume] + cpu),
                    ("yaml", dumped, {"training": {"end_iteration": 3}}),
                    ("main", ["-c", resume, "-r"] + cpu)]),
    ]


def _run_in_process(jobs):
    from behavior_driven_video_synthesis_tpu_torch.core.config import (
        deep_merge as merge)
    for job in jobs:
        if job[0] == "main":
            main.main(job[1])
        else:
            with open(job[1]) as f:
                cfg = yaml.safe_load(f)
            with open(job[1], "w") as f:
                yaml.safe_dump(merge(cfg, job[2]), f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": tmp dir of the 2-rank runs, "one": of the 1-process runs,
    "out": each rank's printed output}."""
    ranks, one = (tmp_path_factory.mktemp(n) for n in ("ranks", "one"))
    jobs = [j for _, js in _jobs(ranks) for j in js]
    out = run_ranks(WORLD, str(ranks / "store"), jobs)
    _run_in_process([j for _, js in _jobs(one) for j in js])
    return {"ranks": ranks, "one": one, "out": out}


def _assert_same_state(root_a, root_b, experiment, project, role):
    assert_same_state(root_a, root_b, experiment, project, role, TOL,
                      TOL_MOMENT)


def _assert_same_lines(runs, experiment, project):
    assert_same_lines(runs["ranks"], runs["one"], experiment, project)


def test_cvbae_with_pallas_sharded_equals_one_process(runs):
    _assert_same_state(runs["ranks"], runs["one"], "cvbae", "tiny",
                       "reg_ckpt")
    _assert_same_lines(runs, "cvbae", "tiny")


def test_mtvae_equals_one_process(runs):
    _assert_same_state(runs["ranks"], runs["one"], "mtvae", "debug",
                       "reg_ckpt")
    _assert_same_lines(runs, "mtvae", "debug")


def test_fsdp_flow_stage_equals_one_process(runs):
    """The cVAE stage in data parallel, then the flow sharded by FSDP over
    the 2 ranks: the same cVAE and flow checkpoints (written whole) and
    behavior.npz as one process's replicated run."""
    for role in ("reg_ckpt", "flow_ckpt"):
        _assert_same_state(runs["ranks"], runs["one"], "behavior_net",
                           "debug", role)
    _assert_same_lines(runs, "behavior_net", "debug")
    assert "FSDP sharding of flow params + optimizer moments over 2 " \
           "devices" in runs["out"][0]
    assert "training.fsdp_min_size is ignored" in runs["out"][0]
    npz = [dict(np.load(r / "runs" / "behavior_net" / "ckpt" / "debug"
                        / "behavior.npz"))
           for r in (runs["ranks"], runs["one"])]
    assert npz[0].keys() == npz[1].keys()
    for k, v in npz[1].items():
        np.testing.assert_allclose(npz[0][k], v, rtol=0,
                                   atol=TOL * (1 + np.abs(v).max()))


def test_two_ranks_resume_with_r(runs):
    """2 steps, then -r with end_iteration 3 runs the third step: the same
    state as one process doing the same."""
    _assert_same_state(runs["ranks"], runs["one"], "cvbae", "resume",
                       "reg_ckpt")
    assert latest(runs["ranks"], "cvbae", "resume", "reg_ckpt")[1] == 3
    _assert_same_lines(runs, "cvbae", "resume")
    assert "Restored reg_ckpt checkpoint at step 2" in runs["out"][1]


def test_rank_zero_alone_logs_and_writes(runs):
    """Rank 1 prints no metric line; the run directories of the 2-rank
    runs hold the same files as the 1-process runs', each metric line
    once."""
    out0, out1 = runs["out"]
    assert "step 3: loss" in out0 and "step " not in out1.replace(
        "at step", "")

    def files(root):
        found = set()
        for d, _, names in os.walk(root / "runs"):
            found.update(os.path.relpath(os.path.join(d, n), root)
                         for n in names)
        return found
    assert files(runs["ranks"]) == files(runs["one"])
