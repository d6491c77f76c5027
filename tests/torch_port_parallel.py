"""Runs of the port's training CLI over N spawned CPU processes (gloo).

:func:`run_ranks` spawns ``world`` processes that join one process group
through a ``file://`` store under the caller's directory (no port, so that
test processes running side by side do not collide) and run the same list of
jobs in order: ``("main", argv)`` calls ``main.main(argv)``, ``("yaml",
path, updates)`` merges ``updates`` into a config file on rank 0 (the
others wait), ``("timeout", seconds)`` meets the other ranks and then sets
the group's collective timeout, and ``("slow_infer", seconds)`` makes the
experiments' ``run_inference`` sleep that long instead of evaluating.
Each rank's printed output goes to ``rank<r>.out`` there, and the stacks
of a rank that dies by a signal to ``rank<r>.fault``.  The workers import
neither JAX nor the JAX package.

:func:`assert_same_state` and :func:`assert_same_lines` hold the
checkpoints and metric lines of two runs against each other.
"""
import contextlib
import datetime
import faulthandler
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import yaml


def _slow_infer(main, seconds):
    """Have the experiments that ``main`` selects sleep ``seconds`` in
    ``run_inference``."""
    select = main.select_experiment

    def selected(*args, **kwargs):
        exp = select(*args, **kwargs)
        exp.run_inference = lambda: time.sleep(seconds) or {"slept":
                                                            seconds}
        return exp
    main.select_experiment = selected


def _worker(rank, world, store, jobs):
    faulthandler.enable(open(os.path.join(store, f"rank{rank}.fault"), "w"))
    torch.set_num_threads(1)
    from behavior_driven_video_synthesis_tpu_torch import main
    from behavior_driven_video_synthesis_tpu_torch.core.config import (
        deep_merge)
    dist.init_process_group("gloo", init_method=f"file://{store}/pg",
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(store, f"rank{rank}.out"), "w") as out, \
                contextlib.redirect_stdout(out):
            for job in jobs:
                if job[0] == "main":
                    main.main(job[1])
                elif job[0] == "yaml":
                    if rank == 0:
                        with open(job[1]) as f:
                            cfg = yaml.safe_load(f)
                        with open(job[1], "w") as f:
                            yaml.safe_dump(deep_merge(cfg, job[2]), f)
                    dist.barrier()
                elif job[0] == "timeout":
                    dist.barrier()
                    dist.distributed_c10d._set_pg_timeout(
                        datetime.timedelta(seconds=job[1]))
                elif job[0] == "slow_infer":
                    _slow_infer(main, job[1])
                else:
                    raise ValueError(f"unknown job {job[0]!r}")
    finally:
        dist.destroy_process_group()


def run_ranks(world, store, jobs, timeout=240.0):
    """Run ``jobs`` on ``world`` spawned ranks; raises if a rank fails or
    the whole run outlasts ``timeout`` seconds."""
    os.makedirs(store, exist_ok=True)
    ctx = mp.start_processes(_worker, args=(world, store, jobs),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{timeout} s")
    except mp.ProcessExitedException as e:
        # a rank that died by a signal: its Python stacks at the fault
        faults = "".join(
            open(os.path.join(store, f"rank{r}.fault")).read()
            for r in range(world))
        raise RuntimeError(f"{e}\n{faults}") from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [open(os.path.join(store, f"rank{r}.out")).read()
            for r in range(world)]


# -- comparing two runs -------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def latest(root, experiment, project, role):
    """(payload, step) of the newest save of a run under ``root``."""
    from behavior_driven_video_synthesis_tpu_torch.core.checkpoint import (
        CheckpointManager)
    out = CheckpointManager(str(root / "runs" / experiment / "ckpt"
                                / project / role)).restore_latest()
    assert out is not None, (experiment, project, role)
    return out


def assert_same_state(root_a, root_b, experiment, project, role, tol,
                      tol_moment):
    """The newest saves of a role of two runs: the same step and generator
    states, every float tensor within ``tol`` (Adam moments
    ``tol_moment``) times 1 + its largest magnitude, the rest equal."""
    (a, step_a), (b, step_b) = (latest(r, experiment, project, role)
                                for r in (root_a, root_b))
    assert step_a == step_b
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if "generator" in k:
            continue     # the generator states: equal draws, checked below
        u, v = fa[k], fb[k]
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            if v.numel() == 0:
                continue
            v = v.float()
            t = (tol_moment if "exp_avg" in k else tol) * (
                1 + float(v.abs().max()))
            assert float((u.float() - v).abs().max()) <= t, (
                k, float((u.float() - v).abs().max()), t)
        elif isinstance(v, torch.Tensor):
            assert torch.equal(u, v), k
        else:
            assert u == v, k
    gens = [k for k in fa if "generator" in k]
    for k in gens:
        assert torch.equal(fa[k], fb[k]), k


def _lines(root, experiment, project):
    with open(root / "runs" / experiment / "log" / project
              / "metrics.jsonl") as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in f]


def assert_same_lines(root_a, root_b, experiment, project):
    """The same metric lines of two runs, within 1e-4 relative."""
    a, b = (_lines(r, experiment, project) for r in (root_a, root_b))
    assert [sorted(x) for x in a] == [sorted(x) for x in b]
    for x, y in zip(a, b):
        for k in y:
            np.testing.assert_allclose(x[k], y[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
