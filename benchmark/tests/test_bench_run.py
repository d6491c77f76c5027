"""A whole run at a tiny size on the CPU (the harness's look for a card
skipped): the result line's format, the numbers printed beside their
limits, the import check, and ``run.py`` refusing to run without a card."""
import json
import subprocess
import sys
import time
import types

import pytest

from benchmark import check, harness

from .conftest import ROOT


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny_cell, trace, capsys):
    result = harness.run(tiny_cell, 2**33 + 1, 0.2, trace, "cpu",
                         time.perf_counter())
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["checks"]) == set(check.NUMBERS)
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    dev = line["device"]
    assert dev["count"] == 1 and "memory_peak_bytes" in dev
    if trace:
        # no device operations on the CPU: no per-layer metric, nothing
        # reported as 0
        assert line["metrics"] == {}
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        names = {m["name"] for m in tiny_cell.end_to_end}
        assert set(line["metrics"]) == names
        for m in tiny_cell.end_to_end:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
            assert line["metrics"][m["name"]]["value"] > 0
    err = capsys.readouterr().err.strip().splitlines()
    assert [e.split(":")[0] for e in err[-len(check.NUMBERS):]] == [
        f"check {k}" for k in check.NUMBERS]


def test_shares_of_a_request_use_its_untraced_latency():
    """The profiler stretches a traced request; the shares of its time
    divide by the untraced latency of the same requests."""
    from benchmark import readers, tracing, yardstick
    t = tracing.Trace(cfg={}, traffic={}, requests=4, frames=8,
                      window_s=4.0, busy_s=2.0, span_device_s={}, ops={},
                      counters={}, flops_per_request=10**12,
                      untraced_s=0.8)
    run = harness.Run(cell=None, setup_s=1.0, trace=t)
    assert readers.idle_pct(run) == pytest.approx(100 * (1 - 0.5 / 0.8))
    assert readers.mfu_pct(run) == pytest.approx(
        100 * 10**12 / 0.8 / yardstick.BF16_TENSOR_FLOPS)
    t.untraced_s = 0.0                  # nothing untraced: nothing read
    assert readers.idle_pct(run) is None and readers.mfu_pct(run) is None


def test_same_seed_same_inputs(tiny_cell):
    from benchmark.traffic import make_pool
    a = make_pool(tiny_cell.config, tiny_cell.traffic, 2**32 + 7, "cpu")
    b = make_pool(tiny_cell.config, tiny_cell.traffic, 2**32 + 7, "cpu")
    c = make_pool(tiny_cell.config, tiny_cell.traffic, 2**32 + 8, "cpu")
    assert all((x["z"] == y["z"]).all() for x, y in zip(a, b))
    assert not (a[0]["z"] == c[0]["z"]).all()


def test_forbidden_modules_compare_whole_names(monkeypatch):
    ok = ("behavior_driven_video_synthesis_tpu_torch",
          "behavior_driven_video_synthesis_tpu_torch.pipeline", "jaxtyping",
          "flaxen")
    bad = ("behavior_driven_video_synthesis_tpu",
           "behavior_driven_video_synthesis_tpu.ops", "jax.numpy", "jaxlib",
           "flax")
    for name in ok + bad:
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert all(name in found for name in bad)
    assert not any(name in found for name in ok)


def test_run_refuses_without_a_card():
    """Without CUDA (or with fewer cards than the cell asks for) run.py
    exits with a code other than 0 and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "alter256.bulk_b20_t50", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        check=False)
    assert proc.returncode != 0
    assert proc.stdout == ""
