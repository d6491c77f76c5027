"""BENCHMARK.json against the benchmark's contract, and every name it holds
resolved to its file."""
import json
import math
import re

import pytest

from benchmark import harness
from benchmark.reference import spec as S
from benchmark.traffic import KEYS

from .conftest import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= manifest["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in manifest[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_fits_the_day(manifest):
    """A full check of 24 cells fits 43,200 s at this run length."""
    runs = 2 + 14 * 24
    assert (runs * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


def test_end_to_end(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(manifest, cell):
    """Each cell finds its configuration, traffic, limits and a reader for
    every metric it reports; every per-layer metric lists only cells that
    report the end-to-end metric it moves, and each cell reports setup_s,
    another end-to-end metric and a per-layer one."""
    c = harness.load_cell(cell)
    assert set(KEYS) <= set(c.traffic)
    assert c.chips == 1
    assert set(c.limits) == {"poses", "keypoints_px", "stickman_share",
                             "frames_off_share"}
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))
    for m in manifest["per_layer"]:
        assert m["moves"] in {x["name"] for x in manifest["end_to_end"]}
        if cell in m["workloads"]:
            assert m["moves"] in e2e


def test_configs(manifest):
    for entry in manifest["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert entry["file"].startswith("benchmark/")
        assert cfg["name"] == entry["name"]
        assert cfg["source"] == entry["source"] and len(entry["source"]) <= 200
        assert cfg["reduced"] == entry["reduced"] == []
        a = cfg["assumed"]
        assert len(a["norm_mean"]) == len(a["norm_std"]) == 51
        assert len(a["dim_to_use"]) == 48


def test_published_parameter_counts():
    """Widths and depths as published: the parameters of each network."""
    def count(spec):
        return sum(math.prod(s) for _, s, k in spec if k != "permutation")
    alter = harness.load_cell("alter256.bulk_b20_t50").config
    org = harness.load_cell("org256_fused.bulk_b20_t50").config
    assert count(S.behavior_spec(alter)) == 10_952_752
    assert count(S.flow_spec(alter)) == 629_575_680
    assert count(S.vunet_spec(alter)) == 14_601_516
    assert count(S.vunet_spec(org)) == 46_608_524
