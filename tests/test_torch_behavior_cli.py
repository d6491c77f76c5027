"""The port's training entry point on the behavior_net experiment, on the
CPU.

A tiny ``bdvs-train-torch --device cpu --debug`` run of
``configs/behavior_net.yaml`` (9 keypoints, ``dim_hidden_b`` 16, T=8, B=4,
16 synthetic sequences: 2 epochs of 4 cVAE steps, then 1 flow epoch of 4
steps) writes ``metrics.jsonl`` (train/, eval/ and flow/ lines), its
checkpoints and ``behavior.npz``/``.json``, which ``bdvs-generate-torch
--behavior_params`` serves; ``-r`` after the run runs no step and leaves
the state as it was, and ``-r`` after a lost epoch runs just that epoch
and the flow stage.  What is not ported exits 2 or raises.
"""
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from behavior_driven_video_synthesis_tpu_torch import generate, main
from behavior_driven_video_synthesis_tpu_torch.core.config import (
    deep_merge, load_config)
from behavior_driven_video_synthesis_tpu_torch.experiments import (
    behavior_net as experiment)
from behavior_driven_video_synthesis_tpu_torch.flax_npz import flatten_tree
from behavior_driven_video_synthesis_tpu_torch.models import convert
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.vunet import VUNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {
    "data": {"n_kps": 9, "n_actions": 3, "seq_length": [8, 9],
             "n_samples": 16},
    "architecture": {"dim_hidden_b": 16, "n_flows": 3},
    "training": {"batch_size": 4, "n_epochs": 2, "information_max": 1.0,
                 "gamma_step": 0.01},
}
STEPS, FLOW_STEPS = 8, 4


def _config(tmp_path, **sections) -> str:
    cfg = deep_merge(load_config(os.path.join(REPO, "configs",
                                              "behavior_net.yaml")),
                     deep_merge(TINY, sections))
    cfg["general"]["base_dir"] = str(tmp_path / "runs")
    path = tmp_path / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


class StepCounter:
    """Counts the cVAE and flow steps that the experiment takes."""

    def __init__(self, monkeypatch):
        self.n = {"cvae": 0, "flow": 0}
        for name, stage in (("make_behavior_train_step", "cvae"),
                            ("make_flow_train_step", "flow")):
            monkeypatch.setattr(experiment, name, self._wrap(
                getattr(experiment, name), stage))

    def _wrap(self, make, stage):
        def counted_make(*a, **kw):
            step = make(*a, **kw)

            def counted(*sa, **skw):
                self.n[stage] += 1
                return step(*sa, **skw)
            return counted
        return counted_make


def _run_dir(tmp_path):
    return tmp_path / "runs" / "behavior_net"


def _snapshot(tmp_path):
    """Every file of the run's checkpoint and log directories by content."""
    out = {}
    for sub in ("ckpt", "log"):
        root = _run_dir(tmp_path) / sub / "debug"
        for dirpath, _, files in os.walk(root):
            for name in files:
                p = os.path.join(dirpath, name)
                with open(p, "rb") as f:
                    out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny runs are thousands of small ops: one intra-op thread keeps
    them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory, one_thread):
    tmp = tmp_path_factory.mktemp("behavior_cli")
    path = _config(tmp)
    out = main.main(["-c", path, "--device", "cpu", "--debug"])
    return tmp, path, out


def test_debug_run_writes_metrics_checkpoints_and_behavior_files(run):
    tmp, _, out = run
    assert out["state"].step == STEPS and out["flow_state"].step == FLOW_STEPS
    with open(_run_dir(tmp) / "log" / "debug" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    by_prefix = {p: [r for r in lines if any(k.startswith(p) for k in r)]
                 for p in ("train/", "eval/", "flow/")}
    assert [r["step"] for r in by_prefix["train/"]] == [4, 8]
    assert [r["step"] for r in by_prefix["eval/"]] == [4, 8]
    assert [r["step"] for r in by_prefix["flow/"]] == [FLOW_STEPS]
    assert len(by_prefix["train/"][0]) == 1 + 13
    assert all(np.isfinite(v) for r in lines for v in r.values())
    assert 0.0 < by_prefix["flow/"][0]["flow/flow_ks_p"] <= 1.0
    ckpt = _run_dir(tmp) / "ckpt" / "debug"
    assert sorted(os.listdir(ckpt / "reg_ckpt")) == ["step_4.pt", "step_8.pt"]
    assert os.listdir(ckpt / "flow_ckpt") == ["step_4.pt"]
    assert out["behavior_params"] == str(ckpt / "behavior.npz")
    tree = convert.load_flax_npz(out["behavior_params"])
    assert set(tree) == {"net", "flow"}
    assert set(tree["flow"]) == {"params", "buffers"}
    net_sd = convert.behavior_net_from_flax(tree["net"])
    for k, v in out["modules"]["net"].state_dict().items():
        assert torch.equal(net_sd[k], v), k
    with open(ckpt / "behavior.json") as f:
        meta = json.load(f)
    assert meta["architecture"]["dim_hidden_b"] == 16
    assert meta["general"]["experiment"] == "behavior_net"
    with open(_run_dir(tmp) / "config" / "debug" / "config.yaml") as f:
        assert yaml.safe_load(f)["general"]["tf32"] is False


@pytest.fixture(scope="module")
def synth_params(tmp_path_factory):
    """A tiny cvbae VUNet's synth.npz + .json from a numpy seed."""
    d = tmp_path_factory.mktemp("synth")
    vunet = init_random_(VUNet(spatial_size=32, nf_start=4, nf_max=8),
                         np.random.RandomState(0))
    convert.save_flax_npz(str(d / "synth.npz"), {
        "vunet": convert.vunet_alter_to_flax(vunet.state_dict())})
    with open(d / "synth.json", "w") as f:
        json.dump({"data": {"spatial_size": 32},
                   "architecture": {"nf_start": 4, "nf_max": 8},
                   "general": {"experiment": "cvbae"}}, f)
    return str(d / "synth.npz")


@pytest.mark.parametrize("mode", ["sample", "transfer"])
def test_generate_serves_the_trained_behavior(run, synth_params, tmp_path,
                                              mode):
    _, _, out = run
    argv = ["--behavior_params", out["behavior_params"], "--synth_params",
            synth_params, "--device", "cpu", "--length", "3", "--batch",
            "2", "--mode", mode, "--out", str(tmp_path / "served")]
    if mode == "transfer":
        rng = np.random.RandomState(0)
        np.savez(tmp_path / "req.npz",
                 x_start=rng.randn(2, 9).astype(np.float32),
                 source=rng.randn(2, 8, 9).astype(np.float32))
        argv += ["--request", str(tmp_path / "req.npz")]
    man = generate.main(argv)
    assert man["flow"] is (mode == "sample")
    assert len(man["videos"]) == 2
    for p in man["videos"].values():
        assert os.path.getsize(p) > 0


def test_restart_after_the_run_runs_no_step(run, monkeypatch):
    tmp, path, out = run
    before = _snapshot(tmp)
    counter = StepCounter(monkeypatch)
    again = main.main(["-c", path, "--device", "cpu", "--debug", "-r"])
    assert counter.n == {"cvae": 0, "flow": 0}
    assert again["state"].step == STEPS
    assert again["flow_state"].step == FLOW_STEPS
    after = _snapshot(tmp)
    assert after.keys() == before.keys()
    for k in before:
        if k != "behavior.npz":      # rewritten: new zip time stamps
            assert after[k] == before[k], k
    arrays = [flatten_tree(convert.load_flax_npz(io.BytesIO(s[
        "behavior.npz"]))) for s in (before, after)]
    assert arrays[0].keys() == arrays[1].keys()
    for k, v in arrays[0].items():
        assert np.array_equal(arrays[1][k], v), k
    assert float(again["state"].gamma) == float(out["state"].gamma)


def test_restart_after_a_lost_epoch_runs_the_rest(tmp_path, monkeypatch):
    """The newest cVAE save and the flow's are gone (a run cut in its last
    epoch): -r restores step 4 and runs epoch 2 and the flow stage; the
    config comes from the run directory, not from the file given."""
    path = _config(tmp_path)
    main.main(["-c", path, "--device", "cpu", "--debug"])
    ckpt = _run_dir(tmp_path) / "ckpt" / "debug"
    os.remove(ckpt / "reg_ckpt" / "step_8.pt")
    shutil.rmtree(ckpt / "flow_ckpt")
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["architecture"]["dim_hidden_b"] = 32     # ignored on a restart
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    counter = StepCounter(monkeypatch)
    out = main.main(["-c", path, "--device", "cpu", "--debug", "-r"])
    assert counter.n == {"cvae": STEPS // 2, "flow": FLOW_STEPS}
    assert out["state"].step == STEPS
    assert out["modules"]["net"].dim_hidden_b == 16
    assert sorted(os.listdir(ckpt / "reg_ckpt")) == ["step_4.pt", "step_8.pt"]


@pytest.mark.parametrize("flags,message", [
    (["-f"], "flow-only training, ROADMAP A6b"),
    (["-m", "infer"], "-m infer: not ported yet")])
def test_unported_options_exit(tmp_path, capsys, flags, message):
    """cvbae's -r and -f: tests/test_torch_train_cli.py."""
    with pytest.raises(SystemExit) as e:
        main.main(["-c", _config(tmp_path), "--device", "cpu", *flags])
    assert e.value.code == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "runs").exists()


@pytest.mark.parametrize("sections,error,match", [
    ({"training": {"bf16": True}}, NotImplementedError, "A6b"),
    ({"training": {"only_flow": True}}, NotImplementedError, "A6b"),
    ({"training": {"fsdp": True}}, NotImplementedError, "A14"),
    ({"general": {"visualization": True}}, NotImplementedError, "A6b"),
    ({"data": {"dataset": "human3.6m"}}, ValueError, "A6b")])
def test_unported_config_raises(tmp_path, sections, error, match):
    path = _config(tmp_path, **sections)
    with pytest.raises(error, match=match):
        main.main(["-c", path, "--device", "cpu", "--debug"])


def test_behavior_modules_import_no_jax():
    """A fresh interpreter (tests/conftest.py imports jax in this one)."""
    code = (
        "import sys\n"
        "import behavior_driven_video_synthesis_tpu_torch.experiments."
        "behavior_net\n"
        "import behavior_driven_video_synthesis_tpu_torch.core.checkpoint\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', "
        "'behavior_driven_video_synthesis_tpu'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
