"""The port's training entry point on the mtvae experiment, on the CPU.

A tiny ``bdvs-train-torch --device cpu --debug`` run of
``configs/mt_vae.yaml`` (9 keypoints, T=8 with n_cond 3, B=4, 16
synthetic sequences: 2 epochs of 4 steps; the width stays the reference's
1024/512, which the JAX experiment hard-codes too) writes a train/ line and a
``reg_ckpt`` save per epoch; ``-r`` after it runs no step; ``-m infer -d``
(2 post-hoc iterations instead of 50, for time) logs a summary under
``infer/`` whose keys are the JAX experiment's on the same data;
``general.visualization`` writes the JAX experiment's videos and
filmstrips without changing the training metrics; and the modules import
no JAX.
"""
import functools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import yaml

from behavior_driven_video_synthesis_tpu_torch import main
from behavior_driven_video_synthesis_tpu_torch.core.config import (
    deep_merge, load_config)
from behavior_driven_video_synthesis_tpu_torch.experiments import mt_vae
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {
    "data": {"n_kps": 9, "seq_length": [7, 8], "n_samples": 16},
    "training": {"batch_size": 4, "n_epochs": 2, "n_cond": 3},
}


def _config(tmp_path, **sections) -> str:
    cfg = deep_merge(load_config(os.path.join(REPO, "configs",
                                              "mt_vae.yaml")),
                     deep_merge(TINY, sections))
    cfg["general"]["base_dir"] = str(tmp_path / "runs")
    path = tmp_path / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _lines(tmp_path, project="debug"):
    with open(tmp_path / "runs" / "mtvae" / "log" / project
              / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mtvae")
    path = _config(tmp)
    out = main.main(["-c", path, "--device", "cpu", "-d"])
    return tmp, path, out


def test_debug_run_trains_logs_and_saves_each_epoch(run):
    tmp, _, out = run
    assert out["state"].step == 8
    assert 22_000_000 < out["n_params"] < 23_000_000
    lines = _lines(tmp)
    assert [r["step"] for r in lines] == [4, 8]
    assert set(lines[0]) == {"step", "time"} | {f"train/{k}" for k in (
        "loss", "rec_loss", "kl_loss", "motion_loss", "cycle_loss",
        "kl_weight", "grad_norm")}
    assert all(np.isfinite(v) for r in lines for v in r.values())
    # the KL ramp spans 4 steps a epoch x max(1, 2 - 10) epochs
    assert lines[1]["train/kl_weight"] == pytest.approx(1.0)
    ckpt = tmp / "runs" / "mtvae" / "ckpt" / "debug" / "reg_ckpt"
    assert sorted(os.listdir(ckpt)) == ["step_4.pt", "step_8.pt"]


def test_restart_runs_no_step(run, monkeypatch, capsys):
    tmp, path, _ = run
    made = []
    monkeypatch.setattr(mt_vae, "make_mtvae_train_step",
                        lambda *a: made.append(a) or (lambda *s, **k: 1 / 0))
    out = main.main(["-c", path, "--device", "cpu", "-d", "-r"])
    assert out["state"].step == 8 and len(made) == 1
    assert "Restored reg_ckpt checkpoint at step 8" in capsys.readouterr().out
    assert len(_lines(tmp)) == 2


def _jax_summary_keys(path, tmp_path, monkeypatch):
    """The keys of the JAX experiment's summary on the same data, on its
    initial weights.  What sets the keys is kept (the predicted length, the
    sources); the rest is cut for time, which the keys do not depend on:
    the width (32), the samples (3), the batches (1) and the post-hoc
    iterations (2)."""
    from behavior_driven_video_synthesis_tpu.core.config import (
        load_config as jload)
    from behavior_driven_video_synthesis_tpu.experiments import (
        mt_vae as jmt_vae)

    monkeypatch.setattr(jmt_vae, "MTVAE", functools.partial(
        jmt_vae.MTVAE, dim=32, z_dim=16))
    cfg = jload(path)
    cfg["metrics"] = {"posthoc_iters": 2}
    dirs = {d: str(tmp_path / "jax" / d) for d in ("ckpt", "log")}
    exp = jmt_vae.MTVAEExperiment(cfg, dirs)
    exp.ckpt_manager = lambda role: types.SimpleNamespace(
        restore_latest=lambda template: (template, 0))
    return set(exp.run_inference(n_samples=3, max_batches=1))


def test_infer_logs_the_jax_experiments_summary_keys(run, tmp_path,
                                                 monkeypatch):
    tmp, path, _ = run
    monkeypatch.setattr(mt_vae, "DEBUG_POSTHOC_ITERS", 2)   # for time
    summary = main.main(["-c", path, "--device", "cpu", "-d", "-m",
                         "infer"])
    assert all(np.isfinite(v) for v in summary.values())
    # 5 predicted frames: the post-hoc start frames clip to 0 and 4
    assert len(summary) == 29 and {"DE_t4", "score_cross_t4"} <= set(summary)
    line = _lines(tmp)[-1]
    assert line["step"] == 0
    assert {k: v for k, v in line.items() if k not in ("step", "time")} \
        == {f"infer/{k}": v for k, v in summary.items()}
    assert set(summary) == _jax_summary_keys(path, tmp_path, monkeypatch)


def test_infer_without_a_checkpoint_raises(tmp_path):
    path = _config(tmp_path)
    with pytest.raises(FileNotFoundError, match="no mtvae checkpoint"):
        main.main(["-c", path, "--device", "cpu", "-m", "infer"])


def _train_lines(tmp_path):
    return [{k: v for k, v in r.items() if k != "time"}
            for r in _lines(tmp_path) if any(k.startswith("train/")
                                             for k in r)]


def test_visualization_is_not_ported(run, tmp_path, monkeypatch):
    """general.visualization (ported, ROADMAP A12): a skeleton video of
    the epoch's last batch after each epoch, with training's metrics those
    of the run without it, and -m infer's filmstrips of the first test
    batch."""
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setattr(mt_vae, "DEBUG_POSTHOC_ITERS", 2)   # for time
    path = _config(tmp_path, general={"visualization": True})
    main.main(["-c", path, "--device", "cpu", "-d"])
    generated = tmp_path / "runs" / "mtvae" / "generated" / "debug"
    videos = {f"e{e:03d}_mtvae_seq{i}.mp4" for e in range(2)
              for i in range(2)}
    assert set(os.listdir(generated)) == videos
    assert _train_lines(tmp_path) == _train_lines(run[0])
    main.main(["-c", path, "--device", "cpu", "-m", "infer", "-d", "-v"])
    assert set(os.listdir(generated)) == videos | {"mtvae_eval_0.png",
                                                   "mtvae_eval_1.png"}
    strips = cv2.imread(str(generated / "mtvae_eval_0.png"))
    assert strips.shape == (4 * 400, 6 * 402 - 2, 3)


def test_mtvae_modules_import_no_jax():
    """A fresh interpreter (tests/conftest.py imports jax in this one)."""
    code = (
        "import sys\n"
        "import behavior_driven_video_synthesis_tpu_torch.main\n"
        "import behavior_driven_video_synthesis_tpu_torch.experiments."
        "mt_vae\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', "
        "'behavior_driven_video_synthesis_tpu'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
