"""The port's training entry point on the behavior_net experiment, on the
CPU.

A tiny ``bdvs-train-torch --device cpu --debug`` run of
``configs/behavior_net.yaml`` (9 keypoints, ``dim_hidden_b`` 16, T=8, B=4,
16 synthetic sequences: 2 epochs of 4 cVAE steps, then 1 flow epoch of 4
steps) writes ``metrics.jsonl`` (train/, eval/ and flow/ lines), its
checkpoints and ``behavior.npz``/``.json``, which ``bdvs-generate-torch
--behavior_params`` serves; ``-r`` after the run runs no step and leaves
the state as it was, and ``-r`` after a lost epoch runs just that epoch
and the flow stage.  A tiny run without ``--debug`` (its inference capped
through ``metrics``) is evaluated with ``-m infer``, and ``-f`` in a
sibling project trains the flow alone over its cVAE; a ``training.bf16``
run, an ``h36m_synthetic`` run and a ``human3.6m`` run on a tiny
``annot_export.h5`` train and infer through the CLI too.  ``-v`` writes
the figures without changing the training metrics, ``-v -s`` with a tiny
cvbae run also the RGB figures.  What is not ported raises.
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
    assert len(by_prefix["train/"][0]) == 2 + 13    # step, time, metrics
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


# a run without --debug, whose inference caps its cache and post-hoc
# iterations through the config (--debug would train the probes 50
# iterations): 1 epoch of 4 cVAE steps, 5 flow epochs of 4 steps
INFER = {"general": {"project_name": "tiny"},
         "training": {"n_epochs": 1},
         "metrics": {"max_cache": 4, "posthoc_iters": 2}}
# the inference summary's keys at T=8 (start frames 0 and 7)
SOURCES = ("prior", "cross", "self", "flow")
SUMMARY_KEYS = (
    {"recon_mse", "ADE_c", "FDE_c", "recon_mu", "recon_mu_std",
     "distance_mu", "distance_mu_std", "flow_ks_p", "DE_t0", "DE_t7", "DE",
     "loss_regressor_t0", "loss_regressor_t7", "loss_regressor_posthoc",
     "CF_cross", "CF_logits_l2", "CF_logits_cos", "CF_action",
     "CF_action_beta"}
    | {f"{m}_{s}" for m in ("APD", "ASD", "FSD", "ADE", "FDE")
       for s in ("prior", "flow")}
    | {f"{p}_{s}{t}" for p in ("score", "acc") for s in SOURCES
       for t in ("_t0", "_t7", "")})


def _infer_lines(run_dir, project):
    with open(run_dir / "log" / project / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    return [r for r in lines if any(k.startswith("infer/") for k in r)]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory, one_thread):
    """A tiny run trained without --debug, then -m infer on it."""
    tmp = tmp_path_factory.mktemp("behavior_infer")
    path = _config(tmp, **INFER)
    out = main.main(["-c", path, "--device", "cpu"])
    summary = main.main(["-c", path, "--device", "cpu", "-m", "infer"])
    return tmp, path, out, summary


def test_infer_after_training_logs_an_infer_line(tiny_run):
    """-m infer restores both stages and logs the JAX run's summary keys
    under infer/ (their values are held against the JAX run in
    tests/test_torch_behavior_infer.py)."""
    tmp, _, out, summary = tiny_run
    assert out["state"].step == 4 and out["flow_state"].step == 20
    assert set(summary) == SUMMARY_KEYS and len(SUMMARY_KEYS) == 53
    assert all(np.isfinite(v) for v in summary.values())
    lines = _infer_lines(_run_dir(tmp), "tiny")
    assert len(lines) == 1 and lines[0]["step"] == 0
    assert {k: v for k, v in lines[0].items()
            if k not in ("step", "time")} == {
        f"infer/{k}": v for k, v in summary.items()}


def test_infer_without_a_checkpoint_raises(tmp_path):
    path = _config(tmp_path, **INFER)
    with pytest.raises(FileNotFoundError, match="no behavior checkpoint"):
        main.main(["-c", path, "--device", "cpu", "-m", "infer"])


@pytest.mark.parametrize("how", ["-f", "only_flow"])
def test_flow_only_in_a_sibling_project(tiny_run, monkeypatch, how):
    """-f (or training.only_flow) in another project of the same
    experiment finds the tiny run's reg_ckpt, runs no cVAE step and trains
    the flow n_epochs (1) epochs over that net, which its behavior.npz
    carries unchanged."""
    tmp, path, out, _ = tiny_run
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["general"]["project_name"] = f"sibling_{how.strip('-')}"
    if how == "only_flow":
        cfg["training"]["only_flow"] = True
    sibling = tmp / f"{how.strip('-')}.yaml"
    with open(sibling, "w") as f:
        yaml.safe_dump(cfg, f)
    counter = StepCounter(monkeypatch)
    flow_out = main.main(["-c", str(sibling), "--device", "cpu"]
                         + (["-f"] if how == "-f" else []))
    assert counter.n == {"cvae": 0, "flow": 4}
    assert flow_out["flow_state"].step == 4
    ckpt = _run_dir(tmp) / "ckpt" / cfg["general"]["project_name"]
    assert os.listdir(ckpt / "reg_ckpt") == []
    assert os.listdir(ckpt / "flow_ckpt") == ["step_4.pt"]
    for k, v in out["modules"]["net"].state_dict().items():
        assert torch.equal(flow_out["modules"]["net"].state_dict()[k], v), k
    tree = convert.load_flax_npz(flow_out["behavior_params"])
    assert set(tree) == {"net", "flow"}
    with open(_run_dir(tmp) / "config" / cfg["general"]["project_name"]
              / "config.yaml") as f:
        assert yaml.safe_load(f)["training"]["only_flow"] is True


def test_flow_only_without_a_cvae_checkpoint_raises(tmp_path):
    path = _config(tmp_path, **INFER)
    with pytest.raises(FileNotFoundError, match="no cVAE checkpoint"):
        main.main(["-c", path, "--device", "cpu", "-f"])


def test_bf16_run_trains_and_infers_in_bf16_with_float32_parameters(
        tmp_path):
    """training.bf16: every module computes in bf16, the parameters and
    Adam states stay float32, the metrics are finite, and -m infer runs
    on the bf16 modules (the step is held against the JAX bf16 step in
    tests/test_torch_behavior_infer.py)."""
    path = _config(tmp_path, training={"bf16": True, "n_epochs": 1},
                   **{k: v for k, v in INFER.items() if k != "training"})
    out = main.main(["-c", path, "--device", "cpu"])
    assert out["state"].step == 4 and out["flow_state"].step == 20
    for name, m in out["modules"].items():
        assert (m.decoder if name == "net" else m).dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in m.parameters()), name
    for opt in (o for k, o in out["state"].optimizers.items()
                if k != "net_lr"):
        for st in opt.state.values():
            assert st["exp_avg"].dtype == torch.float32
    summary = main.main(["-c", path, "--device", "cpu", "-m", "infer"])
    assert set(summary) == SUMMARY_KEYS
    with open(_run_dir(tmp_path) / "log" / "tiny" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert lines and all(np.isfinite(v) for r in lines for v in r.values())


@pytest.mark.parametrize("dataset", ["h36m_synthetic", "human3.6m"])
def test_human36m_trains_and_infers(tmp_path, dataset):
    """dataset: h36m_synthetic (2 train subjects x 3 actions x 24 frames)
    and human3.6m (a tiny annot_export.h5: 1 train subject x 2 actions x
    30 frames) through the CLI: 51 keypoints from the data, the heads
    sized by the action ids' span, the sequence sampler and loader; then
    -m infer (the data path is held against the JAX package in
    tests/test_torch_sequence_data.py)."""
    data = {"dataset": dataset, "n_data_workers": 2}
    if dataset == "human3.6m":
        pytest.importorskip("h5py")
        from torch_port_h36m import write_annot_export
        write_annot_export(str(tmp_path))
        data["datapath"] = str(tmp_path)
        steps, n_labels = 60 // 4, 3          # actions 2 and 4
    else:
        data["n_frames_per_video"] = 24
        steps, n_labels = 2 * 3 * 24 // 4, 4  # actions 2, 4 and 5
    path = _config(tmp_path, data=data, **INFER)
    out = main.main(["-c", path, "--device", "cpu"])
    assert out["modules"]["net"].n_kps == 51
    assert out["modules"]["cls_beta"].fc1.out_features == n_labels
    assert out["state"].step == steps and out["flow_state"].step == 5 * steps
    summary = main.main(["-c", path, "--device", "cpu", "-m", "infer"])
    assert set(summary) == SUMMARY_KEYS
    assert all(np.isfinite(v) for v in summary.values())
    assert len(_infer_lines(_run_dir(tmp_path), "tiny")) == 1


@pytest.mark.parametrize("sections,match", [
    ({"training": {"fsdp": True}}, "falling back to the replicated layout"),
    ({"general": {"visualization": True}}, "e001_eval_grid")])
def test_unported_config_raises(tmp_path, capsys, sections, match):
    """training.fsdp, ported (A14b), trains without a process group in the
    replicated layout and says so, as the JAX experiment does on one
    device; general.visualization, ported (A12), writes the figures of
    each eval (synthetic data has no cameras or norm statistics, so no RGB
    video)."""
    path = _config(tmp_path, **sections)
    main.main(["-c", path, "--device", "cpu", "--debug"])
    if "fsdp" in sections.get("training", {}):
        out = capsys.readouterr().out
        assert f"flow stage: training.fsdp requested but only one device " \
               f"is visible — {match}" in out
        assert not (_run_dir(tmp_path) / "generated" / "debug").exists() \
            or not os.listdir(_run_dir(tmp_path) / "generated" / "debug")
        return
    generated = _run_dir(tmp_path) / "generated" / "debug"
    assert sorted(os.listdir(generated)) == sorted(
        f"e{e:03d}_{name}.mp4" for e in range(2) for name in (
            "seq0_transfer", "seq0_samples", "seq1_transfer", "seq1_samples",
            "latent_interp", "eval_grid"))
    assert match + ".mp4" in os.listdir(generated)


def _metric_lines(run_dir, project):
    with open(run_dir / "log" / project / "metrics.jsonl") as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in f]


def test_visualization_leaves_training_metrics_unchanged(tmp_path):
    """The figures draw from a generator of their own and read a test
    loader of their own: a -v run logs the metrics of a run without it."""
    lines = {}
    for flags in ((), ("-v",)):
        tmp = tmp_path / ("v" if flags else "plain")
        tmp.mkdir()
        main.main(["-c", _config(tmp), "--device", "cpu", "--debug",
                   *flags])
        lines[flags] = _metric_lines(_run_dir(tmp), "debug")
        assert bool(os.listdir(_run_dir(tmp) / "generated" / "debug")) \
            == bool(flags)
    assert lines[()] == lines[("-v",)]
    assert {k.split("/")[0] for r in lines[()] for k in r if "/" in k} == {
        "train", "eval", "flow"}


def _tiny_cvbae_run(tmp_path) -> str:
    """A cvbae run of 3 steps at 32 px, nf 4->8 (its experiment dir)."""
    cfg = deep_merge(load_config(os.path.join(REPO, "configs",
                                              "shape_and_pose_net.yaml")), {
        "general": {"base_dir": str(tmp_path / "synth"),
                    "project_name": "tiny"},
        "data": {"spatial_size": 32, "n_persons": 2, "frames_per_person": 4},
        "architecture": {"nf_start": 4, "nf_max": 8},
        "training": {"batch_size": 2, "end_iteration": 3, "bf16": False,
                     "n_init_batches": 1}})
    path = tmp_path / "cvbae.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    main.main(["-c", str(path), "--device", "cpu"])
    return str(tmp_path / "synth" / "cvbae")


# the files the JAX hooks name: per eval (tag e<epoch>_) and in -m infer
# (tag infer_); the paper figures under figures/ are rewritten by each
RGB_FILES = {f"{{tag}}rgb{i}.mp4" for i in range(2)} | {
    f"figures/{name}" for name in (
        "enrollment-bid0-sid0.png", "enrollment-rgb-bid0-sid0.png",
        "enrollment-overlay-bid0-sid0.png", "enrollment_vid-bid0-sid0.mp4",
        "sid_sid0/samples-sid0.png", "sid_sid0/samples-sid0.mp4",
        *(f"interp-{p}-cam{c}.{ext}" for p in ("slerp", "linear")
          for c in range(2) for ext in ("png", "mp4")))}


def test_cli_renders_rgb_figures_with_a_synthesis_run(tmp_path, capsys):
    """-v -s on h36m_synthetic (cameras and norm statistics, no image
    files: zero appearances, as in JAX) with a tiny cvbae run: the epoch's
    skeleton videos and RGB videos, the paper figures (both cameras), then
    -m infer's embedding, histogram, neighbour figure and RGB videos; every
    image and video decodes."""
    cv2 = pytest.importorskip("cv2")
    synth = _tiny_cvbae_run(tmp_path)
    path = _config(tmp_path, data={"dataset": "h36m_synthetic",
                                   "n_frames_per_video": 24,
                                   "n_data_workers": 0}, **INFER)
    main.main(["-c", path, "--device", "cpu", "-v", "-s", synth])
    main.main(["-c", path, "--device", "cpu", "-m", "infer", "-v", "-s",
               os.path.join(synth, "ckpt", "tiny")])
    assert "a zero appearance" in capsys.readouterr().out
    root = _run_dir(tmp_path) / "generated" / "tiny"
    written = {os.path.relpath(os.path.join(d, f), root)
               for d, _, files in os.walk(root) for f in files}
    epoch = {f"e000_{n}.mp4" for n in (
        "seq0_transfer", "seq0_samples", "seq1_transfer", "seq1_samples",
        "latent_interp", "eval_grid")}
    infer = {"beta_embedding.png", "recon_error_hist.png",
             "beta_nearest_neighbours.png"}
    assert written == (epoch | infer | {f.format(tag="e000_")
                                        for f in RGB_FILES}
                       | {f.format(tag="infer_") for f in RGB_FILES})
    for f in written:
        p = str(root / f)
        if f.endswith(".png"):
            assert cv2.imread(p) is not None, f
        else:
            cap = cv2.VideoCapture(p)
            assert cap.get(cv2.CAP_PROP_FRAME_COUNT) > 0, f
            cap.release()


def test_missing_human36m_dataset_raises(tmp_path):
    path = _config(tmp_path, data={"dataset": "human3.6m",
                                   "datapath": str(tmp_path / "none")})
    with pytest.raises(FileNotFoundError, match="annot_export.h5"):
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
