"""The port's training entry point (``bdvs-train-torch``) and its synthetic
dataset, on the CPU.

A tiny cvbae run (32 px, nf 4->8, B=2, 3 steps, ``dropout_impl: pallas``,
which on CPU tensors runs the kernel's plain version) writes a
``synth.npz`` that ``bdvs-generate-torch --device cpu`` serves; the CLI
evaluates (``-m infer``) and resumes (``-r``) the run, warm-starts another
from it (``-p``), asks on a terminal whether to resume it (``fresh_start``
on "n"), re-roots it under ``DATAPATH``, accepts ``--gpu``, refuses what
is not ported, and without ``--device cpu`` it needs a card; the metric
log writes its lines and forwards them to wandb.  The dataset draws what
the JAX dataset draws from the same seeds.
"""
import io
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from behavior_driven_video_synthesis_tpu.data.synthetic_images import (
    SyntheticImageDataset as JaxDataset)

from behavior_driven_video_synthesis_tpu_torch import generate, main
from behavior_driven_video_synthesis_tpu_torch.core.config import (
    deep_merge, load_config)
from behavior_driven_video_synthesis_tpu_torch.data.synthetic_images import (
    SyntheticImageDataset)
from behavior_driven_video_synthesis_tpu_torch.models import convert
from behavior_driven_video_synthesis_tpu_torch.models.behavior import (
    ResidualBehaviorNet)
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(tmp_path, **training):
    cfg = load_config(os.path.join(REPO, "configs",
                                   "shape_and_pose_net.yaml"))
    cfg = deep_merge(cfg, {
        "general": {"base_dir": str(tmp_path / "runs"),
                    "project_name": "tiny"},
        "data": {"spatial_size": 32, "n_persons": 2,
                 "frames_per_person": 4},
        "architecture": {"nf_start": 4, "nf_max": 8},
        "training": deep_merge({"batch_size": 2, "end_iteration": 3,
                                "bf16": False, "dropout_prob": 0.1,
                                "dropout_impl": "pallas",
                                "n_init_batches": 1}, training),
        "logging": {"ckpt_steps": 2}})
    path = tmp_path / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_config_reads_python_tuples():
    cfg = load_config(os.path.join(REPO, "configs",
                                   "shape_and_pose_net.yaml"))
    assert cfg["training"]["adam_betas"] == (0.5, 0.9)
    assert cfg["general"]["experiment"] == "cvbae"


def test_train_cli_then_serve(tmp_path):
    out = main.main(["-c", _config(tmp_path), "--device", "cpu"])
    assert out["state"].step == 3
    ckpt = tmp_path / "runs" / "cvbae" / "ckpt" / "tiny"
    assert out["synth_params"] == str(ckpt / "synth.npz")
    dumped = load_config(tmp_path / "runs" / "cvbae" / "config" / "tiny"
                         / "config.yaml")
    assert dumped["general"]["tf32"] is False
    with open(tmp_path / "runs" / "cvbae" / "log" / "tiny"
              / "metrics.jsonl") as f:
        last = json.loads(f.readlines()[-1])
    assert last["step"] == 3 and np.isfinite(last["train/loss"])
    tree = convert.load_flax_npz(out["synth_params"])
    assert set(tree) == {"vunet", "regressor"}
    # the trained weights are what the run's modules hold
    sd = convert.vunet_alter_from_flax(tree["vunet"])
    for k, v in out["vunet"].state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)

    rng = np.random.RandomState(0)
    behavior = init_random_(ResidualBehaviorNet(48, 16), rng)
    convert.save_flax_npz(str(tmp_path / "behavior.npz"), {
        "net": convert.behavior_net_to_flax(behavior.state_dict())})
    with open(tmp_path / "behavior.json", "w") as f:
        json.dump({"architecture": {"dim_hidden_b": 16}}, f)
    man = generate.main(["--behavior_params", str(tmp_path / "behavior.npz"),
                         "--synth_params", out["synth_params"],
                         "--length", "3", "--batch", "2", "--device", "cpu",
                         "--out", str(tmp_path / "served")])
    assert man["spatial"] == 32 and len(man["videos"]) == 2
    assert man["tf32"] is False
    assert all(os.path.getsize(p) > 0 for p in man["videos"].values())


def test_train_cli_needs_a_card_or_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main.main(["-c", _config(tmp_path)])
    assert "no CUDA device" in str(e.value.code)
    assert not (tmp_path / "runs").exists()


@pytest.mark.parametrize("cli", ["train", "generate"])
def test_both_clis_pin_tf32_off(tmp_path, monkeypatch, cli):
    """Right after parsing its arguments each CLI turns TF32 off for
    float32 matrix products and cuDNN convolutions, whatever they were."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["-c", _config(tmp_path)] if cli == "train" else
            ["--behavior_params", "b.npz", "--synth_params", "s.npz"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        (main if cli == "train" else generate).main(argv)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("flags", [["-m", "infer"], ["-r"], ["-f"], ["-v"],
                                   ["-s", "x"]])
def test_train_cli_unported_options_exit(tmp_path, flags, capsys):
    """-v and -s (the figures) are not ported and -f belongs to
    behavior_net: each exits 2 for a cvbae run.  -m infer and -r are
    ported for cvbae: on a trained run they evaluate it and resume it (a
    finished run runs no step); -p has its own tests below."""
    path = _config(tmp_path)
    if flags[0] in ("-m", "-r"):
        main.main(["-c", path, "--device", "cpu"])
        out = main.main(["-c", path, "--device", "cpu", *flags])
        if flags[0] == "-m":
            assert set(out) == {"ssim", "loss_regressor_posthoc"}
            assert all(np.isfinite(v) for v in out.values())
        else:
            assert out["state"].step == 3
            assert "Restored reg_ckpt checkpoint at step 3" in (
                capsys.readouterr().out)
        return
    with pytest.raises(SystemExit) as e:
        main.main(["-c", path, "--device", "cpu", *flags])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert ("behavior_net" if flags[0] == "-f"
            else "not ported yet (the figures, ROADMAP A12)") in err


def test_train_cli_unported_experiment_exits(tmp_path, capsys):
    """Every experiment of the JAX registry is ported; a name outside it
    exits 2 before any run directory exists."""
    path = _config(tmp_path)
    cfg = load_config(path)
    cfg["general"]["experiment"] = "mt_vae"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    with pytest.raises(SystemExit) as e:
        main.main(["-c", path, "--device", "cpu"])
    assert e.value.code == 2
    assert "unknown experiment: 'mt_vae'" in capsys.readouterr().err
    assert not (tmp_path / "runs").exists()


SAVES = ["step_2.pt", "step_3.pt"]     # ckpt_steps 2, and the last step


def _ckpt(tmp_path, project):
    return tmp_path / "runs" / "cvbae" / "ckpt" / project / "reg_ckpt"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A finished tiny cvbae run (3 steps, project "tiny")."""
    tmp = tmp_path_factory.mktemp("trained")
    main.main(["-c", _config(tmp), "--device", "cpu"])
    return tmp


def _copy_run(trained, tmp_path) -> str:
    """The trained run under tmp_path, as if trained there; returns its
    config's path."""
    shutil.copytree(trained / "runs", tmp_path / "runs")
    dumped = tmp_path / "runs" / "cvbae" / "config" / "tiny" / "config.yaml"
    cfg = load_config(dumped)
    cfg["general"]["base_dir"] = str(tmp_path / "runs")
    with open(dumped, "w") as f:
        yaml.safe_dump(cfg, f)
    return _config(tmp_path)


@pytest.mark.parametrize("how", ["moved", "debug", "in_place"])
def test_pretrained_warm_start(trained, tmp_path, how, capsys):
    """-p adopts a trained run's config and copies its checkpoints into
    the new run, which restores them (the 3-step run is finished, so no
    step runs).  "moved": the run was moved away, so its adopted config
    names a fresh directory, given as the experiment root; "debug": -p
    with --debug writes into the "debug" project beside it, from its
    config directory; "in_place": the run is where its config says, so
    -p goes on in it and warns."""
    path = _copy_run(trained, tmp_path)
    src = tmp_path / "runs" / "cvbae"
    if how == "moved":
        os.rename(tmp_path / "runs", tmp_path / "trained")
        src = tmp_path / "trained" / "cvbae"
    pretrained = str(src / "config" / "tiny") if how == "debug" else str(src)
    capsys.readouterr()
    out = main.main(["-c", path, "--device", "cpu", "-p", pretrained]
                    + (["-d"] if how == "debug" else []))
    printed = capsys.readouterr().out
    assert out["state"].step == 3
    assert "Restored reg_ckpt checkpoint at step 3" in printed
    project = "debug" if how == "debug" else "tiny"
    assert sorted(os.listdir(_ckpt(tmp_path, project))) == SAVES
    assert ("IN PLACE" in printed) == (how == "in_place")
    assert ("warm start: copied" in printed) == (how != "in_place")
    if how == "debug":   # the pretrained run is left as it was
        assert sorted(os.listdir(_ckpt(tmp_path, "tiny"))) == SAVES


def test_pretrained_needs_one_project(tmp_path):
    (tmp_path / "run" / "config" / "a").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="exactly one"):
        main.main(["-c", _config(tmp_path), "--device", "cpu", "-p",
                   str(tmp_path / "run")])


def test_datapath_reroots_the_run_and_the_data(tmp_path, monkeypatch):
    monkeypatch.setenv("DATAPATH", str(tmp_path / "root"))
    cfg = load_config(_config(tmp_path))
    cfg["general"]["base_dir"] = "/runs/"
    cfg["data"]["datapath"] = "data/h36m"
    config, dirs = main.load_parameters(cfg, debug=False)
    assert dirs["ckpt"] == str(tmp_path / "root" / "runs" / "cvbae" / "ckpt"
                               / "tiny")
    assert config["data"]["datapath"] == str(tmp_path / "root" / "data"
                                             / "h36m")
    assert (tmp_path / "root" / "runs" / "cvbae" / "config" / "tiny"
            / "config.yaml").is_file()


class _Tty(io.StringIO):
    def isatty(self):
        return True


@pytest.mark.parametrize("answers", [["y"], ["maybe", "n"]])
def test_resume_prompt_on_a_terminal(trained, tmp_path, monkeypatch,
                                     capsys, answers):
    """A run whose directory holds a config asks on a terminal: "y"
    resumes (the 3-step run is finished: no step, its save kept); "n"
    (after an answer that is neither) starts over: the old saves are
    deleted and the run trains its 3 steps again."""
    path = _copy_run(trained, tmp_path)
    ckpt = _ckpt(tmp_path, "tiny")
    os.utime(ckpt / "step_3.pt", (0, 0))
    asked = list(answers)
    monkeypatch.setattr(sys, "stdin", _Tty())
    monkeypatch.setattr("builtins.input", lambda prompt: asked.pop(0))
    capsys.readouterr()
    out = main.main(["-c", path, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert not asked and out["state"].step == 3
    fresh = answers[-1] == "n"
    assert ("Invalid answer" in printed) == (len(answers) > 1)
    assert ("fresh start: clearing stale 'reg_ckpt'" in printed) == fresh
    assert ("Restored reg_ckpt checkpoint at step 3" in printed) != fresh
    assert sorted(os.listdir(ckpt)) == SAVES
    assert (os.path.getmtime(ckpt / "step_3.pt") > 0) == fresh
    # "n" holds for that run only: -r after it restores what it saved
    dumped = load_config(tmp_path / "runs" / "cvbae" / "config" / "tiny"
                         / "config.yaml")
    assert "fresh_start" not in dumped["general"]
    monkeypatch.setattr(sys, "stdin", io.StringIO())
    assert main.main(["-c", path, "--device", "cpu", "-r"])[
        "state"].step == 3
    assert "Restored reg_ckpt checkpoint at step 3" in (
        capsys.readouterr().out)


def test_off_a_terminal_the_run_is_not_asked(trained, tmp_path,
                                             monkeypatch):
    path = _copy_run(trained, tmp_path)
    monkeypatch.setattr("builtins.input", lambda prompt: 1 / 0)
    assert main.main(["-c", path, "--device", "cpu"])["state"].step == 3


def test_gpu_is_accepted_and_has_no_effect():
    args = main.parse_args(["-c", "x.yaml", "--gpu", "0", "1", "--device",
                            "cpu"])
    assert args.gpu == [0, 1] and args.device == "cpu"
    assert main.parse_args(["-c", "x.yaml", "--gpu"]).device == "cuda"


def test_debug_caps_the_run_and_rbg_is_accepted(tmp_path):
    out = main.main(["-c", _config(tmp_path, end_iteration=50,
                                   dropout_rng="rbg", dropout_impl="flax"),
                     "--device", "cpu", "-d"])
    assert out["state"].step == 8
    assert (tmp_path / "runs" / "cvbae" / "ckpt" / "debug"
            / "synth.npz").exists()


def test_dataset_draws_what_the_jax_dataset_draws():
    """Same keypoints, appearance maps, batch order and regressor picks
    from the same seeds; the pixels come from another raster."""
    kw = dict(n_persons=3, frames_per_person=4, spatial_size=32, seed=0,
              with_reg=True)
    mine, theirs = SyntheticImageDataset(**kw), JaxDataset(**kw)
    np.testing.assert_array_equal(mine.norm_keypoints, theirs.norm_keypoints)
    np.testing.assert_array_equal(mine.map_ids, theirs.map_ids)
    np.testing.assert_array_equal(mine.palettes, theirs.palettes)
    for b_mine, b_theirs in zip(mine.batches(4, seed=2),
                                theirs.batches(4, seed=2)):
        assert set(b_mine) == set(b_theirs)
        for k in b_theirs:
            assert tuple(b_mine[k].shape) == b_theirs[k].shape, k
        np.testing.assert_array_equal(b_mine["sample_ids"].numpy(),
                                      b_theirs["sample_ids"])
        np.testing.assert_array_equal(b_mine["reg_targets"].numpy(),
                                      b_theirs["reg_targets"])
        for k in ("pose_img", "stickman", "app_img", "reg_imgs"):
            v = b_mine[k]
            assert v.dtype == torch.float32
            assert float(v.min()) >= -1 and float(v.max()) <= 1
        # a person's photo is its palette on its background
        p = int(b_mine["p_ids"][0])
        colors = set(map(tuple, ((b_mine["pose_img"][0] + 1) * 127.5)
                         .round().reshape(-1, 3).int().tolist()))
        assert colors <= ({(60 + 10 * (p % 4),) * 3}
                          | set(map(tuple, mine.palettes[p].tolist())))


@pytest.mark.parametrize("wandb", ["installed", "missing"])
def test_metric_log_writes_lines_and_forwards_to_wandb(tmp_path, monkeypatch,
                                                       wandb):
    """Each call appends {"step", "time", <prefix><name>} to
    metrics.jsonl and, with use_wandb, logs the same scalars to wandb
    where it imports; where it does not, the run goes on without it."""
    from behavior_driven_video_synthesis_tpu_torch.core.logging_util import (
        MetricLogger)

    calls = []
    fake = types.SimpleNamespace(init=lambda **kw: calls.append(kw),
                                 log=lambda m, step: calls.append((step, m)))
    monkeypatch.setitem(sys.modules, "wandb",
                        fake if wandb == "installed" else None)
    logger = MetricLogger(str(tmp_path / "log"), project="p", use_wandb=True)
    assert logger.log({"loss": 1.5, "n": 2}, 3, prefix="train/") == {
        "train/loss": 1.5, "train/n": 2.0}
    with open(tmp_path / "log" / "metrics.jsonl") as f:
        line = json.loads(f.read())
    assert line.pop("time") > 0
    assert line == {"step": 3, "train/loss": 1.5, "train/n": 2.0}
    assert calls == ([{"project": "p", "dir": str(tmp_path / "log"),
                       "resume": "allow"},
                      (3, {"train/loss": 1.5, "train/n": 2.0})]
                     if wandb == "installed" else [])
