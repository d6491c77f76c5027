"""The port's training entry point (``bdvs-train-torch``) and its synthetic
dataset, on the CPU.

A tiny cvbae run (32 px, nf 4->8, B=2, 3 steps, ``dropout_impl: pallas``,
which on CPU tensors runs the kernel's plain version) writes a
``synth.npz`` that ``bdvs-generate-torch --device cpu`` serves; the CLI
evaluates (``-m infer``) and resumes (``-r``) the run, refuses what is not
ported, and without ``--device cpu`` it needs a card.
The dataset draws what the JAX dataset draws from the same seeds.
"""
import json
import os

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
                                   ["-s", "x"], ["-p", "x"]])
def test_train_cli_unported_options_exit(tmp_path, flags, capsys):
    """-v, -s and -p are not ported and -f belongs to behavior_net: each
    exits 2 for a cvbae run.  -m infer and -r are ported for cvbae: on a
    trained run they evaluate it and resume it (a finished run runs no
    step)."""
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
    assert ("behavior_net" if flags[0] == "-f" else "not ported yet") in err


def test_train_cli_unported_experiment_exits(tmp_path, capsys):
    path = _config(tmp_path)
    cfg = load_config(path)
    cfg["general"]["experiment"] = "mt_vae"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    with pytest.raises(SystemExit) as e:
        main.main(["-c", path, "--device", "cpu"])
    assert e.value.code == 2
    assert "not ported yet" in capsys.readouterr().err


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
