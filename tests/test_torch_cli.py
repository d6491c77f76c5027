"""The PyTorch port's serving CLI, its parameter files, and its freedom from
JAX."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu_torch import generate
from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models import (
    ResidualBehaviorNet)
from behavior_driven_video_synthesis_tpu_torch.models.flows import LatentFlow
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.vunet import VUNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))

from export_params_for_torch import export  # noqa: E402

K, HID, S = 48, 16, 32


@pytest.fixture(scope="module")
def param_files(tmp_path_factory):
    """A behavior and a synthesis .npz + .json written from a numpy seed."""
    d = tmp_path_factory.mktemp("params")
    rng = np.random.RandomState(0)
    net, flow = ResidualBehaviorNet(K, HID), LatentFlow(HID, 2 * HID,
                                                        n_flows=2)
    vunet = VUNet(spatial_size=S, nf_start=4, nf_max=8)
    for m in (net, flow, vunet):
        init_random_(m, rng)
    pconv.save_flax_npz(str(d / "behavior.npz"), {
        "net": pconv.behavior_net_to_flax(net.state_dict()),
        "flow": pconv.latent_flow_to_flax(flow.state_dict())})
    pconv.save_flax_npz(str(d / "synth.npz"), {
        "vunet": pconv.vunet_alter_to_flax(vunet.state_dict())})
    with open(d / "behavior.json", "w") as f:
        json.dump({"architecture": {"dim_hidden_b": HID, "n_flows": 2,
                                    "flow_mid_channels_factor": 2}}, f)
    with open(d / "synth.json", "w") as f:
        json.dump({"data": {"spatial_size": S},
                   "architecture": {"nf_start": 4, "nf_max": 8},
                   "general": {"experiment": "cvbae"}}, f)
    return d


def _run(param_files, out, *extra):
    return generate.main([
        "--behavior_params", str(param_files / "behavior.npz"),
        "--synth_params", str(param_files / "synth.npz"),
        "--length", "3", "--batch", "2", "--device", "cpu",
        "--out", str(out), *extra])


def test_cli_sample_mode(param_files, tmp_path):
    man = _run(param_files, tmp_path / "served", "--mode", "sample")
    assert man["flow"] is True and man["batch"] == 2
    assert len(man["videos"]) == 2
    for path in man["videos"].values():
        assert os.path.exists(path)
        assert path.endswith(man["video_format"])
    with open(tmp_path / "served" / "manifest.json") as f:
        assert json.load(f)["videos"] == man["videos"]


def test_cli_transfer_mode_with_request(param_files, tmp_path):
    rng = np.random.RandomState(1)
    req = tmp_path / "req.npz"
    np.savez(req, x_start=rng.randn(3, K).astype(np.float32) * 0.1,
             source=rng.randn(3, 5, K).astype(np.float32) * 0.1,
             app_img=rng.randint(0, 255, (3, 40, 40, 3)).astype(np.uint8))
    man = _run(param_files, tmp_path / "served", "--mode", "transfer",
               "--request", str(req))
    assert man["flow"] is False and man["batch"] == 3
    assert all(os.path.exists(p) for p in man["videos"].values())
    if man["video_format"] == "npy":
        v = np.load(next(iter(man["videos"].values())))
        assert v.shape == (3, S, 2 * S, 3) and v.dtype == np.uint8


@pytest.mark.parametrize("flag", [["--from_dataset"],
                                  ["--quant", "int8_static"],
                                  ["--upsample", "transpose"],
                                  ["--preset", "tpu-serving"]])
def test_cli_unported_options_exit(param_files, tmp_path, flag, capsys):
    with pytest.raises(SystemExit) as e:
        _run(param_files, tmp_path, *flag)
    assert e.value.code == 2
    assert "not ported yet" in capsys.readouterr().err


def test_export_script_writes_what_the_port_loads(tmp_path):
    """examples/export_params_for_torch.py on an orbax run directory (as
    the JAX trainer writes it) gives an .npz + .json that load strictly."""
    import yaml
    from behavior_driven_video_synthesis_tpu.core.checkpoint import (
        CheckpointManager)

    rng = np.random.RandomState(2)
    net, flow = ResidualBehaviorNet(K, HID), LatentFlow(HID, 8, n_flows=2)
    for m in (net, flow):
        init_random_(m, rng)
    run = tmp_path / "behavior_net"
    CheckpointManager(str(run / "ckpt" / "reg_ckpt")).save(0, {
        "net": {"params": pconv.behavior_net_to_flax(net.state_dict())}})
    CheckpointManager(str(run / "ckpt" / "flow_ckpt")).save(0, {
        "flow": pconv.latent_flow_to_flax(flow.state_dict())})
    os.makedirs(run / "config")
    with open(run / "config" / "config.yaml", "w") as f:
        yaml.safe_dump({"architecture": {"dim_hidden_b": HID}}, f)
    export(str(run), "behavior", str(tmp_path / "out" / "behavior"))

    tree, cfg = generate._load_params(str(tmp_path / "out" / "behavior.npz"))
    assert cfg["architecture"] == {"dim_hidden_b": HID}
    for module, sd in ((net, pconv.behavior_net_from_flax(tree["net"])),
                       (flow, pconv.latent_flow_from_flax(tree["flow"]))):
        ref = module.state_dict()
        assert sd.keys() == ref.keys()
        for k in ref:
            assert torch.equal(sd[k], ref[k]), k


def test_port_imports_no_jax():
    """A fresh interpreter (tests/conftest.py imports jax in this one)."""
    code = (
        "import sys\n"
        "import behavior_driven_video_synthesis_tpu_torch.pipeline\n"
        "import behavior_driven_video_synthesis_tpu_torch.generate\n"
        "import behavior_driven_video_synthesis_tpu_torch.ops.cuda.rollout\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'behavior_driven_video_synthesis_tpu'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
