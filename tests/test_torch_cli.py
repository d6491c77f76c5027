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


def _run(param_files, out, *extra, device=("--device", "cpu")):
    return generate.main([
        "--behavior_params", str(param_files / "behavior.npz"),
        "--synth_params", str(param_files / "synth.npz"),
        "--length", "3", "--batch", "2", *device,
        "--out", str(out), *extra])


def test_cli_runs_on_cuda_unless_told_otherwise(param_files, tmp_path,
                                                monkeypatch):
    """Without --device the CLI takes the card; with no card it stops
    with a message instead of serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        _run(param_files, tmp_path / "served", device=())
    assert e.value.code != 0
    assert "no CUDA device" in str(e.value.code)
    assert "--device cpu" in str(e.value.code)
    assert not (tmp_path / "served").exists()
    man = _run(param_files, tmp_path / "served")
    assert man["device"] == "cpu" and len(man["videos"]) == 2


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


@pytest.fixture(scope="module")
def org_files(tmp_path_factory):
    """An org-VUNet synthesis run (experiment "vunet": 30-channel part
    stack appearance at 16x16, box_factor 1) beside a behavior run."""
    d = tmp_path_factory.mktemp("org")
    rng = np.random.RandomState(3)
    net, flow = ResidualBehaviorNet(K, HID), LatentFlow(HID, 2 * HID,
                                                        n_flows=2)
    vunet = VUNet(spatial_size=S, n_channels_x=30, nf_start=4, nf_max=8,
                  box_factor=1, variant="org")
    for m in (net, flow, vunet):
        init_random_(m, rng)
    pconv.save_flax_npz(str(d / "behavior.npz"), {
        "net": pconv.behavior_net_to_flax(net.state_dict()),
        "flow": pconv.latent_flow_to_flax(flow.state_dict())})
    pconv.save_flax_npz(str(d / "synth.npz"), {
        "vunet": pconv.vunet_org_to_flax(vunet.state_dict())})
    with open(d / "behavior.json", "w") as f:
        json.dump({"architecture": {"dim_hidden_b": HID, "n_flows": 2,
                                    "flow_mid_channels_factor": 2}}, f)
    with open(d / "synth.json", "w") as f:
        json.dump({"data": {"spatial_size": S, "inplane_normalize": True,
                            "box_factor": 1},
                   "architecture": {"nf_start": 4, "nf_max": 8},
                   "general": {"experiment": "vunet"}}, f)
    np.savez(d / "request.npz",
             x_start=(rng.randn(2, K) * 0.1).astype(np.float32),
             app_img=(rng.rand(2, S // 2, S // 2, 30) * 2 - 1).astype(
                 np.float32))
    return d


@pytest.mark.parametrize("rnb_impl", ["cudnn", "fused"])
def test_cli_serves_an_org_run_as_the_jax_pipeline_does(
        org_files, tmp_path, monkeypatch, rnb_impl):
    """bdvs-generate-torch on an org synthesis run (bf16 VUNet, as both
    CLIs serve it) against the JAX pipeline given the same weights,
    request, behavior codes and posterior noise: poses within 1e-4, frames
    within a relative L2 of 2e-2 (bf16 rounds at other points in the two
    packages).  The JAX pipeline calls the org ``transfer_cached`` with no
    "sample" rng, which the prior's dead branch asks for, so the JAX
    VUNet is handed one here; the frames do not depend on it."""
    from behavior_driven_video_synthesis_tpu import generate as jgen
    from behavior_driven_video_synthesis_tpu.models import (
        ResidualBehaviorNet as JNet)
    from behavior_driven_video_synthesis_tpu.models.flows import (
        LatentFlow as JFlow)
    from behavior_driven_video_synthesis_tpu.models.vunet import (
        VUNet as JVUNet, vunet_from_config as jvunet_from_config)
    from behavior_driven_video_synthesis_tpu.pipeline import (
        BehaviorTransferPipeline as JPipeline)
    from behavior_driven_video_synthesis_tpu_torch.models import vunet as V
    from torch_port_slice import jax_noise
    import jax
    import jax.numpy as jnp

    noise, served = [], []
    draw, serve = V._noise, generate.BehaviorTransferPipeline.generate

    def spy_draw(*args):
        t = draw(*args)
        noise.append(t.float().numpy())
        return t

    def spy_serve(self, *args, **kw):
        out = serve(self, *args, **kw)
        served.append((args, out))
        return out
    apply = JVUNet.apply

    def apply_with_rng(self, *args, rngs=None, **kw):
        return apply(self, *args, rngs=rngs or {
            "sample": jax.random.PRNGKey(1)}, **kw)
    monkeypatch.setattr(JVUNet, "apply", apply_with_rng)
    monkeypatch.setattr(V, "_noise", spy_draw)
    monkeypatch.setattr(generate.BehaviorTransferPipeline, "generate",
                        spy_serve)
    man = _run(org_files, tmp_path / "served", "--request",
               str(org_files / "request.npz"), "--rnb_impl", rnb_impl)
    assert (man["variant"], man["rnb_impl"]) == ("org", rnb_impl)
    assert len(man["videos"]) == 2 and len(noise) == 2
    (z, x_start, app, extr, intr, imsize), out = served[0]

    btree, _ = generate._load_params(str(org_files / "behavior.npz"))
    stree, scfg = generate._load_params(str(org_files / "synth.npz"))
    pipe = JPipeline(
        JNet(n_kps=K, dim_hidden_b=HID), jvunet_from_config(
            scfg, "org", dtype=jnp.bfloat16), jgen.chain_joint_model(K // 3),
        np.zeros(K, np.float32), np.ones(K, np.float32), np.arange(K),
        spatial_size=S, stickman_thickness=2.0,
        flow_model=JFlow(flow_in_channels=HID, flow_mid_channels=2 * HID,
                         n_flows=2))
    with jax_noise(noise):
        ref = pipe.generate(
            {"behavior": btree["net"], "vunet": stree["vunet"],
             "flow": btree["flow"]},
            *(jnp.asarray(np.asarray(v, np.float32)) for v in (
                z, x_start, app, extr, intr, imsize)),
            jax.random.PRNGKey(0), length=3)
    np.testing.assert_allclose(out["poses_3d"].numpy(),
                               np.asarray(ref["poses_3d"]), atol=1e-4, rtol=0)
    frames = out["frames"].float().numpy()
    frames_ref = np.asarray(ref["frames"], np.float32)
    assert frames.shape == frames_ref.shape == (2, 3, S, S, 3)
    rel = np.linalg.norm(frames - frames_ref) / np.linalg.norm(frames_ref)
    assert rel <= 2e-2, rel


@pytest.mark.parametrize("flag", [["--quant", "int8_static",
                                   "--upsample", "transpose"],
                                  ["--quant", "int8_static"],
                                  ["--upsample", "transpose"],
                                  ["--preset", "tpu-serving"]])
def test_cli_unported_options_exit(param_files, tmp_path, flag, capsys):
    """The quantized and transposed-upsample serving options, which exited
    2 before they were ported, serve, and the manifest records them
    (``--preset tpu-serving`` is int8_static with quant_max_hw 128; the
    expansion's rules: ``test_torch_quant.py``)."""
    man = _run(param_files, tmp_path, *flag)
    assert len(man["videos"]) == 2
    quant = "int8_static" if ("--quant" in flag or "--preset" in flag) \
        else "none"
    assert man["quant"] == quant
    assert man["quant_max_hw"] == (128 if "--preset" in flag else 0)
    assert man["upsample"] == ("transpose" if "transpose" in flag
                               else "subpixel")
    out = capsys.readouterr().out
    assert ("calibrated activation scales" in out) == (quant != "none")


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
        "import behavior_driven_video_synthesis_tpu_torch.ops.cuda.elu_dropout\n"
        "import behavior_driven_video_synthesis_tpu_torch.ops.cuda.fused_rnb\n"
        "import behavior_driven_video_synthesis_tpu_torch.ops.cuda.conv_int8\n"
        "import behavior_driven_video_synthesis_tpu_torch.main\n"
        "import behavior_driven_video_synthesis_tpu_torch.experiments."
        "shape_and_pose_net\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'behavior_driven_video_synthesis_tpu'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
