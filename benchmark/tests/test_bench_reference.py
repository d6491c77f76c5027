"""The reference against the program's plain CPU path at tiny widths, for
both VUNets, stage by stage, and its parameter names and shapes against the
program's state dicts at the cells' own sizes."""
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.reference import model as R
from benchmark.reference import spec as S
from benchmark.traffic import make_pool
from benchmark.weights import make_params, subset

from .conftest import CELLS, ROOT, tiny


@pytest.mark.parametrize("cell", CELLS)
def test_names_and_shapes_at_full_size(cell):
    cfg = harness.load_cell(cell).config
    P = {n: torch.empty(s, device="meta") for n, s, _ in
         S.behavior_spec(cfg) + S.flow_spec(cfg) + S.vunet_spec(cfg)}
    # loading by name, strictly, is the check
    harness.program(cfg, P, "meta")


@pytest.fixture
def served(tiny_cell):
    cfg, traffic = tiny_cell.config, tiny_cell.traffic
    P = make_params(cfg, 2**31 + 5, "cpu")
    r = make_pool(cfg, traffic, 2**31 + 5, "cpu")[0]
    pipe, module = harness.program(cfg, P, "cpu")
    return tiny_cell, P, r, pipe, module


def test_flow_inverse(served):
    cell, P, r, pipe, _ = served
    with torch.no_grad():
        want = pipe.flow_model.reverse(r["z"])
    got = R.flow_reverse(P, cell.config, r["z"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_rollout(served):
    from behavior_driven_video_synthesis_tpu_torch.ops.cuda.rollout import (
        residual_lstm_rollout_plain)
    cell, P, r, _, _ = served
    b = torch.randn(r["z"].shape, generator=torch.Generator().manual_seed(1))
    d = {k: P[f"decoder.{k}"] for k in ("rnn.weight_ih", "rnn.weight_hh",
                                         "rnn.bias_ih", "rnn.bias_hh",
                                         "n_out.weight", "n_out.bias")}
    T = cell.traffic["frames"]
    want = residual_lstm_rollout_plain(b, r["x_start"], *d.values(), T)
    torch.testing.assert_close(R.rollout(P, b, r["x_start"], T), want,
                               rtol=1e-6, atol=1e-6)
    # the control's fp8 operands move it
    assert (R.rollout(P, b, r["x_start"], T, low=True) - want).abs().max() \
        > 1e-4


def test_served_outputs(served):
    """Poses, keypoints and stickmen are the reference's exactly (the same
    float32 formulas); the frames of the program's VUNet in float32 are the
    reference's to rounding."""
    cell, P, r, pipe, _ = served
    cfg, T = cell.config, cell.traffic["frames"]
    out = pipe.generate(r["z"], r["x_start"], r["app"], r["extrinsics"],
                        r["intrinsics"], r["image_size"], length=T,
                        eps=r["eps"])
    torch.testing.assert_close(out["poses_3d"],
                               R.poses(P, cfg, r["z"], r["x_start"], T),
                               rtol=1e-5, atol=1e-5)
    size = cfg["synthesis_net"]["spatial_size"]
    kp = R.project(out["poses_3d"], r["extrinsics"], r["intrinsics"],
                   r["image_size"], size)
    assert torch.equal(out["keypoints_2d"], kp)
    stick = R.stickman_input(R.raster(cfg, kp))
    assert torch.equal(out["stickman"], stick)
    assert (stick > -1).any()

    from behavior_driven_video_synthesis_tpu_torch.models.vunet import (
        vunet_from_config)
    f32 = vunet_from_config(harness.run_config(cfg), S.variant(cfg),
                            dtype=torch.float32,
                            rnb_impl=cfg["serving"]["rnb_impl"],
                            device="meta")
    f32.load_state_dict(subset(P, S.vunet_spec(cfg)), assign=True)
    with torch.no_grad():
        means, _ = f32.encode_means(r["app"], [e.float() for e in r["eps"]])
        ref_means = R.encode_means(P, cfg, r["app"], r["eps"])
        for a, b in zip(means, ref_means):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        V = r["z"].shape[0]
        flat = stick.reshape((V * T,) + stick.shape[2:])
        want = f32.transfer_cached(
            [torch.repeat_interleave(m, T, 0) for m in means], flat)
    got = R.frames(P, cfg, ref_means, stick, frames_per_block=3)
    torch.testing.assert_close(got.reshape(want.shape), want, rtol=1e-4,
                               atol=1e-4)


def test_low_precision_stages_differ(served):
    cell, P, r, pipe, _ = served
    cfg = cell.config
    world = R.poses(P, cfg, r["z"], r["x_start"], cell.traffic["frames"])
    size = cfg["synthesis_net"]["spatial_size"]
    args = (r["extrinsics"], r["intrinsics"], r["image_size"], size)
    kp, kp_low = R.project(world, *args), R.project(world, *args, low=True)
    assert 0 < (kp - kp_low).abs().max() < 2
    assert not torch.equal(R.raster(cfg, kp), R.raster(cfg, kp, low=True))


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.model, benchmark.reference.spec; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'behavior_driven_video_synthesis_tpu',"
            " 'behavior_driven_video_synthesis_tpu_torch')]; "
            "print(bad); sys.exit(bool(bad))" % str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
