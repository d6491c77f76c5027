"""The comparison rejects its control and the faults a served request can
have, and accepts the program.

The control is the program's stages one precision below what the
configuration states: the flow in TF32, the rollout on fp8 operands, the
camera and raster in bfloat16, and the VUNet on the program's own int8
path.  At a tiny size on the CPU it is held to each cell's own limits; on
the card (``-m gpu``) at the cell's own size, on three seeds.  The faults
are answers altered where they are produced, each planted in a whole run
of the harness."""
import time

import pytest
import torch

from benchmark import check, control, harness
from benchmark.traffic import make_pool
from benchmark.weights import make_params

from .conftest import CELLS


def _control_readings(cell, seed, device):
    params = make_params(cell.config, seed, device)
    pool = make_pool(cell.config, cell.traffic, seed, device)
    vunet8 = control.int8_vunet(cell.config, params)
    return check.worst(
        check.judge(params, cell.config, cell.traffic, r,
                    control.control_outputs(cell, params, r, vunet8))
        for r in pool[:int(cell.traffic["checked"])])


def test_control_fails_at_a_tiny_size(tiny_cell):
    values = _control_readings(tiny_cell, 2**31 + 11, "cpu")
    assert not check.verdict(values, tiny_cell.limits), values
    # the front stages' and the VUNet's numbers each fail
    assert values["poses"] > 0 and values["keypoints_px"] > 0
    assert values["stickman_share"] > 0 and values["frames_off_share"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell, cuda):
    c = harness.load_cell(cell)
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        values = _control_readings(c, seed, cuda)
        assert not check.verdict(values, c.limits), (seed, values)


def test_frame_share_leaves_out_values_clipped_alike():
    ref = torch.tensor([[2.0, -3.0, 0.5, 0.0]]).reshape(1, 1, 2, 2, 1)
    served = torch.tensor([[1.5, -1.2, 0.5, 0.1]]).reshape(1, 1, 2, 2, 1)
    # two values clip to the same end on both sides: of the other two,
    # one lies 0.1 off, more than two levels
    assert check.frames_off(served, ref).item() == 0.5
    served[0, 0, 0, 0, 0] = 0.2        # now free to differ, and off
    assert check.frames_off(served, ref).item() == pytest.approx(2 / 3)
    both = torch.full((1, 1, 2, 2, 1), 5.0)
    assert check.frames_off(both, both).item() == 0.0


def _alter_frame(out):
    out["frames"][-1, -1] = out["frames"][-1, -1] * 0.9
    return out


def _alter_pose(out):
    out["poses_3d"][0, -1, 3] += 0.02
    return out


def _alter_keypoint(out):
    out["keypoints_2d"][-1, 0, 5] += 0.5
    return out


def _alter_stickman(out):
    out["stickman"][0, 1] = -1.0
    return out


@pytest.mark.parametrize("fault", [None, _alter_frame, _alter_pose,
                                   _alter_keypoint, _alter_stickman])
def test_a_fault_makes_the_run_incorrect(tiny_cell, fault, monkeypatch):
    """An answer altered where it is produced (in every request the
    program serves) turns ``correct`` false; the unbroken run is
    correct."""
    from behavior_driven_video_synthesis_tpu_torch import pipeline

    if fault is not None:
        generate = pipeline.BehaviorTransferPipeline.generate

        def broken(self, *args, **kwargs):
            out = generate(self, *args, **kwargs)
            with torch.inference_mode():
                return fault(out)
        monkeypatch.setattr(pipeline.BehaviorTransferPipeline, "generate",
                            broken)
    result = harness.run(tiny_cell, 2**32 + 3, 0.1, False, "cpu",
                         time.perf_counter())
    assert result["correct"] is (fault is None), result["checks"]


def test_readings_tool(tiny_cell):
    """The tool that reads the program's and the control's numbers."""
    out = control.readings(tiny_cell, [5, 6], [6], torch.device("cpu"))
    assert set(out["program"]) == {5, 6} and set(out["control"]) == {6}
    assert check.verdict(out["program"][5], tiny_cell.limits)
    assert not check.verdict(out["control"][6], tiny_cell.limits)
