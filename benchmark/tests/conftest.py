"""Fixtures of the benchmark's tests: tiny cells on the CPU and the card.

Run from the root of a checkout: ``python -m pytest benchmark/tests -q``
(on a machine with a card, ``-m gpu`` runs the tests that need it)."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

CELLS = ("alter256.bulk_b20_t50", "org256_fused.bulk_b20_t50")


def tiny(cell_name: str) -> harness.Cell:
    """The cell at a size a CPU test holds: widths and depths cut, the
    camera scaled to the 64 px frame, two requests of two 4-frame videos;
    its own limits and metrics."""
    cell = copy.deepcopy(harness.load_cell(cell_name))
    cfg = cell.config
    cfg["behavior_net"].update(dim_hidden_b=64, n_flows=2)
    cfg["synthesis_net"].update(spatial_size=64, nf_start=8, nf_max=16)
    cfg["serving"].update(stickman_thickness=2.0, vunet_chunk=4)
    cfg["assumed"]["camera"].update(focal_px=[68.0, 76.0],
                                    centre_px=[31.0, 33.0],
                                    image_size_px=64.0)
    cell.traffic.update(videos=2, frames=4, pool=2, checked=2, traced=2)
    return cell


@pytest.fixture(params=CELLS)
def tiny_cell(request):
    return tiny(request.param)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
