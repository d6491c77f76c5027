"""The serving program's stage spans (``core/trace.py``) on the card.

Marked ``gpu``; without a CUDA device every test skips.  The card's
machine has no JAX, which ``tests/conftest.py`` imports, so run them there
with

    python -m pytest tests/test_torch_trace_gpu.py -m gpu --noconftest -q

A request's spans record CUDA events and never wait for the device (torch's
synchronization check); each span's device interval lies within its
parent's; under the profiler the program's ranges stay off the device's
timeline; and the hand-written kernels launch on torch's current stream,
so that the events on that stream bracket them.
"""
import warnings

import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu_torch.core import trace
from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
    detailed_joint_model)
from behavior_driven_video_synthesis_tpu_torch.geometry.stickman import (
    render_stickman)
from behavior_driven_video_synthesis_tpu_torch.models import (
    ResidualBehaviorNet)
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.vunet import VUNet
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (
    fused_rnb as FR)
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import rollout as R
from behavior_driven_video_synthesis_tpu_torch.pipeline import (
    BehaviorTransferPipeline)

pytestmark = pytest.mark.gpu

# device ms the events' timestamps may round by
EPS_MS = 1e-3
# cycles a side stream spins before it writes a kernel's input: ~50 ms
SPIN = 10**8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _pipeline_and_request(device, B=3, T=6):
    rng = np.random.RandomState(0)
    net = init_random_(ResidualBehaviorNet(48, 32), rng).to(device)
    vunet = init_random_(VUNet(spatial_size=32, nf_start=8, nf_max=16),
                         rng).to(device)
    pipe = BehaviorTransferPipeline(
        net, vunet, detailed_joint_model(True), np.zeros(51, np.float32),
        np.ones(51, np.float32), np.arange(51)[np.arange(51) % 17 != 0][:48],
        spatial_size=32, vunet_chunk=4)
    extr = np.tile(np.hstack([np.eye(3), [[0], [0], [4.0]]]), (B, 1, 1))
    request = [rng.randn(B, 32), rng.randn(B, 48) * 0.1,
               rng.rand(B, 32, 32, 3), extr,
               np.tile([40.0, 16, 40.0, 16], (B, 1)), np.full((B, 2), 32.0)]
    return pipe, [torch.as_tensor(v, dtype=torch.float32, device=device)
                  for v in request], T


def _last_request():
    recs = trace.records()
    return [r for r in recs if r["request"] == recs[-1]["request"]]


def _sync_warnings(fn):
    """``fn()`` under torch's synchronization check in its warning mode:
    the number of waits for the device it reports."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing" in str(w.message) for w in seen)


def test_spans_never_wait_for_the_device(cuda, monkeypatch):
    """A request's spans around device work raise nothing under the check's
    error mode; a served request on device inputs waits as often with its
    spans as with spans that do nothing: never (the raster takes its joint
    model's topology from a table cached on the device)."""
    x = torch.randn(256, 256, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with trace.span("request", cuda, frames=2):
            for name in ("flow", "vunet"):
                with trace.span(name, frames=1):
                    x = x @ x / 256
    finally:
        torch.cuda.set_sync_debug_mode(0)
    pipe, request, T = _pipeline_and_request(cuda)
    pipe.generate(*request, length=T)           # builds the operands
    torch.cuda.synchronize()
    with_spans = _sync_warnings(lambda: pipe.generate(*request, length=T))

    class Off:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(trace, "span", lambda *a, **k: Off())
    without = _sync_warnings(lambda: pipe.generate(*request, length=T))
    print(f"waits for the device in a served request: {with_spans} with "
          f"the spans, {without} without")
    assert with_spans == without == 0


def test_spans_record_nested_device_intervals(cuda):
    pipe, request, T = _pipeline_and_request(cuda)
    out = pipe.generate(*request, length=T)
    assert bool(torch.isfinite(out["frames"]).all())
    recs = _last_request()
    chunks = [r for r in recs if r["name"] == "vunet.chunk"]
    cs, n_pad = pipe._chunk_size(3 * T)
    assert len(chunks) == n_pad // cs
    by_name = {r["name"]: r for r in recs}
    assert recs[0]["name"] == "request" and recs[0]["device_start_ms"] == 0
    for r in recs:
        assert r["device_start_ms"] <= r["device_end_ms"]
        if r["parent"] is not None:
            p = by_name[r["parent"]]
            assert p["device_start_ms"] - EPS_MS <= r["device_start_ms"]
            assert r["device_end_ms"] <= p["device_end_ms"] + EPS_MS
    vunet = by_name["vunet"]
    assert sum(r["device_end_ms"] - r["device_start_ms"] for r in chunks) \
        <= vunet["device_end_ms"] - vunet["device_start_ms"] + EPS_MS


def test_profiler_ranges_stay_on_the_host(cuda):
    """Under the profiler the program's ranges are host events only: no
    device event carries a ``bdvs.`` name."""
    from torch.profiler import ProfilerActivity, profile
    pipe, request, T = _pipeline_and_request(cuda)
    pipe.generate(*request, length=T)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipe.generate(*request, length=T)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    host = {e.name() for e in events if e.device_type().name == "CPU"}
    device = [e.name() for e in events if e.device_type().name != "CPU"]
    assert {trace.PREFIX + n for n in ("request", "rollout", "vunet.chunk")} \
        <= host
    assert device and not any(n.startswith(trace.PREFIX) for n in device)


def _late_input_on_a_side_stream(x, launch):
    """``launch(y)`` on a side stream after the stream spins and then copies
    ``x`` into ``y``: a kernel launched on another stream would run before
    the copy and read zeros."""
    y = torch.zeros_like(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(SPIN)
        y.copy_(x)
        out = launch(y)
    torch.cuda.synchronize()
    return out


def test_rollout_kernel_launches_on_the_current_stream(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, K, H, T = 4, 48, 64, 5

    def u(*shape):
        return (torch.rand(*shape, generator=g, device=cuda) * 2 - 1) * 0.3
    operands = R.pack_operands(u(4 * H, K), u(4 * H, H), u(4 * H), u(4 * H),
                               u(K, H), u(K))
    b, x0 = u(B, H), u(B, K) + 0.5
    with torch.no_grad():
        ref = R.residual_lstm_rollout_prepared(b, x0, operands, T)
        out = _late_input_on_a_side_stream(
            x0, lambda y: R.residual_lstm_rollout_prepared(b, y, operands,
                                                           T))
    assert torch.equal(out, ref)


def test_fused_rnb_kernel_launches_on_the_current_stream(cuda):
    block = init_random_(pnn.VunetRNB(32, dtype=torch.bfloat16),
                         np.random.RandomState(0)).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(2, 16, 16, 32, generator=g, device=cuda)
         * 0.5).bfloat16()
    operands = block.fused_operands()
    with torch.no_grad():
        ref = FR.fused_rnb_prepared(x, operands)
        out = _late_input_on_a_side_stream(
            x, lambda y: FR.fused_rnb_prepared(y, operands))
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


def test_stickman_kernel_launches_on_the_current_stream(cuda):
    jm = detailed_joint_model(True)
    g = torch.Generator(device=cuda).manual_seed(0)
    joints = torch.rand(20, 17, 2, generator=g, device=cuda) * 64
    ref = render_stickman(joints, jm, 64, 4.0, normalized=True)
    out = _late_input_on_a_side_stream(
        joints, lambda y: render_stickman(y, jm, 64, 4.0, normalized=True))
    assert bool((ref != ref[..., :1, :1, :]).any())
    assert torch.equal(out, ref)
