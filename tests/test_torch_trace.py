"""The serving program's stage spans (``core/trace.py``) on the small
slice on the CPU: they tile a request, nest as the program composes its
stages, count the VUNet's chunks and padding, leave the outputs as they
are, and the recorder keeps a fixed number of requests."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from behavior_driven_video_synthesis_tpu_torch.core import trace
from torch_port_slice import B, camera_args, make_slice, port_pipeline
from torch_port_threads import one_torch_thread  # noqa: F401

FRONT = ["flow", "rollout", "pose", "stickman", "appearance"]


@pytest.fixture(scope="module")
def slice_():
    trees, inputs, noise = make_slice(0)
    return trees, inputs, [torch.from_numpy(n) for n in noise]


def _generate(slice_, T, chunk):
    trees, inputs, noise = slice_
    pipe = port_pipeline(trees, inputs, vunet_chunk=chunk)
    return pipe.generate(inputs["z"], inputs["x_start"],
                         *camera_args(inputs), length=T, eps=noise)


def _last_request():
    recs = trace.records()
    return [r for r in recs if r["request"] == recs[-1]["request"]]


def _within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


# (frames a video, vunet_chunk): one chunk; three exact chunks of 4; 14
# frames in four chunks of 4, the last with 2 frames of padding
@pytest.mark.parametrize("T,chunk,chunks,padding", [
    (6, 128, [12], 0), (6, 4, [4, 4, 4], 0), (7, 4, [4, 4, 4, 4], 2)])
def test_stage_spans_tile_a_profiled_request(slice_, T, chunk, chunks,
                                             padding):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _generate(slice_, T, chunk)
    spans, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            spans.setdefault(e.name()[len(trace.PREFIX):], []).append(
                (e.start_ns(), e.end_ns()))
        elif e.name().startswith("aten::"):
            ops.append((e.start_ns(), e.end_ns(), e.name()))
    (request,) = spans.pop("request")
    stages = [iv for ivs in spans.values() for iv in ivs]
    inside = [op for op in ops if _within(op[:2], request)]
    assert inside
    for op in inside:
        assert any(_within(op[:2], iv) for iv in stages), op[2]

    recs = _last_request()
    assert [(r["name"], r["parent"]) for r in recs] == (
        [("request", None)] + [(n, "request") for n in FRONT + ["vunet"]]
        + [("vunet.chunk", "vunet")] * len(chunks))
    assert all(r["profiled"] for r in recs)
    assert recs[0]["counts"] == dict(B=B, T=T, frames=B * T)
    assert recs[-len(chunks) - 1]["counts"] == dict(frames=B * T,
                                                    padding=padding)
    cs = [r["counts"] for r in recs if r["name"] == "vunet.chunk"]
    assert [c["frames"] for c in cs] == chunks
    assert sum(c["frames"] for c in cs) == B * T + padding
    assert sum(c["padding"] for c in cs) == padding
    # one profiler range a record, opened in the same order
    ranges = sorted((iv[0], name) for name, ivs in spans.items()
                    for iv in ivs)
    assert [n for _, n in ranges] == [r["name"] for r in recs[1:]]


def test_records_nest_share_one_request_and_stay_on_the_host(slice_):
    _generate(slice_, 6, 4)
    recs = _last_request()
    assert len({r["request"] for r in recs}) == 1
    assert not any(r["profiled"] for r in recs)
    by_name = {r["name"]: r for r in recs}
    for r in recs:
        assert r["entry_ns"] <= r["exit_ns"]
        assert r["device_start_ms"] is None and r["device_end_ms"] is None
        if r["parent"] is not None:
            p = by_name[r["parent"]]
            assert _within((r["entry_ns"], r["exit_ns"]),
                           (p["entry_ns"], p["exit_ns"]))
    front = [by_name[n] for n in FRONT + ["vunet"]]
    for a, b in zip(front, front[1:]):
        assert a["exit_ns"] <= b["entry_ns"]


def test_outputs_are_bit_equal_with_and_without_a_profiler(slice_):
    plain = _generate(slice_, 7, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _generate(slice_, 7, 4)
    assert set(plain) == set(traced)
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k


def test_no_profiler_range_is_opened_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"range {name!r} opened")
    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    with trace.span("request", "cpu", frames=1):
        with trace.span("flow"):
            pass
    assert [r["name"] for r in _last_request()] == ["request", "flow"]


def test_the_ring_keeps_the_last_64_requests():
    for i in range(trace.RING + 6):
        with trace.span("request", frames=i):
            with trace.span("vunet"):
                pass
    recs = trace.records()
    ids = sorted({r["request"] for r in recs})
    assert len(ids) == trace.RING == 64
    assert ids == list(range(ids[0], ids[0] + 64))
    assert [r["counts"]["frames"] for r in recs
            if r["name"] == "request"][-64:] == list(range(6, 70))
    assert len(recs) == 2 * 64


def test_reenact_is_one_request(slice_):
    trees, inputs, noise = slice_
    pipe = port_pipeline(trees, inputs, vunet_chunk=4)
    T = inputs["x_source"].shape[1]
    pipe.reenact(inputs["x_source"], inputs["x_start"],
                 *camera_args(inputs), length=T, eps=noise)
    recs = _last_request()
    assert [(r["name"], r["parent"]) for r in recs] == (
        [("request", None), ("behavior.encode", "request")]
        + [(n, "request") for n in FRONT[1:] + ["vunet"]]
        + [("vunet.chunk", "vunet")] * 3)
    assert recs[0]["counts"] == dict(B=B, T=T, frames=B * T)


def test_calibrate_spans_one_chunk_a_calibration_call(slice_):
    trees, inputs, noise = slice_
    pipe = port_pipeline(trees, inputs, vunet_kw={"quant": "int8_static"})
    pipe.calibrate(inputs["z"], inputs["x_start"], *camera_args(inputs),
                   length=6, eps=noise)
    recs = _last_request()
    assert [(r["name"], r["parent"]) for r in recs] == (
        [("request", None)] + [(n, "request") for n in FRONT]
        + [("calibrate", "request"), ("calibrate.chunk", "calibrate")])
    assert recs[-1]["counts"] == dict(frames=B * 6)


def test_a_span_that_raises_still_closes():
    with pytest.raises(ValueError):
        with trace.span("request", frames=3):
            with trace.span("flow"):
                raise ValueError("stage failed")
    recs = _last_request()
    assert [r["name"] for r in recs] == ["request", "flow"]
    assert all(r["exit_ns"] is not None for r in recs)
    with trace.span("request"):
        pass
    assert [r["parent"] for r in _last_request()] == [None]
    assert np.all(np.diff([r["request"] for r in trace.records()]) >= 0)
