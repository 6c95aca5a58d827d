"""The span reader (``spans.py``) on a hand-written Chrome trace.

The trace (microseconds; thread 1 the main thread, 2 autograd's): a train
step [50, 600] holding a cost-volume span [100, 200] (inside it the
benchmark's own ``bench/cost_volume`` range, a forward ``addmm`` of
sequence number 7, a kernel and a copy launched) and a backward span [300,
500], during which thread 2 runs the backward nodes of sequence numbers 8
and 7 and launches a kernel in each; a ``relu`` (7's neighbour, number 8)
and its kernel between the two spans; a ``cudaStreamSynchronize`` at 550
and a last kernel launched at 590. The device runs 130-170, 180-190,
260-280, 320-330, 355-385 and 600-650, so the idle gaps 0-130 and 190-260
straddle the cost-volume span's edges.
"""

from __future__ import annotations

import time

import pytest

from h100_bench import spans, trace


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _launch(tid, ts, corr, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, tid, ts, 3, correlation=corr)


def _device(ts, dur, corr, cat="kernel", name="k"):
    return _x(cat, f"{name}{corr}", 7, ts, dur, correlation=corr)


SPANS = [_x("user_annotation", "i2pnet/train/step", 1, 50, 550),
         _x("user_annotation", "i2pnet/model/cost_volume", 1, 100, 100),
         _x("user_annotation", "i2pnet/train/backward", 1, 300, 200)]
EVENTS = [
    _x("user_annotation", trace.WINDOW, 1, 0, 1000),
    *SPANS,
    _x("user_annotation", "bench/cost_volume", 1, 101, 98),
    _x("cpu_op", "aten::addmm", 1, 110, 30, **{"Sequence number": 7, "Fwd thread id": 0}),
    _launch(1, 120, 1), _device(130, 40, 1),
    _launch(1, 150, 2, "cudaMemcpyAsync"), _device(180, 10, 2, "gpu_memcpy", "copy"),
    _x("cpu_op", "aten::relu", 1, 250, 10, **{"Sequence number": 8, "Fwd thread id": 0}),
    _launch(1, 252, 3), _device(260, 20, 3),
    _x("cpu_op", "autograd::engine::evaluate_function: ReluBackward0", 2, 310, 20,
       **{"Sequence number": 8, "Fwd thread id": 1}),
    _launch(2, 315, 4), _device(320, 10, 4),
    _x("cpu_op", "autograd::engine::evaluate_function: AddmmBackward0", 2, 338, 44,
       **{"Sequence number": 7, "Fwd thread id": 1}),
    _x("cpu_op", "AddmmBackward0", 2, 340, 40, **{"Sequence number": 7, "Fwd thread id": 1}),
    _launch(2, 350, 5), _device(355, 30, 5),
    _launch(1, 550, 6, "cudaStreamSynchronize"),
    _launch(1, 590, 7), _device(600, 50, 7),
]


def _read(events):
    sl = trace.Slice(events)
    dev = [e for e in events if e["cat"] in trace.DEVICE_CATS]
    return sl, spans.read(events, dev, sl._union(dev)[1], sl.main_tid)


@pytest.mark.parametrize("name,want", [
    # forward: k1 and the copy by launch, k5 through addmm's backward node
    ("i2pnet/model/cost_volume", dict(count=1, host_s=100e-6, kernels=1, device_s=80e-6,
                                      syncs=0, idle_s=(30 + 10 + 10) * 1e-6)),
    # thread 2's launches inside the interval count
    ("i2pnet/train/backward", dict(count=1, host_s=200e-6, kernels=2, device_s=40e-6, syncs=0,
                                   idle_s=(20 + 25 + 115) * 1e-6)),
    ("i2pnet/train/step", dict(count=1, host_s=550e-6, kernels=5, device_s=160e-6, syncs=1,
                               idle_s=(80 + 10 + 70 + 40 + 25 + 215) * 1e-6)),
])
def test_each_field_reads_its_value(name, want):
    _, got = _read(EVENTS)
    assert sorted(got) == sorted(s["name"] for s in SPANS)
    assert got[name] == pytest.approx(want, abs=1e-12)


def test_the_slice_reads_what_it_read_before():
    sl, _ = _read(EVENTS)
    bare = trace.Slice([e for e in EVENTS if e not in SPANS])
    assert sl.busy_s == pytest.approx(160e-6) and sl.window_s == pytest.approx(1e-3)
    assert sl.range_s == pytest.approx({"cost_volume": 50e-6})
    assert (sl.busy_s, sl.window_s, sl.range_s, sl.device_ops, sl.unattributed) == (
        bare.busy_s, bare.window_s, bare.range_s, bare.device_ops, bare.unattributed)
    assert [g[1] for g in sl.idle_gaps] == [g[1] for g in bare.idle_gaps]
    # a gap is named after the innermost host event holding its middle: a
    # span, where one holds it and nothing inside it does
    assert [g[0] for g in sl.idle_gaps] == [
        "host between operations", "i2pnet/train/backward", "i2pnet/train/step",
        "i2pnet/train/step", "i2pnet/train/backward", "i2pnet/train/backward",
        "bench/cost_volume"]


def test_a_program_without_spans_reads_none():
    events = [e for e in EVENTS if e not in SPANS]
    assert _read(events)[1] == {}


@pytest.mark.parametrize("name,wait", [
    ("cudaStreamSynchronize", True), ("cudaDeviceSynchronize", True),
    ("cudaEventSynchronize", True), ("cudaMemcpy", True), ("cuCtxSynchronize", True),
    ("cuMemcpyDtoH_v2", True), ("cudaMemcpyAsync", False), ("cuMemcpyHtoDAsync_v2", False),
    ("cudaLaunchKernel", False), ("cudaEventRecord", False)])
def test_which_calls_wait(name, wait):
    assert spans.waits(name) is wait


@pytest.mark.parametrize("cell", ["tiny-proj-eval", "tiny-free-train"])
def test_recording_reads_the_spans_of_a_traced_run(cell, tiny_root):
    """A traced run of a small cell on the CPU (no device events: the whole
    slice is idle): every span of the loop, as many times as it runs."""
    from h100_bench import harness

    c = harness.load_cell(cell, tiny_root)
    units = c.traffic["trace_units"]
    found = []
    with spans.recording(found):
        result = harness.run_cell(c, 5, 0.2, True, "cpu", time.perf_counter())
    assert result["correct"]
    (idle_s, got), = found
    assert idle_s == pytest.approx(result["device"]["window_s"])
    if c.traffic["loop"] == "eval":
        # the prefetch copies two batches ahead of the first
        want = {"i2pnet/data/to_device": units + 2, "i2pnet/eval/cascade": units,
                "i2pnet/eval/stage0": units, "i2pnet/eval/stage1": units,
                "i2pnet/model/rgb_encoder": 2 * units, "i2pnet/model/lidar_encoder": 2 * units,
                "i2pnet/model/cost_volume": 4 * units}
    else:
        want = {f"i2pnet/train/{k}": units for k in ("step", "forward", "backward", "optimizer")}
        want.update({"i2pnet/model/rgb_encoder": units, "i2pnet/model/lidar_encoder": units,
                     "i2pnet/model/cost_volume": 2 * units})
    assert {k: v["count"] for k, v in got.items()} == want
    for f in got.values():
        assert f["kernels"] == f["syncs"] == 0 and f["device_s"] == 0.0
        assert f["idle_s"] == pytest.approx(f["host_s"])
