"""The program's own spans in one traced slice.

The port opens ``i2pnet/<layer>/<unit>`` spans (``i2pnet_tpu_torch/utils/
trace.py``) as profiler ranges while a profiler records. In the Chrome
trace of the slice that ``--trace 1`` records they are ``user_annotation``
events on the main thread, on the clock of the device events. ``read``
gives, for each span name:

* ``count``: the times it was opened;
* ``host_s``: the sum of its durations;
* ``kernels``: the ``kernel`` events whose launch (the ``cuda_runtime`` or
  ``cuda_driver`` event of the same ``correlation``, on any host thread)
  lies inside one of its intervals;
* ``device_s``: the device seconds of every device event (kernels, copies,
  fills) launched inside its intervals, and of those launched inside the
  backward nodes of the forward operators it holds (a node carries its
  operator's ``Sequence number``), on the backward's own thread;
* ``syncs``: the calls inside its intervals that wait for the card: the
  stream, device and event synchronisations and the blocking copies, of
  either CUDA API;
* ``idle_s``: the slice's idle gaps (no device event running) inside its
  intervals on the main thread.

The harness does not read them yet (PERF.md, Open questions). Until it
does, one run of a cell as ``run.py ... --trace 1`` makes it, with the
spans of its slice, is

    python3 h100_bench/spans.py --workload <cell> --seed <n> --seconds <s>

which prints the run's result line, then one JSON line: the slice's
``units``, its idle milliseconds a unit (``idle_ms``) and every span's
fields a unit, times in milliseconds.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys
from collections import defaultdict
from typing import Dict, List, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "i2pnet/"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WAITS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize"))


def waits(name: str) -> bool:
    """Whether the CUDA API call ``name`` waits for the card."""
    return name in WAITS or (name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name)


def _merge(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _within(times: List[float], intervals) -> List[Tuple[int, int]]:
    """Index ranges of the sorted ``times`` inside disjoint ``intervals``."""
    return [(bisect.bisect_left(times, s), bisect.bisect_right(times, e)) for s, e in intervals]


def _launched(pairs, intervals) -> set:
    """The device events of ``pairs`` (launch time, index), sorted, whose
    launch lies inside ``intervals``."""
    times = [t for t, _ in pairs]
    return {pairs[k][1] for lo, hi in _within(times, intervals) for k in range(lo, hi)}


def _overlap(gaps, intervals) -> float:
    """The length of two sorted lists of disjoint intervals' intersection."""
    total, i, j = 0.0, 0, 0
    while i < len(gaps) and j < len(intervals):
        s, e = max(gaps[i][0], intervals[j][0]), min(gaps[i][1], intervals[j][1])
        total += max(e - s, 0.0)
        if gaps[i][1] < intervals[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(events: List[dict], dev: List[dict], gaps, main_tid) -> Dict[str, dict]:
    """{span name: its fields} of the program's spans in ``events``.
    ``dev``: the slice's device events, ``gaps``: its idle gaps (start,
    end) in the trace's microseconds, in order, ``main_tid``: the thread
    of the slice's window."""
    launch, wait_ts = {}, []
    fwd_ops: Dict[object, List[Tuple[float, int]]] = defaultdict(list)
    bwd_nodes: Dict[int, List[Tuple[object, float, float]]] = defaultdict(list)
    spans: Dict[str, List[dict]] = defaultdict(list)
    for e in events:
        cat, name, args = e.get("cat"), e.get("name", ""), e.get("args", {})
        if cat in LAUNCH_CATS:
            if "correlation" in args:
                launch[args["correlation"]] = (e.get("tid"), float(e["ts"]))
            if waits(name):
                wait_ts.append(float(e["ts"]))
        elif cat == "cpu_op" and "Sequence number" in args:
            seq, ts = args["Sequence number"], float(e["ts"])
            # a backward node names the thread of its forward; a forward
            # operator carries 0 there
            if args.get("Fwd thread id", 0):
                bwd_nodes[seq].append((e.get("tid"), ts, ts + float(e["dur"])))
            else:
                fwd_ops[e.get("tid")].append((ts, seq))
        elif cat == "user_annotation" and name.startswith(PREFIX) and e.get("ph") == "X":
            spans[name].append(e)
    wait_ts.sort()
    for ops in fwd_ops.values():
        ops.sort()
    fwd_ts = {tid: [ts for ts, _ in ops] for tid, ops in fwd_ops.items()}
    on_any: List[Tuple[float, int]] = []
    on_tid: Dict[object, List[Tuple[float, int]]] = defaultdict(list)
    for i, d in enumerate(dev):
        at = launch.get(d.get("args", {}).get("correlation"))
        if at is not None:
            on_any.append((at[1], i))
            on_tid[at[0]].append((at[1], i))
    on_any.sort()
    for pairs in on_tid.values():
        pairs.sort()

    out = {}
    for name, evs in spans.items():
        iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in evs]
        merged = _merge(iv)
        picked = _launched(on_any, merged)
        seqs = set()
        for e, (s, t) in zip(evs, iv):
            ops = fwd_ops.get(e.get("tid"), [])
            (lo, hi), = _within(fwd_ts.get(e.get("tid"), []), [(s, t)])
            seqs.update(seq for _, seq in ops[lo:hi])
        back: Dict[object, list] = defaultdict(list)
        for seq in seqs:
            for tid, s, t in bwd_nodes.get(seq, ()):
                back[tid].append((s, t))
        device = set(picked)
        for tid, nodes in back.items():
            device |= _launched(on_tid.get(tid, []), _merge(nodes))
        main = _merge(v for e, v in zip(evs, iv) if e.get("tid") == main_tid)
        out[name] = {
            "count": len(evs),
            "host_s": sum(t - s for s, t in iv) * 1e-6,
            "kernels": sum(1 for i in picked if dev[i].get("cat") == "kernel"),
            "device_s": sum(float(dev[i]["dur"]) for i in device) * 1e-6,
            "syncs": sum(hi - lo for lo, hi in _within(wait_ts, merged)),
            "idle_s": _overlap(list(gaps), main) * 1e-6,
        }
    return out


def per_unit(spans: Dict[str, dict], units: int) -> Dict[str, dict]:
    """The fields a unit, times in milliseconds."""
    return {name: {"count": f["count"] / units, "host_ms": 1e3 * f["host_s"] / units,
                   "kernels": f["kernels"] / units, "device_ms": 1e3 * f["device_s"] / units,
                   "syncs": f["syncs"] / units, "idle_ms": 1e3 * f["idle_s"] / units}
            for name, f in sorted(spans.items())}


@contextlib.contextmanager
def recording(found: list):
    """While active, each traced slice the harness reads (``trace.Slice``)
    also appends (its idle seconds, ``read`` of its spans) to ``found``."""
    from h100_bench import trace

    init = trace.Slice.__init__

    def keep(sl, events):
        init(sl, events)
        dev = [e for e in events if e.get("cat") in trace.DEVICE_CATS and e.get("ph") == "X"
               and float(e["ts"]) < sl.w1 and float(e["ts"]) + float(e["dur"]) > sl.w0]
        found.append((sl.window_s - sl.busy_s, read(events, dev, sl._union(dev)[1], sl.main_tid)))

    trace.Slice.__init__ = keep
    try:
        yield found
    finally:
        trace.Slice.__init__ = init


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from h100_bench import harness, run

    found = []
    with recording(found):
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or not found:
        return rc or 1
    units = harness.load_cell(args.workload, ROOT).traffic["trace_units"]
    idle_s, spans = found[0]
    print(json.dumps({"units": units, "idle_ms": 1e3 * idle_s / units,
                      "spans": per_unit(spans, units)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
