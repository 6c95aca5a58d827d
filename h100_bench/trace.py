"""Reading one profiled slice: the device's busy time, its idle gaps named
by what the host was doing, the device time of the benchmark's own ranges
and the device operations that took the most time.

The slice is recorded by ``torch.profiler`` (CPU and CUDA activities) and
read from its Chrome trace: device work is every ``kernel``, ``gpu_memcpy``
and ``gpu_memset`` event; a kernel belongs to a range when the runtime or
driver call that launched it (same ``correlation``) lies inside a
``bench/<label>`` user annotation on the same host thread.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW = "bench/window"


class Slice:
    """What one traced slice reads: ``busy_s`` (the union of device
    intervals inside the window), ``window_s``, ``range_s`` (device seconds
    by range label), ``device_ops`` and ``idle_gaps`` (the breakdown's two
    lists) and ``unattributed`` (device events whose launch was not found)."""

    def __init__(self, events: List[dict]):
        win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("trace: the window's annotation is missing")
        w = win[0]
        self.w0, self.w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.main_tid = w.get("tid")
        self.window_s = (self.w1 - self.w0) * 1e-6
        dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
               and float(e["ts"]) < self.w1 and float(e["ts"]) + float(e["dur"]) > self.w0]
        self.busy_s, gaps = self._union(dev)
        self.device_ops = self._by_name(dev)
        self.range_s, self.unattributed = self._ranges(events, dev)
        self.idle_gaps = self._name_gaps(events, gaps)

    def _union(self, dev) -> Tuple[float, List[Tuple[float, float]]]:
        spans = sorted((max(float(e["ts"]), self.w0),
                        min(float(e["ts"]) + float(e["dur"]), self.w1)) for e in dev)
        busy, gaps, cur_s, cur_e = 0.0, [], None, self.w0
        for s, e in spans:
            if cur_s is None or s > cur_e:
                if s > cur_e:
                    gaps.append((cur_e, s))
                if cur_s is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        if cur_e < self.w1:
            gaps.append((cur_e, self.w1))
        return busy * 1e-6, gaps

    @staticmethod
    def _by_name(dev) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for e in dev:
            tot[e["name"][:120]] += float(e["dur"]) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:10]]

    def _ranges(self, events, dev):
        launches = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
        # per host thread: the launch times of the device events, sorted,
        # and the running sum of their device seconds
        per_tid: Dict[object, List[Tuple[float, float]]] = defaultdict(list)
        missing = 0
        for e in dev:
            launch = launches.get(e.get("args", {}).get("correlation"))
            if launch is None:
                missing += 1
                continue
            per_tid[launch[0]].append((launch[1], float(e["dur"]) * 1e-6))
        sums = {}
        for tid, items in per_tid.items():
            items.sort()
            acc, run = [0.0], 0.0
            for _, d in items:
                run += d
                acc.append(run)
            sums[tid] = ([t for t, _ in items], acc)
        out: Dict[str, float] = defaultdict(float)
        for e in events:
            name = e.get("name", "")
            if e.get("cat") != "user_annotation" or not name.startswith("bench/") or name == WINDOW:
                continue
            if e.get("tid") not in sums:
                continue
            times, acc = sums[e.get("tid")]
            s = float(e["ts"])
            lo = bisect.bisect_left(times, s)
            hi = bisect.bisect_right(times, s + float(e["dur"]))
            out[name[len("bench/"):]] += acc[hi] - acc[lo]
        return dict(out), missing

    def _name_gaps(self, events, gaps) -> List[list]:
        host = [e for e in events if e.get("cat") in HOST_CATS and e.get("tid") == self.main_tid
                and e.get("ph") == "X" and e.get("name") != WINDOW]
        host.sort(key=lambda e: float(e["ts"]))
        starts = [float(e["ts"]) for e in host]
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            mid = 0.5 * (s + e)
            i = bisect.bisect_right(starts, mid)
            name = "host between operations"
            # the innermost host event holding the gap's middle: the latest
            # started one that has not ended
            for j in range(i - 1, max(i - 2000, -1), -1):
                h = host[j]
                if float(h["ts"]) + float(h["dur"]) >= mid:
                    name = h["name"][:120]
                    break
            out.append([name, (e - s) * 1e-6])
        return out


def read(path: str) -> Slice:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    try:
        return Slice(events)
    finally:
        os.remove(path)
