"""The host cost of one span of the port (``i2pnet_tpu_torch/utils/trace.py``).

    python3 tools/span_cost_torch.py [--calls 20000] [--repeats 5]

On a machine with a CUDA card: opens and closes ``--calls`` spans with no
profiler, then under ``torch.profiler.profile`` recording the CPU and the
card, each loop timed on the host clock against an empty loop of as many
iterations; prints one JSON line: microseconds a span (the median of
``--repeats`` loops, the empty loop's time taken off), the card's name and
its power limit. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from i2pnet_tpu_torch.utils.trace import span  # noqa: E402


def _per_call_us(calls: int, repeats: int) -> float:
    def loop(body):
        t0 = time.perf_counter()
        for _ in range(calls):
            body()
        return time.perf_counter() - t0

    def empty():
        pass

    def opened():
        with span("i2pnet/cost"):
            pass

    spans = [loop(opened) for _ in range(repeats)]
    empties = [loop(empty) for _ in range(repeats)]
    return 1e6 * (statistics.median(spans) - statistics.median(empties)) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_cost_torch: no CUDA device", file=sys.stderr)
        return 2
    torch.ones(1, device="cuda").sum().item()
    off = _per_call_us(args.calls, args.repeats)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        on = _per_call_us(args.calls, args.repeats)
    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(json.dumps({"span_us_profiler_off": off, "span_us_profiler_on": on,
                      "calls": args.calls, "repeats": args.repeats,
                      "device": torch.cuda.get_device_name(0), "power_limit": limit}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
