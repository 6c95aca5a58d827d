"""The benchmark of i2pnet_tpu_torch on one NVIDIA H100: one run of one cell.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Loads and warms up the cell (its set-up),
drives its loop for ``--seconds``, with ``--trace 1`` records a short
slice under the profiler, checks what the window produced against the
plain reference, and prints one JSON line last on standard output (the
numbers compared, each beside its limit, also close standard error).
Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result; if JAX or the JAX package is loaded by then, 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no library loads JAX."""
    cache = os.path.join(ROOT, "build", "h100_bench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[var] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, ROOT)
    from h100_bench import harness

    cell = harness.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("h100_bench: no CUDA device; the benchmark runs on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"h100_bench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"h100_bench: loaded in the run's process: {', '.join(found)}", file=sys.stderr)
        return 3
    readings = result.pop("_readings")
    unattributed = result.pop("_unattributed", None)
    if unattributed:
        print(f"h100_bench: {unattributed} device events with no launch found in the trace",
              file=sys.stderr)
    print(json.dumps({"readings": readings}), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
