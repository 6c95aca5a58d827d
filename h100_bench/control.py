"""Readings of the numbers that decide ``correct``, for setting their
limits: on each seed, the program's (a short window at the cell's own
load), the control's (the reference in fp8 put in the program's place) and,
with ``--fault``, the program's with that fault planted. One process reads
every seed, so set-up is paid once for the build. ``--fault`` takes a
comma list (``none`` for the sound program), each read on every seed;
``--compute-dtype float32`` runs the program in float32 with TF32 off, to
see which gaps its bfloat16 arithmetic makes.

    python3 h100_bench/control.py --workload <cell> --seeds 11,12,13 --seconds 3
        [--control fp8] [--fault none,half_batch] [--compute-dtype float32]

Prints one JSON line per seed and fault, with ``correct`` judged by the
cell's limits for the program and, under ``control_correct``, for the
control. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--compute-dtype", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from h100_bench import faults, harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    if args.compute_dtype:
        cell.config["model"]["compute_dtype"] = args.compute_dtype
        if args.compute_dtype == "float32":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    names = (args.fault or "none").split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        for name in names:
            fault = None if name == "none" else faults.FAULTS[name]
            t0 = time.perf_counter()
            res = harness.run_cell(cell, seed, args.seconds, False, args.device, t0,
                                   fault=fault, control=args.control)
            line = {"workload": cell.name, "seed": seed, "fault": name,
                    "compute_dtype": cell.config["model"]["compute_dtype"],
                    "readings": res["_readings"], "correct": res["correct"],
                    "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                    "seconds": time.perf_counter() - t0}
            if "control" in res["_readings"]:
                line["control_correct"] = harness.judge(res["_readings"]["control"],
                                                        cell.limits)[0]
            print(json.dumps(line), flush=True)
            del res
            gc.collect()
            if args.device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
