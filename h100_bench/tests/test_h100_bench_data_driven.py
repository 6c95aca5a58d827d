"""A cell, a configuration, a traffic mix, a per-layer metric, a reference
family, a scan kind and a loop are added as new files and entries alone:
in a copy of the benchmark, new files of each kind with their entries in
BENCHMARK.json are found and run by the harness of that copy (CPU, small
sizes), and no file that was there changes."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

from conftest import ROOT

READER = '''"""Milliseconds a batch of the traced slice, host clock."""


def read(r):
    if r.loop != "eval":
        return None
    return 1e3 * r.window_s / r.units
'''

# a family, a scan kind and a loop, each a new file that leans on one that
# is there: what matters is that the harness finds them by name
FAMILY = '''"""The free-point family under a second name."""

from .free import BATCH_STATS_AT_EVAL, FIXED, forward, schema  # noqa: F401
'''
SCAN = '''"""Camera-frame points in the near band alone."""

from .camera import points as _points


def points(rng, config, scan, Pr):
    return _points(rng, config, dict(scan, far_share=0.0), Pr)
'''
LOOP = '''"""The evaluator's loop under a second name."""

from .eval import (build, check, end_to_end, failed, faults, prepare, release,  # noqa: F401
                   run, warm)
'''

RUN = '''
import json, sys, time
sys.path[:0] = [{root!r}, {repo!r}]
import h100_bench
from h100_bench import harness
assert h100_bench.__file__.startswith({root!r}), h100_bench.__file__
out = {{}}
for name in ("tiny-narrow", "tiny-again"):
    cell = harness.load_cell(name, {root!r})
    plain = harness.run_cell(cell, 99, 0.5, False, "cpu", time.perf_counter())
    traced = harness.run_cell(cell, 99, 0.5, True, "cpu", time.perf_counter())
    out[name] = dict(correct=[plain["correct"], traced["correct"]], plain=sorted(plain["metrics"]),
                     traced={{k: v["value"] for k, v in traced["metrics"].items()}})
out["used"] = sorted(m for m in sys.modules
                     if m.rsplit(".", 1)[-1] in ("free_again", "camera_near", "eval_again"))
print(json.dumps(out))
'''


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_new_files_and_entries_alone_make_new_cells(tiny_root, tmp_path):
    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root)
    before = _digests(root)
    bench = os.path.join(root, "h100_bench")
    with open(os.path.join(bench, "configs", "tiny-free.json")) as f:
        cfg = json.load(f)
    cfg["points"] = cfg["real_points"] = 640
    cfg["model"]["lidar_in_points"] = 640
    cfg["family"] = "free_again"
    _write(os.path.join(bench, "configs", "tiny-free-640.json"), json.dumps(cfg))
    with open(os.path.join(bench, "traffic", "tiny-cam-eval.json")) as f:
        traffic = json.load(f)
    traffic.update(pool=2, checked=1, scan=dict(traffic["scan"], azimuth_deg=40,
                                                kind="camera_near"))
    _write(os.path.join(bench, "traffic", "tiny-narrow-eval.json"), json.dumps(traffic))
    _write(os.path.join(bench, "traffic", "tiny-again-eval.json"),
           json.dumps(dict(traffic, loop="eval_again")))
    _write(os.path.join(bench, "metrics", "slice_batch_ms.eval.py"), READER)
    _write(os.path.join(bench, "reference", "families", "free_again.py"), FAMILY)
    _write(os.path.join(bench, "scans", "camera_near.py"), SCAN)
    _write(os.path.join(bench, "loops", "eval_again.py"), LOOP)

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    os.remove(os.path.join(root, "BENCHMARK.json"))
    spec["configs"].append({"name": "tiny-free-640", "source": "test",
                            "file": "h100_bench/configs/tiny-free-640.json", "reduced": [],
                            "why": "test"})
    for cell, traffic_name in (("tiny-narrow", "tiny-narrow-eval"),
                               ("tiny-again", "tiny-again-eval")):
        spec["workloads"].append({"name": cell, "config": "tiny-free-640",
                                  "traffic": traffic_name, "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "free-eval" in " ".join(m.get("workloads", [])):
            m["workloads"].append("tiny-narrow")
        if m["name"].startswith("eval_"):
            m["workloads"].append("tiny-again")
    spec["per_layer"].append({"name": "slice_batch_ms.eval", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "harness",
                              "moves": "eval_pairs_per_s", "workloads": ["tiny-narrow"]})
    _write(os.path.join(root, "BENCHMARK.json"), json.dumps(spec))

    code = textwrap.dedent(RUN.format(root=root, repo=ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for cell in ("tiny-narrow", "tiny-again"):
        assert out[cell]["correct"] == [True, True]
        assert out[cell]["plain"] == ["eval_batch_ms_p95", "eval_pairs_per_s", "setup_s"]
    assert out["tiny-narrow"]["traced"]["slice_batch_ms.eval"] > 0
    assert "mfu.eval" in out["tiny-narrow"]["traced"]
    assert out["used"] == ["h100_bench.loops.eval_again",
                           "h100_bench.reference.families.free_again",
                           "h100_bench.scans.camera_near"]

    after = _digests(root)
    changed = [p for p, d in before.items() if after.get(p) != d and p != "BENCHMARK.json"]
    assert not changed
    added = sorted(p for p in set(after) - set(before) if "__pycache__" not in p)
    assert added == sorted(os.path.join("h100_bench", *p.split("/")) for p in (
        "configs/tiny-free-640.json", "traffic/tiny-narrow-eval.json",
        "traffic/tiny-again-eval.json", "metrics/slice_batch_ms.eval.py",
        "reference/families/free_again.py", "scans/camera_near.py", "loops/eval_again.py"))
