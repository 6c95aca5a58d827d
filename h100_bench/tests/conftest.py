"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
small cells of both families, which the harness drives on the CPU
(its plain paths) with no card."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CELLS = ("tiny-proj-eval", "tiny-free-train", "tiny-free-eval", "tiny-proj-train")


def _fields(cfg) -> dict:
    return json.loads(json.dumps({f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}))


def _program(family: str) -> dict:
    """The ``program`` entry of the full-size configuration of the family."""
    name = {"free": "i2pnet-free-kitti-cmr", "proj": "i2pnet-proj-kitti-lr"}[family]
    with open(os.path.join(ROOT, "h100_bench", "configs", f"{name}.json")) as f:
        return json.load(f)["program"]


def write_tiny(root: str) -> None:
    """Copy the benchmark under ``root`` and give it four small cells."""
    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig

    bench = os.path.join(root, "h100_bench")
    shutil.copytree(os.path.join(ROOT, "h100_bench"), bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    intr = {"fx": 60.0, "fy": 60.0, "cx": 64.0, "cy": 32.0}
    configs = {
        "tiny-free": {"family": "free", "program": _program("free"),
                      "model": _fields(I2PNetConfig.tiny()),
                      "image_hw": [64, 128], "points": 512, "real_points": 512,
                      "intrinsic": intr},
        "tiny-proj": {"family": "proj", "program": _program("proj"),
                      "model": _fields(I2PNetProjConfig.tiny()),
                      "image_hw": [64, 128], "points": 1200, "real_points": 1024,
                      "intrinsic": intr},
    }
    for name, c in configs.items():
        with open(os.path.join(bench, "configs", f"{name}.json"), "w") as f:
            json.dump(c, f)
    with open(os.path.join(bench, "traffic", "cmr-eval.json")) as f:
        cam = json.load(f)["scan"]
    sweep = {"kind": "sweep", "beams": 16, "near_m": [5, 80], "far_m": [80, 120],
             "far_share": 0.15}
    dec = {"rot_deg": [10, 10, 10], "trans_m": [2, 2, 2], "tz_max": None, "target": "pr"}
    lr = {"rot_deg": [0, 180, 0], "trans_m": [10, 0, 10], "tz_max": None, "target": "pr_inv"}
    traffics = {
        "tiny-cam-eval": {"loop": "eval", "batch": 2, "pool": 3, "stages": 2, "warmup": 1,
                          "trace_units": 2, "checked": 2, "scan": cam, "decalibration": dec},
        "tiny-cam-train": {"loop": "train", "batch": 2, "pool": 4, "warmup": 1,
                           "trace_units": 1, "steps_per_epoch": 100, "scan": cam,
                           "decalibration": dict(dec, tz_max=1.0)},
        "tiny-sweep-eval": {"loop": "eval", "batch": 2, "pool": 3, "stages": 2, "warmup": 1,
                            "trace_units": 2, "checked": 2, "scan": sweep, "decalibration": lr},
        "tiny-sweep-train": {"loop": "train", "batch": 2, "pool": 4, "warmup": 1,
                             "trace_units": 1, "steps_per_epoch": 100, "scan": sweep,
                             "decalibration": lr},
    }
    for name, t in traffics.items():
        with open(os.path.join(bench, "traffic", f"{name}.json"), "w") as f:
            json.dump(t, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"] = [{"name": n, "source": "test", "file": f"h100_bench/configs/{n}.json",
                        "reduced": [], "why": "test"} for n in configs]
    pairs = {"tiny-proj-eval": ("tiny-proj", "tiny-sweep-eval"),
             "tiny-free-train": ("tiny-free", "tiny-cam-train"),
             "tiny-free-eval": ("tiny-free", "tiny-cam-eval"),
             "tiny-proj-train": ("tiny-proj", "tiny-sweep-train")}
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
                         for n, (c, t) in pairs.items()]
    evals = [n for n in TINY_CELLS if "eval" in n]
    trains = [n for n in TINY_CELLS if "train" in n]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = evals if m["name"].startswith("eval") or m["name"].endswith(
                ".eval") else trains
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    # the numbers the full-size cells compare, with limits far above what a
    # sound small float32 run reads and far below a planted fault
    for n in TINY_CELLS:
        lim = {"grad_med": 1e-3, "change_med": 1e-2}
        if "eval" in n:
            lim = {"q_med": 1e-3, "t_med": 1e-3, "q_p90": 1e-3, "t_p90": 1e-3}
        with open(os.path.join(bench, "limits", f"{n}.json"), "w") as f:
            json.dump(lim, f)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench_root"))
    write_tiny(root)
    return root
