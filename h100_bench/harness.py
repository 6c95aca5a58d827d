"""One run of one cell: set-up, the measured window, the traced slice, the
check of what the window produced against the plain reference, and the
result line.

Everything a cell needs is found by name: the workload in
``BENCHMARK.json``; its configuration in ``configs/<name>.json``, whose
``family`` names the reference family (``reference/families/<family>.py``)
and whose ``program`` names the program's classes and entry points; its
traffic in ``traffic/<name>.json``, whose ``loop`` names the way the
program is driven (``loops/<loop>.py``) and whose scan ``kind`` the file
that draws its scans (``scans/<kind>.py``); its limits in
``limits/<cell>.json``; its per-layer readers in ``metrics/<name>.py``; the
kernels counted in ``kernels/*.py``. The program under test is
``i2pnet_tpu_torch``, driven eagerly through its own entry points.
"""

from __future__ import annotations

import contextlib
import glob
import importlib
import importlib.util
import json
import math
import os
import re
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from h100_bench import gen, trace, work
from h100_bench.reference import nets

BENCH = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "i2pnet_tpu")


# --- the cell ------------------------------------------------------------------

def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str) -> SimpleNamespace:
    """The workload ``name`` of ``root``/BENCHMARK.json with its
    configuration, traffic, limits and metric entries."""
    spec = _read_json(os.path.join(root, "BENCHMARK.json"))
    work_ = {w["name"]: w for w in spec["workloads"]}
    if name not in work_:
        raise SystemExit(f"h100_bench: no workload {name!r} in BENCHMARK.json")
    w = work_[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = os.path.join(root, "h100_bench")

    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    # a per-layer metric without ``workloads`` is read wherever its metric is
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    limits_path = os.path.join(bench, "limits", f"{name}.json")
    return SimpleNamespace(
        name=name, chips=w["chips"], bench=bench,
        config=_read_json(os.path.join(root, cfg_entry["file"])),
        traffic=_read_json(os.path.join(bench, "traffic", f"{w['traffic']}.json")),
        limits=_read_json(limits_path) if os.path.exists(limits_path) else {},
        end_to_end=e2e, per_layer=per_layer)


def sub_seed(seed: int, *stream) -> int:
    return int(np.random.SeedSequence([int(seed) % (1 << 64)] + list(stream))
               .generate_state(1, dtype=np.uint64)[0] >> 1)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


@contextlib.contextmanager
def no_tf32():
    """Full float32 matmuls and convolutions, restored on leaving."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --- weights and inputs ----------------------------------------------------------

def make_weights(family: str, mc: dict, seed: int, stage: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of one model from the seed, drawn on the device in two
    calls: Dense and convolution matrices normal with variance 1 / fan-in,
    biases and norm shifts 0.1 x normal, norm scales 1 + 0.1 x normal,
    running statistics 0 and 1 (``calibrate`` sets them), sq and sx the
    configuration's."""
    sch = nets.schema(family, mc)
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 2, stage))
    total = sum(math.prod(shape) for shape, _ in sch.values())
    normal = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, (shape, kind) in sch.items():
        n = math.prod(shape)
        z = normal[off:off + n].view(shape)
        off += n
        if kind == "weight":
            v = z / math.sqrt(n / shape[0])
        elif kind in ("bias", "shift"):
            v = 0.1 * z
        elif kind == "scale":
            v = 1.0 + 0.1 * z
        elif kind == "running_mean":
            v = torch.zeros(shape, device=device)
        elif kind == "running_var":
            v = torch.ones(shape, device=device)
        else:
            v = torch.full(shape, float(mc[f"{kind}_init"]), device=device)
        out[name] = v.clone()
    return out


def calibrate(family: str, mc: dict, W: Dict[str, torch.Tensor], batch: dict) -> None:
    """Set every BatchNorm's running statistics to those of a forward in
    training mode on ``batch``, so the eval forward normalises as a trained
    model's does (the reference's own forward, float32)."""
    stats: dict = {}
    with no_tf32(), torch.no_grad():
        nets.forward(family)(nets.Run(W, training=True, dropout_rate=0.0, stats=stats), mc,
                             batch["rgb"], batch["lidar"], batch["intrinsic"],
                             batch["lidar_feats"], batch["raw_xyz"])
    for name, (mean, var) in stats.items():
        W[f"{name}.running_mean"] = mean.clone()
        W[f"{name}.running_var"] = var.clone()


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in gen.model_keys(batch).items()}


# --- the program -------------------------------------------------------------------

def resolve(path: str):
    """``module:attribute`` -> the attribute."""
    module, _, attr = path.partition(":")
    return getattr(importlib.import_module(module), attr)


def loop_module(name: str):
    """The module ``loops/<name>.py``."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"h100_bench: loop {name!r} is no module name")
    return importlib.import_module(f"h100_bench.loops.{name}")


def build_models(cell, weights: List[Dict[str, torch.Tensor]], device) -> SimpleNamespace:
    """The program's configuration and one model per weight set, loaded
    (the configuration file's ``program``: ``config`` and ``model``)."""
    spec = cell.config["program"]
    cfg = resolve(spec["config"])(**{k: _tuples(v) for k, v in cell.config["model"].items()})
    models = []
    for W in weights:
        m = resolve(spec["model"])(cfg, device=device)
        m.load_state_dict(W, strict=True)
        models.append(m)
    return SimpleNamespace(loop=cell.traffic["loop"], cfg=cfg, models=models)


# --- the traced slice ----------------------------------------------------------------

def _load_file(path: str, prefix: str):
    """The module in ``path`` (metric files carry dots in their names)."""
    name = prefix + os.path.basename(path)[:-3].replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_readers(cell) -> Dict[str, object]:
    return {m["name"]: _load_file(os.path.join(cell.bench, "metrics", f"{m['name']}.py"),
                                  "h100_bench_metric_") for m in cell.per_layer}


class RangeHooks:
    """``bench/<label>`` profiler ranges around the forward (and, where
    asked, the backward) of the named submodules of every model."""

    def __init__(self, models, specs: dict):
        self.handles = []
        for label, spec in specs.items():
            for model in models:
                for attr in spec["modules"]:
                    mod = getattr(model, attr, None)
                    if mod is not None:
                        self._hook(mod, f"bench/{label}", spec.get("backward", False))

    def _hook(self, mod, name, backward):
        fwd, bwd = [], []

        def enter(stack):
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            stack.append(rf)

        def leave(stack):
            if stack:
                stack.pop().__exit__(None, None, None)

        self.handles += [mod.register_forward_pre_hook(lambda m, a: enter(fwd)),
                         mod.register_forward_hook(lambda m, a, o: leave(fwd))]
        if backward:
            self.handles += [mod.register_full_backward_pre_hook(lambda m, g: enter(bwd)),
                             mod.register_full_backward_hook(lambda m, gi, go: leave(bwd))]

    def remove(self):
        for h in self.handles:
            h.remove()


class KernelTap:
    """Wraps every kernel launcher of ``kernels/*.py`` while active: each
    call runs inside a ``bench/kernel:<name>`` range, whose device time the
    trace gives, and its bound is computed from its shapes."""

    def __init__(self, bench: str):
        self.entries, self.calls = [], []
        for path in sorted(glob.glob(os.path.join(bench, "kernels", "*.py"))):
            name = os.path.basename(path)[:-3]
            if name == "__init__":
                continue
            mod = _load_file(path, "h100_bench_kernel_")
            self.entries.append((name, importlib.import_module(mod.MODULE), mod.FUNCTION,
                                 mod.bound))

    def __enter__(self):
        self.saved = []
        for name, module, fn_name, bound in self.entries:
            orig = getattr(module, fn_name)
            self.saved.append((module, fn_name, orig))
            setattr(module, fn_name, self._wrap(name, orig, bound))
        return self

    def _wrap(self, name, orig, bound):
        def tapped(*args):
            with torch.autograd.profiler.record_function(f"bench/kernel:{name}"):
                out = orig(*args)
            self.calls.append((name, bound(args, out)))
            return out
        return tapped

    def __exit__(self, *exc):
        for module, fn_name, orig in self.saved:
            setattr(module, fn_name, orig)

    def read(self, range_s: dict):
        """[(kernel, its calls' bound seconds, their device seconds)]."""
        bounds: Dict[str, float] = {}
        for n, b in self.calls:
            bounds[n] = bounds.get(n, 0.0) + (b() if callable(b) else b)
        return [(n, b, range_s.get(f"kernel:{n}", 0.0)) for n, b in bounds.items()]


def traced_slice(cell, prog, readers, run_slice, device):
    """Run ``run_slice`` under the profiler with the readers' ranges and
    the kernel tap; returns (trace.Slice, kernel calls)."""
    specs = {}
    for mod in readers.values():
        specs.update(getattr(mod, "RANGES", {}))
    hooks = RangeHooks(prog.models, specs)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    tap = KernelTap(cell.bench)
    try:
        with tap, torch.profiler.profile(activities=acts) as prof:
            with torch.autograd.profiler.record_function(trace.WINDOW):
                run_slice()
    finally:
        hooks.remove()
    fd, path = tempfile.mkstemp(prefix="h100_bench_trace_", suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    sl = trace.read(path)
    return sl, tap.read(sl.range_s)


# --- the check ---------------------------------------------------------------------

def flops_counter(on: bool):
    if not on:
        return contextlib.nullcontext()
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False)


def judge(numbers: dict, limits: dict):
    """(correct, checks): every number the cell's limits name is there and
    within its limit (without a limits file, every number is reported
    against none); any number that is not finite fails."""
    checks, ok = {}, all(k in numbers for k in limits)
    for k, v in numbers.items():
        if k.startswith("_"):
            continue
        if not math.isfinite(v):
            ok = False
        if limits and k not in limits:
            continue
        lim = limits.get(k)
        checks[k] = {"value": v, "limit": lim}
        if lim is not None and not (v <= lim):
            ok = False
    return ok, checks


# --- one run -------------------------------------------------------------------------

def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             fault: Optional[Callable] = None, control: Optional[str] = None) -> dict:
    """One run; returns the result object (and, under ``_readings``, the
    numbers the control script collects). ``fault`` plants a fault in the
    program's timed path after it is built; ``control`` names a precision of
    ``reference/quant.py`` whose readings are taken beside the program's."""
    device = torch.device(device)
    family, traffic = cell.config["family"], cell.traffic
    mc = dict(cell.config["model"], _steps_per_epoch=traffic.get("steps_per_epoch", 1))
    nets.check_supported(family, mc)
    loop = loop_module(traffic["loop"])

    phases = {"imports": time.perf_counter() - t_start}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        sync(device)
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    ctx = SimpleNamespace(cell=cell, family=family, mc=mc, traffic=traffic, B=traffic["batch"],
                          device=device, seed=seed, phase=phase)
    ctx.weights = [make_weights(family, mc, seed, s, device)
                   for s in range(traffic.get("stages", 1))]
    # the pool lives in pinned host memory, as a loader with pinning hands
    # it over: the prefetch then copies it to the card without staging it
    pinned = [{k: torch.from_numpy(v) for k, v in b.items()}
              for b in gen.make_pool(seed, cell.config, traffic)]
    if device.type == "cuda":
        pinned = [{k: v.pin_memory() for k, v in b.items()} for b in pinned]
    ctx.pinned = pinned
    ctx.pool = [{k: v.numpy() for k, v in b.items()} for b in pinned]
    phase("weights_and_traffic")
    loop.prepare(ctx)
    ctx.prog = build_models(cell, ctx.weights, device)
    loop.build(ctx)
    phase("program")
    if fault is not None:
        fault(ctx.prog)
    nxt = loop.warm(ctx)
    phase("warmup")
    setup_s = time.perf_counter() - t_start

    # --- the measured window
    win = loop.run(ctx, nxt, seconds=seconds, record=True)
    e2e = loop.end_to_end(ctx, win)
    e2e["setup_s"] = setup_s
    attempted = win["units"] * ctx.B

    result_extra = {}
    slice_ = kernel_calls = None
    if traced:
        readers = load_readers(cell)
        slice_, kernel_calls = traced_slice(
            cell, ctx.prog, readers,
            lambda: loop.run(ctx, win["next"], count=traffic["trace_units"]), device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # --- free the program, then check what it produced
    loop.release(ctx)
    ctx.prog = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = {}
    with no_tf32():
        numbers, ctrl, flops = loop.check(ctx, control, traced)
    if ctrl is not None:
        readings["control"] = {k: v for k, v in ctrl.items() if not k.startswith("_p")}
    readings["program"] = {k: v for k, v in numbers.items() if not k.startswith("_p")}
    correct, checks = judge(numbers, cell.limits)
    # a run that is not correct counts every answer it checked as failed
    failed = 0 if correct else loop.failed(ctx, numbers)

    if traced:
        reading = SimpleNamespace(
            loop=traffic["loop"], units=traffic["trace_units"], pairs_per_unit=ctx.B,
            units_per_s=win["units"] / win["seconds"], flops_per_unit=flops,
            peak_flops=work.BF16_FLOPS, range_s=slice_.range_s, kernel_calls=kernel_calls,
            busy_s=slice_.busy_s, window_s=slice_.window_s)
        metrics = {}
        for m in cell.per_layer:
            v = readers[m["name"]].read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result_extra["breakdown"] = {"device_ops": slice_.device_ops,
                                     "idle_gaps": slice_.idle_gaps}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        dev["busy_s"] = slice_.busy_s
        dev["window_s"] = slice_.window_s
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    result.update(result_extra)
    result["checks"] = checks
    readings["setup_phases_s"] = phases
    result["_readings"] = readings
    if traced:
        result["_unattributed"] = slice_.unattributed
    return result
