"""The port's spans (``utils/trace.py``), on the CPU, for both families.

- With no profiler, a span is the shared no-op: a batch's copy, a 2-stage
  cascade and a train step build no ``record_function`` (it is patched to
  raise).
- Under ``torch.profiler.profile`` the exported Chrome trace holds exactly
  the spans of the table in ``utils/trace.py``'s callers, nested as they
  are opened: per batch one copy to the device, one cascade holding one
  span a stage, each stage one RGB encoder, one LiDAR encoder and its cost
  volumes (two in the free model, ``1 + refine_iters`` in the proj one);
  per step one step holding a forward and a backward a microbatch and one
  optimizer, the forward holding the model's spans. At most 16 a batch or
  a step.
- The profiler changes no number: out3 of the cascade and every parameter
  after one step are bit-identical with the profiler on and off (on one
  CPU thread: with several, the CPU's convolution backward sums its
  weight gradients in an order that differs from run to run).
"""

import dataclasses
import json
from collections import Counter

import numpy as np
import pytest
import torch

from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
from i2pnet_tpu_torch.data.pipeline import prefetch_to_device, to_model_batch
from i2pnet_tpu_torch.eval.evaluator import MODEL_KEYS, Evaluator
from i2pnet_tpu_torch.models import I2PNet, I2PNetProj, init_flax_
from i2pnet_tpu_torch.ops import quaternion as Q
from i2pnet_tpu_torch.train import create_train_state, make_accum_train_step
from i2pnet_tpu_torch.utils import trace

B, H, W = 2, 64, 128
CPU = torch.device("cpu")
CONFIGS = {"free": I2PNetConfig.tiny(),
           # two refinement passes: three cost-volume spans a stage
           "proj": dataclasses.replace(I2PNetProjConfig.tiny(), refine_iters=2)}
COST_VOLUMES = {"free": 2, "proj": 3}


def _model(family, seed):
    model = (I2PNetProj if family == "proj" else I2PNet)(CONFIGS[family], device="cpu")
    return init_flax_(model, torch.Generator().manual_seed(seed))


def _batch(family) -> dict:
    """One loader batch (numpy, the loader's keys) with its ground truth:
    the free model's camera-frame cloud in front of the camera, the proj
    model's raw cloud with a zero tail and its decalibrated copy."""
    rng = np.random.default_rng(3)
    k = np.tile(np.array([[[64.0, 0, 64], [0, 64.0, 32], [0, 0, 1]]], np.float32), (B, 1, 1))
    q = np.array([[np.cos(0.1), 0, np.sin(0.1), 0]] * B, np.float32)
    t = np.array([[0.5, 0, 0.3]] * B, np.float32)
    out = {"rgb": rng.normal(size=(B, H, W, 3)).astype(np.float32), "init_intrinsic": k,
           "decalib_real_gt": q, "decalib_dual_gt": t}
    if family == "free":
        lidar = rng.uniform(-10, 10, size=(B, CONFIGS["free"].lidar_in_points, 3))
        lidar[..., 2] += 20.0
        out["lidar"] = lidar.astype(np.float32)
    else:
        raw = (rng.normal(size=(B, 4096, 3)) * 10).astype(np.float32)
        raw[:, 2048:] = 0.0
        lidar = Q.warp_points(torch.from_numpy(raw), torch.from_numpy(q), torch.from_numpy(t))
        out["lidar"] = (lidar * (torch.from_numpy(raw).square().sum(-1, keepdim=True) > 0)).numpy()
        out["raw_point_xyz"] = raw
    return out


def _cascade(family, tmp_path) -> torch.Tensor:
    """out3 of a 2-stage cascade on one batch, driven as the evaluator's
    loop drives it: the copy to the device, then the cascade."""
    ev = Evaluator([_model(family, 0), _model(family, 1)], CONFIGS[family],
                   proj=family == "proj", log_dir=str(tmp_path / "eval"), device="cpu")
    batch = next(iter(prefetch_to_device([_batch(family)], CPU, keys=MODEL_KEYS)))
    mb = to_model_batch({k: v for k, v in batch.items() if isinstance(v, torch.Tensor)})
    mb.setdefault("raw_xyz", mb["lidar"])
    return ev.cascade(mb)


def _step(family, accum):
    """The parameters after one update on the batch, dropout drawn from a
    fixed generator."""
    model = _model(family, 0)
    state = create_train_state(model, steps_per_epoch=100)
    step = make_accum_train_step(model, CONFIGS[family], accum, proj=family == "proj")
    batch = {k: torch.from_numpy(v) for k, v in to_model_batch(_batch(family)).items()}
    step(state, batch, torch.Generator().manual_seed(5))
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _traced(fn, tmp_path):
    """(fn's result, the program's spans in the exported trace as a Counter
    of (name, the name of the innermost span holding it or None))."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("i2pnet/")]
    assert all(e["cat"] == "user_annotation" for e in spans)
    tree = Counter()
    for e in spans:
        s, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        holders = [h for h in spans if h is not e and h["tid"] == e["tid"]
                   and float(h["ts"]) <= s and float(h["ts"]) + float(h["dur"]) >= end]
        parent = min(holders, key=lambda h: float(h["dur"]), default=None)
        tree[e["name"], parent and parent["name"]] += 1
    return out, tree


def test_span_is_a_shared_no_op_without_a_profiler():
    assert trace.span("i2pnet/a") is trace.span("i2pnet/b")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(trace.span("i2pnet/a"), torch.profiler.record_function)


@pytest.fixture
def no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span built a record_function with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_no_profiler_builds_no_record_function(family, tmp_path, no_record_function):
    assert torch.isfinite(_cascade(family, tmp_path)).all()
    assert all(torch.isfinite(p).all() for p in _step(family, 1).values())


def _model_spans(parent, family):
    return {("i2pnet/model/rgb_encoder", parent): 1, ("i2pnet/model/lidar_encoder", parent): 1,
            ("i2pnet/model/cost_volume", parent): COST_VOLUMES[family]}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_cascade_spans_and_out3(family, tmp_path, one_thread):
    off = _cascade(family, tmp_path)
    on, tree = _traced(lambda: _cascade(family, tmp_path), tmp_path)
    want = Counter({("i2pnet/data/to_device", None): 1, ("i2pnet/eval/cascade", None): 1})
    for si in range(2):
        stage = f"i2pnet/eval/stage{si}"
        want[stage, "i2pnet/eval/cascade"] = 1
        want.update(_model_spans(stage, family))
    assert tree == want
    assert sum(tree.values()) <= 16
    assert torch.equal(on, off)


@pytest.mark.parametrize("family,accum", [("free", 1), ("proj", 1), ("free", 2)])
def test_train_step_spans_and_update(family, accum, tmp_path, one_thread):
    off = _step(family, accum)
    on, tree = _traced(lambda: _step(family, accum), tmp_path)
    step, fwd = "i2pnet/train/step", "i2pnet/train/forward"
    want = Counter({(step, None): 1, (fwd, step): accum, ("i2pnet/train/backward", step): accum,
                    ("i2pnet/train/optimizer", step): 1})
    want.update({k: v * accum for k, v in _model_spans(fwd, family).items()})
    assert tree == want
    assert sum(tree.values()) <= 16
    assert on.keys() == off.keys()
    assert all(torch.equal(on[n], off[n]) for n in off)
