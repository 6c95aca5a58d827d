"""The proj eval forward's segment graphs (``utils/graphs.py``).

On the CPU: when a segment must run eagerly (``eager_reason``), the key
(``graph_key``), the cap on graphs, fresh outputs, dropped graphs after the
weights move, and the tiny ``I2PNetProj`` through the whole warm-up,
capture and replay sequence with a stand-in for the CUDA graph that runs
the segment on its static buffers (a CUDA graph cannot run here), equal bit
for bit to the eager forward.

On the card (marked ``cuda``, skipped without one): the evaluator's
two-stage bf16 cascade at the large-range shapes (160x512, 150000 points,
B=8) and at B=1, replayed against eager over three batches, a kept output
against the next replay, the counters, and a CUDA graph of the whole
cascade around the segments. The file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs.py
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from i2pnet_tpu_torch.config import I2PNetProjConfig
from i2pnet_tpu_torch.models import I2PNetProj, init_random_
from i2pnet_tpu_torch.ops import quaternion as Q
from i2pnet_tpu_torch.parallel.mesh import Mesh, set_mesh
from i2pnet_tpu_torch.utils import graphs

CUDA = torch.device("cuda")


class CpuGraph:
    """Stands in for ``graphs._Graph`` on the CPU: static copies of the first
    inputs, static outputs allocated at the capture, and a replay that runs
    the segment on the static inputs into the static outputs."""

    def __init__(self, fn, inputs):
        self.fn = fn
        self.inputs = tuple(torch.empty_like(x).copy_(x) for x in inputs)
        self.outputs = tuple(torch.empty_like(o) for o in fn(*self.inputs))

    def replay(self):
        for s, o in zip(self.outputs, self.fn(*self.inputs)):
            s.copy_(o)


def use_stand_in(monkeypatch):
    """Segments on CPU tensors take the card's path, with ``CpuGraph``."""
    real = graphs.eager_reason
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(graphs, "eager_reason", lambda owner, device: real(owner, CUDA))
    monkeypatch.setattr(graphs, "_Graph", CpuGraph)


@pytest.fixture
def stand_in(monkeypatch):
    use_stand_in(monkeypatch)


# --- when a segment replays -----------------------------------------------------

class _Exported(torch.nn.Module):
    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def forward(self, x):
        with torch.no_grad():
            self.seen.append(graphs.eager_reason(self, CUDA))
        return x * 2


@pytest.mark.parametrize("case", ["none", "inference", "cpu", "training", "grad", "mesh",
                                  "export", "capturing"])
def test_eager_reason(case, monkeypatch):
    """None where every condition holds (grad off by no_grad or by
    inference_mode); else the one that fails."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: case == "capturing")
    if case == "export":  # a real (non-strict) export, as tools/export_model_torch.py makes
        seen = []
        torch.export.export(_Exported(seen).eval(), (torch.ones(3),), strict=False)
        assert seen == ["export"]
        return
    owner = torch.nn.Linear(2, 2).train(case == "training")
    device = torch.device("cpu") if case == "cpu" else CUDA
    mesh = Mesh(0, 1, CUDA) if case == "mesh" else None
    grad = torch.inference_mode() if case == "inference" else torch.set_grad_enabled(
        case == "grad")
    with grad, set_mesh(mesh):
        assert graphs.eager_reason(owner, device) == (
            None if case in ("none", "inference") else case)


def test_key_follows_the_switches(monkeypatch):
    x = torch.zeros(2, 3)
    monkeypatch.delenv("I2PNET_PW_BN_F32", raising=False)
    off = graphs.graph_key([x])
    assert graphs.graph_key([torch.ones(2, 3)]) == off
    monkeypatch.setenv("I2PNET_PW_BN_F32", "1")
    assert graphs.graph_key([x]) != off
    monkeypatch.setenv("I2PNET_PW_BN_F32", "0")
    assert graphs.graph_key([x]) == off
    assert graphs.graph_key([x.t()]) != graphs.graph_key([x.t().contiguous()])
    with torch.inference_mode():
        assert graphs.graph_key([x]) != off


# --- the holder, with the stand-in ------------------------------------------------

def _double(x):
    return (x * 2,)


def test_cap_is_held(stand_in):
    owner, g = torch.nn.Linear(2, 2).eval(), graphs.Graphs()
    with torch.no_grad():
        for n in range(1, 2 * graphs.CAP + 1):
            for _ in range(3):
                x = torch.arange(float(n))
                assert torch.equal(g.run(owner, "s", _double, x)[0], 2 * x)
    counts = g.counts["s"]
    assert len(g._graphs["s"]) == counts["capture"] == graphs.CAP
    assert counts["eager:warmup"] == 2 * graphs.CAP
    assert counts["eager:cap"] == 2 * graphs.CAP
    assert counts["replay"] == 2 * graphs.CAP
    # every call either ran eagerly or replayed (a capture replays too)
    assert sum(counts.values()) - counts["capture"] == 6 * graphs.CAP


def test_outputs_are_fresh_and_moved_weights_drop_the_graphs(stand_in):
    owner, g = torch.nn.Linear(3, 3).eval(), graphs.Graphs()

    def seg(x):
        return (owner(x),)

    with torch.no_grad():
        outs = [g.run(owner, "s", seg, torch.full((2, 3), float(i)))[0] for i in range(4)]
        for i, out in enumerate(outs):
            assert torch.equal(out, owner(torch.full((2, 3), float(i))))
        assert g.counts["s"] == {"eager:warmup": 1, "capture": 1, "replay": 3}
        owner.weight.mul_(2.0)  # in place: the graph reads it
        assert torch.equal(g.run(owner, "s", seg, torch.ones(2, 3))[0], owner(torch.ones(2, 3)))
        assert g.counts["s"]["replay"] == 4
        owner.weight.data = owner.weight.data.clone()  # moved: the graphs go
        g.run(owner, "s", seg, torch.ones(2, 3))
    assert g.counts["s"]["dropped"] == 1 and g.counts["s"]["eager:warmup"] == 2
    assert not g._graphs["s"]
    assert not copy.deepcopy(g)._graphs and not copy.deepcopy(g).counts


# --- the tiny proj model ------------------------------------------------------------

TINY = {"f32": {}, "bf16": {"compute_dtype": "bfloat16"}, "refine3": {"refine_iters": 3}}


def _tiny_inputs(seed, B=2, H=64, W=128, N=512):
    rng = np.random.default_rng(seed)
    raw = (rng.normal(size=(B, N, 3)) * 10).astype(np.float32)
    raw[:, N // 2:] = 0.0
    rgb = torch.from_numpy(rng.normal(size=(B, H, W, 3)).astype(np.float32))
    raw = torch.from_numpy(raw)
    q = torch.tensor([[0.995, 0.0, 0.0998, 0.0]] * B)
    lidar = Q.warp_points(raw, q, torch.tensor([[1.0, 0.0, 0.5]] * B))
    lidar = lidar * (torch.sum(raw**2, -1, keepdim=True) > 0)
    k = torch.tensor([[[64.0, 0, 64], [0, 64.0, 32], [0, 0, 1]]] * B)
    return rgb, lidar, raw, k


@pytest.mark.parametrize("variant", sorted(TINY))
def test_proj_segments_replay_as_the_eager_forward(variant, monkeypatch):
    cfg = dataclasses.replace(I2PNetProjConfig.tiny(), **TINY[variant])
    model = init_random_(I2PNetProj(cfg, eval_info=True, device="cpu"),
                         torch.Generator().manual_seed(0)).eval()
    batches = [_tiny_inputs(s) for s in range(4)]
    keys = ("out3", "out4", "W_l3", "P3", "P4")
    with torch.inference_mode():
        eager = [model(*b) for b in batches]
    assert dict(model.graphs.counts) == {"cost_volume1": {"eager:cpu": 4},
                                         "heads": {"eager:cpu": 4}}
    model.graphs = graphs.Graphs()
    use_stand_in(monkeypatch)
    with torch.inference_mode():
        outs = [model(*b) for b in batches]
    for got, want in zip(outs, eager):  # every output kept, none overwritten
        for k in keys:
            assert torch.equal(got[k], want[k]), k
    for seg in ("cost_volume1", "heads"):
        assert model.graphs.counts[seg] == {"eager:warmup": 1, "capture": 1, "replay": 3}
    assert not copy.deepcopy(model).graphs._graphs


def test_training_never_replays(stand_in):
    """Train mode (grad on) and eval with grad on run every segment eagerly,
    even where the card's path is taken."""
    model = init_random_(I2PNetProj(I2PNetProjConfig.tiny(), device="cpu"),
                         torch.Generator().manual_seed(0)).train()
    for _ in range(3):
        out = model(*_tiny_inputs(0), generator=torch.Generator().manual_seed(1))
        out["out3"].sum().backward()
    model.eval()
    model(*_tiny_inputs(0))
    for seg in ("cost_volume1", "heads"):
        assert model.graphs.counts[seg] == {"eager:training": 3, "eager:grad": 1}


# --- on the card ----------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return CUDA


def _card_batch(seed, B, dev, points=150000, pad=30000, H=160, W=512):
    """bench.py's proj inputs at ``seed``: (B, 160, 512) images, 150000
    points a row of which the last 30000 are zero, a small decalibration."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(B, points, 3)).astype(np.float32) * 15
    raw[:, points - pad:] = 0.0
    rgb = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    k = np.tile(np.array([[[350.0, 0, 256], [0, 350.0, 80], [0, 0, 1]]], np.float32), (B, 1, 1))
    rgb, raw, k = (torch.from_numpy(a).to(dev) for a in (rgb, raw, k))
    q = torch.tensor([[0.999, 0.0, 0.04, 0.0]], device=dev).repeat(B, 1)
    t = torch.tensor([[1.0, 0.0, 2.0]], device=dev).repeat(B, 1)
    lidar = Q.warp_points(raw, q, t) * (torch.sum(raw**2, -1, keepdim=True) > 0)
    return {"rgb": rgb, "lidar": lidar, "raw_xyz": raw, "intrinsic": k}


def _stages(ev, batch):
    """(the cascade's out3, each stage's output dict as it was returned)."""
    seen, steps = [], ev._steps
    ev._steps = [lambda b, s=s: seen.append(s(b)) or seen[-1] for s in steps]
    try:
        return ev.cascade(batch), seen
    finally:
        ev._steps = steps


def _frozen(run):
    out3, stages = run
    return out3.clone(), [(o["out3"].clone(), o["out4"].clone()) for o in stages]


def _same(got, want):
    (g3, gs), (w3, ws) = got, want
    assert torch.equal(g3, w3)
    for (a3, a4), (b3, b4) in zip(gs, ws):
        assert torch.equal(a3, b3) and torch.equal(a4, b4)


def _all_eager(models, monkeypatch, ev, batches):
    """Every batch's outputs with every segment eager (a cap of 0); the
    models then get fresh graphs."""
    cap = graphs.CAP
    monkeypatch.setattr(graphs, "CAP", 0)
    want = [_frozen(_stages(ev, b)) for b in batches]
    monkeypatch.setattr(graphs, "CAP", cap)
    for m in models:
        m.graphs = graphs.Graphs()
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 1])
def test_card_cascade_replays_bit_identical(dev, B, tmp_path, monkeypatch):
    from i2pnet_tpu_torch.eval.evaluator import Evaluator

    cfg = dataclasses.replace(I2PNetProjConfig(), compute_dtype="bfloat16")
    models = [init_random_(I2PNetProj(cfg, device=dev), torch.Generator().manual_seed(s)).eval()
              for s in (0, 1)]
    batches = [_card_batch(s, B, dev) for s in range(4)]
    ev = Evaluator(models, cfg, proj=True, log_dir=str(tmp_path), device=dev)
    want = _all_eager(models, monkeypatch, ev, batches)

    # warm-up, capture, then replays; every output kept, none overwritten
    got = [_stages(ev, b) for b in batches]
    for g, w in zip(got, want):
        _same((g[0], [(o["out3"], o["out4"]) for o in g[1]]), w)
    for m in models:
        for seg in ("cost_volume1", "heads"):
            assert m.graphs.counts[seg] == {"eager:warmup": 1, "capture": 1, "replay": 3}

    # a CUDA graph of the whole cascade around them, as chip_smoke.py takes
    # one: replayed on two batches copied into its inputs
    static = {k: v.clone() for k, v in batches[2].items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ev.cascade(static)
    torch.cuda.current_stream().wait_stream(side)
    whole = torch.cuda.CUDAGraph()
    with torch.cuda.graph(whole):
        out3 = ev.cascade(static)
    for i in (3, 2):
        for k, v in batches[i].items():
            static[k].copy_(v)
        whole.replay()
        torch.cuda.synchronize()
        assert torch.equal(out3, want[i][0])
    for m in models:
        for seg in ("cost_volume1", "heads"):
            assert m.graphs.counts[seg]["eager:capturing"] == 1
            assert m.graphs.counts[seg]["capture"] == 1

    # one model serving both stages: stage 1's replay leaves stage 0's output
    twice = Evaluator([models[0]] * 2, cfg, proj=True, log_dir=str(tmp_path), device=dev)
    want = _all_eager(models, monkeypatch, twice, batches[:3])
    got = [_stages(twice, b) for b in batches[:3]]
    for g, w in zip(got, want):
        _same((g[0], [(o["out3"], o["out4"]) for o in g[1]]), w)
    assert models[0].graphs.counts["heads"] == {"eager:warmup": 1, "capture": 1, "replay": 5}
