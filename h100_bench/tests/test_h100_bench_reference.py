"""The frozen reference against the program at the small configurations,
float32, on the CPU: both families' eval forwards, and three training
steps (each loss, the first gradient as Adam takes it, the parameters
after Adam). The harness never imports the program's math into the
reference; this test alone holds the two side by side."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from h100_bench import harness
from h100_bench.loops import train as train_loop
from h100_bench.reference import nets
from h100_bench.reference import train as rtrain


def _mc(cfg) -> dict:
    return json.loads(json.dumps({f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}))


def _inputs(family, cfg, B=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    N = cfg.lidar_in_points if family == "free" else 1500
    rgb = torch.rand(B, 64, 128, 3, generator=g) * 255
    raw = torch.randn(B, N, 3, generator=g) * 10
    if family == "proj":
        raw[:, -100:] = 0
    lidar = torch.stack([-raw[..., 1], -raw[..., 2], raw[..., 0]], -1)
    if family == "free":
        lidar[..., 2] = lidar[..., 2].abs() + 3
    K = torch.tensor([[60.0, 0, 64], [0, 60.0, 32], [0, 0, 1]]).expand(B, 3, 3).contiguous()
    q = torch.nn.functional.normalize(torch.randn(B, 4, generator=g), dim=-1)
    return dict(rgb=rgb, lidar=lidar, raw_xyz=raw, intrinsic=K, lidar_feats=lidar.clone(),
                decalib_q_gt=q, decalib_t_gt=torch.randn(B, 3, generator=g))


def _model(family):
    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
    from i2pnet_tpu_torch.models.i2pnet import I2PNet
    from i2pnet_tpu_torch.models.i2pnet_proj import I2PNetProj

    cfg = I2PNetConfig.tiny() if family == "free" else I2PNetProjConfig.tiny()
    return cfg, (I2PNet if family == "free" else I2PNetProj)(cfg, device="cpu")


@pytest.mark.parametrize("family", ["free", "proj"])
def test_eval_forward_matches_the_program(family):
    cfg, model = _model(family)
    mc = _mc(cfg)
    W = harness.make_weights(family, mc, 2**31 + 5, 0, "cpu")
    b = _inputs(family, cfg)
    harness.calibrate(family, mc, W, b)
    model.load_state_dict(W, strict=True)
    model.eval()
    with torch.no_grad():
        if family == "free":
            out = model(b["rgb"], b["lidar"], b["intrinsic"], lidar_feature=b["lidar_feats"],
                        raw_xyz=b["raw_xyz"])
        else:
            out = model(b["rgb"], b["lidar"], b["raw_xyz"], b["intrinsic"],
                        lidar_feature=b["lidar_feats"])
        r3, r4 = nets.forward(family)(nets.Run(W), mc, b["rgb"], b["lidar"], b["intrinsic"],
                                       b["lidar_feats"], b["raw_xyz"])
    # float32 on both sides, summed in other orders
    assert torch.allclose(out["out3"], r3, atol=2e-5, rtol=1e-4)
    assert torch.allclose(out["out4"], r4, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("family", ["free", "proj"])
def test_three_train_steps_match_the_program(family):
    from i2pnet_tpu_torch.train.state import create_train_state
    from i2pnet_tpu_torch.train.step import make_train_step, make_train_step_proj

    cfg, model = _model(family)
    mc = dict(_mc(cfg), _steps_per_epoch=2)
    W = harness.make_weights(family, mc, 7, 0, "cpu")
    model.load_state_dict(W, strict=True)
    state = create_train_state(model, steps_per_epoch=2)
    step = (make_train_step if family == "free" else make_train_step_proj)(model, cfg)
    batches = [_inputs(family, cfg, seed=s) for s in range(3)]
    gen = torch.Generator().manual_seed(11)
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    losses = []
    for k in range(3):
        losses.append(float(step(state, batches[k], gen)["loss"]))
        if k == 0:
            grad = {n: state.optimizer.state[params[n]]["exp_avg"] / 0.1 for n in names}
    gref = torch.Generator().manual_seed(11)
    uniforms = [torch.rand(2, 1, mc["head_hidden_dim"], generator=gref) for _ in range(6)]
    P = {n: W[n].clone() for n in W}
    opt = rtrain.Adam({n: P[n] for n in names}, steps_per_epoch=2)
    for k in range(3):
        loss, grads = rtrain.loss_and_grads(family, mc, P, batches[k], uniforms[2 * k:2 * k + 2],
                                            trainable=names)
        seen = opt.step(P, grads)
        # Adam's first update moves every element by about lr whatever the
        # size of its gradient, so an element whose gradient is nought to
        # rounding (a bias before a batch-statistics norm) moves by +-lr
        # on either side at random: the later losses agree less closely
        tol = 1e-5 if k == 0 else 5e-3
        assert abs(float(loss) - losses[k]) <= tol * abs(losses[k]), k
        if k == 0:
            bare = {n: grads[n].norm() for n in names}
            med = torch.stack([seen[n].norm() for n in names]).median()
            for n in names:
                scale = torch.maximum(seen[n].norm(), med)
                assert (grad[n] - seen[n]).norm() <= 1e-4 * scale, n
    med = torch.stack(list(bare.values())).median()
    kept = [n for n in names if bare[n] >= train_loop.TINY_GRAD * med]
    for n in kept:
        moved = (params[n].detach() - W[n]).norm()
        assert abs(moved - (P[n] - W[n]).norm()) <= 0.05 * moved, n


def test_reference_imports_nothing_of_the_program():
    import ast
    import pathlib

    for path in pathlib.Path(harness.BENCH, "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] in ("torch", "math", "collections", "typing", "importlib",
                                          "re", "__future__"), (path.name, name)
