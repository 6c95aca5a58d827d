"""The reference-checkpoint bridge (``i2pnet_tpu_torch/convert.py``
``reference_to_state_dict``, ``tools/reference_ckpt_to_torch.py``) against
the JAX package's ``tools/convert_torch_checkpoint.py``, on the CPU.

A reference-named ``state_dict`` (``RegNet_v2``'s names and layouts) is built
here from a JAX variables tree by the inverse of the mapping: 3x3 convs
(out, in, kh, kw), 1x1 convs (out, in, 1, 1), the pose heads' Conv1d
(out, in, 1), BatchNorm weight/bias/running_mean/running_var, the proj
family's point-side BatchNorm without running statistics. JAX's
``convert_free_point`` / ``convert_proj`` must give the tree back exactly,
which proves the inverse; the port's bridge must then give
``flax_to_state_dict`` of the same tree exactly, and the bridged port model
JAX's out3/out4 within the f32 bar of tests/test_torch_model.py (2e-4).
Shapes of the shipped configs come from ``jax.eval_shape``."""

import argparse
import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import evaluate_torch
from i2pnet_tpu.config import I2PNetConfig as JaxConfig
from i2pnet_tpu.config import I2PNetProjConfig as JaxProjConfig
from i2pnet_tpu.models import I2PNet as JaxI2PNet
from i2pnet_tpu.models import I2PNetProj as JaxI2PNetProj
from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
from i2pnet_tpu_torch.convert import (flax_to_state_dict, reference_to_flax_free,
                                      reference_to_flax_proj, reference_to_state_dict)
from i2pnet_tpu_torch.models import I2PNet, I2PNetProj
from i2pnet_tpu_torch.train.checkpoint import CheckpointManager
from _torch_util import n, randomize_stats
from test_torch_data import write_large_range_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W, N = 2, 64, 128, 512


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_TOOL = _load_tool("convert_torch_checkpoint")
PORT_TOOL = _load_tool("reference_ckpt_to_torch")

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _index(scope: str) -> int:
    return int(scope.rsplit("_", 1)[1])


def _reference_name(path, proj: bool) -> str:
    """A flax leaf's path -> its name in the reference's RegNet_v2."""
    leaf = _LEAF[path[-1]]
    head = path[0]
    if head == "rgb_encoder":  # RGB_net{s}: conv at 4 i, its BatchNorm at 4 i + 1
        i = _index(path[2])
        return f"RGB_net{_index(path[1]) + 1}.{4 * i + (path[2] != f'Conv_{i}')}.{leaf}"
    if head in ("l3_head", "l4_head"):
        return f"{head}.{path[1]}.composed_module.0.{leaf}"
    src = head.replace("lidar_lv", "LiDAR_lv")
    if not proj and (head.startswith("lidar_lv") or head == "layer_idx"):
        kind = "mlp_convs" if path[1].startswith("Dense") else "mlp_bns"
        return f"{src}.{kind}.{_index(path[1])}.{leaf}"
    parts = [src]
    for scope in path[1:-1]:
        if scope.startswith("PointwiseConv_"):
            parts.append(str(_index(scope)))
        elif scope == "Dense_0":
            parts.append("conv")
        elif scope in ("BatchNorm_0", "BatchStatsNorm_0"):
            parts.append("bn_linear")
        else:
            parts.append(scope)
    return ".".join(parts + [leaf])


def to_reference(variables, proj: bool) -> dict:
    """The inverse of the JAX tool's mapping: a flax tree -> the reference's
    state_dict (numpy, in the reference's layouts)."""
    out = {}
    for collection in ("params", "batch_stats"):
        flat = jax.tree_util.tree_flatten_with_path(variables.get(collection, {}))[0]
        for path, value in flat:
            keys = tuple(p.key for p in path)
            a = np.array(value, np.float32)
            if keys in (("sq",), ("sx",)):
                out[keys[0]] = a
                continue
            name = _reference_name(keys, proj)
            if keys[-1] == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                if a.ndim == 2:  # 1x1 Conv2d, the heads' Conv1d
                    a = a[:, :, None] if keys[0] in ("l3_head", "l4_head") else a[:, :, None, None]
            assert name not in out, name
            out[name] = np.ascontiguousarray(a)
    return out


def _abstract(proj: bool, shipped: bool):
    if proj:
        cfg = JaxProjConfig() if shipped else JaxProjConfig.tiny()
        x = (1, 160, 512, 3) if shipped else (1, H, W, 3)
        shapes = [x, (1, N, 3), (1, N, 3), (1, 3, 3)]
        fn = lambda a, b, c, d: JaxI2PNetProj(cfg).init(jax.random.key(0), a, b, c, d,  # noqa: E731
                                                         train=False)
    else:
        cfg = JaxConfig() if shipped else JaxConfig.tiny()
        shapes = [(1, 128, 256, 3) if shipped else (1, H, W, 3), (1, cfg.lidar_in_points, 3),
                  (1, 3, 3)]
        fn = lambda a, b, c: JaxI2PNet(cfg).init(jax.random.key(0), a, b, c)  # noqa: E731
    return cfg, jax.eval_shape(fn, *(jax.ShapeDtypeStruct(s, np.float32) for s in shapes))


def _tree_equal(a, b) -> None:
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def _port_model(proj: bool, cfg):
    from dataclasses import asdict

    return (I2PNetProj(I2PNetProjConfig(**asdict(cfg)), device="cpu") if proj
            else I2PNet(I2PNetConfig(**asdict(cfg)), device="cpu"))


@pytest.mark.parametrize("proj", [False, True], ids=["free", "proj"])
@pytest.mark.parametrize("shipped", [False, True], ids=["tiny", "shipped"])
def test_inverse_gives_the_tree_back(proj, shipped, tmp_path):
    """JAX's converter gives the tree back from the inverse, the port's
    first half equals JAX's converter, and the bridged state_dict is
    flax_to_state_dict of the tree, loading strictly into the port model;
    at the shipped config, through the tool's own model."""
    cfg, shapes = _abstract(proj, shipped)
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), dict(shapes))
    ref_sd = to_reference(variables, proj)
    jax_convert = JAX_TOOL.convert_proj if proj else JAX_TOOL.convert_free_point
    tree = jax_convert(ref_sd)
    _tree_equal(tree, {"params": variables["params"],
                       "batch_stats": variables.get("batch_stats", {})})
    _tree_equal((reference_to_flax_proj if proj else reference_to_flax_free)(ref_sd), tree)

    sd = reference_to_state_dict({k: torch.from_numpy(v) for k, v in ref_sd.items()}, proj)
    want = flax_to_state_dict(variables)
    assert sorted(sd) == sorted(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    path = str(tmp_path / "ref.pth")
    torch.save({k: torch.from_numpy(v) for k, v in ref_sd.items()}, path)
    out = str(tmp_path / "out")
    if shipped:
        PORT_TOOL.main([path, out] + (["--proj"] if proj else []))
    else:
        PORT_TOOL.convert(path, out, proj, model=_port_model(proj, cfg))
    saved = CheckpointManager(out).restore_best("model_rotation_best")["model"]
    assert sorted(saved) == sorted(want) and all(torch.equal(saved[k], want[k]) for k in want)
    if proj:  # the stateless point-side norms carry no running buffers
        assert all(k.startswith("rgb_encoder.") for k in saved if k.endswith("running_mean"))


def _free_inputs():
    rng = np.random.default_rng(0)
    rgb = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    lidar = rng.uniform(-10, 10, size=(B, N, 3)).astype(np.float32)
    lidar[..., 2] += 20.0
    k = np.tile(np.array([[[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1))
    return rgb, lidar, k


def _proj_inputs():
    rng = np.random.default_rng(0)
    rgb = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    raw = (rng.normal(size=(B, N, 3)) * 10).astype(np.float32)
    raw[:, N // 2:] = 0.0
    lidar = (raw + np.array([1.0, 0.0, 0.5], np.float32)) * (np.sum(raw**2, -1, keepdims=True) > 0)
    k = np.tile(np.array([[[64.0, 0, 64], [0, 64.0, 32], [0, 0, 1]]], np.float32), (B, 1, 1))
    return rgb, lidar.astype(np.float32), raw, k


@pytest.mark.parametrize("proj", [False, True], ids=["free", "proj"])
def test_bridged_model_matches_jax(proj):
    """A reference file's layout ({'model_state_dict': {'module.' + name:
    tensor}}) through the bridge: the port model gives JAX's out3/out4 on the
    same tree within 2e-4 (f32)."""
    cfg = JaxProjConfig.tiny() if proj else JaxConfig.tiny()
    inputs = _proj_inputs() if proj else _free_inputs()
    jm = (JaxI2PNetProj if proj else JaxI2PNet)(cfg)
    init = jax.jit(functools.partial(jm.init, train=False))
    v = randomize_stats(init(jax.random.key(2), *inputs), np.random.default_rng(4))
    ref = jm.apply(v, *inputs, train=False)
    raw = {"epoch": 7, "model_state_dict": {
        "module." + k: torch.from_numpy(a) for k, a in to_reference(v, proj).items()}}
    model = _port_model(proj, cfg)
    model.load_state_dict(reference_to_state_dict(raw, proj), strict=True)
    with torch.no_grad():
        out = model.eval()(*(torch.from_numpy(a) for a in inputs))
    for key in ("out3", "out4"):
        got = n(out[key])
        assert got.shape == (B, 7) and np.isfinite(got).all()
        assert float(np.abs(got - n(ref[key])).max()) <= 2e-4, key


def _tiny_proj_reference(seed: int = 0) -> dict:
    cfg, shapes = _abstract(True, False)
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32), dict(shapes))
    variables = randomize_stats(variables, rng)
    return {k: torch.from_numpy(a) for k, a in to_reference(variables, True).items()}


def test_prefix_and_wrapper_are_taken():
    """A leading DataParallel 'module.' is stripped (only a leading one) and
    'model_state_dict' is taken where present: all four layouts bridge to
    the same state_dict."""
    sd = _tiny_proj_reference()
    plain = reference_to_state_dict(sd, True)
    for raw in ({"model_state_dict": sd}, {"module." + k: v for k, v in sd.items()},
                {"model_state_dict": {"module." + k: v for k, v in sd.items()}, "epoch": 3}):
        got = reference_to_state_dict(raw, True)
        assert sorted(got) == sorted(plain) and all(torch.equal(got[k], plain[k]) for k in plain)
    # interior names keep their 'composed_module.0'
    assert any(".composed_module.0." in k for k in sd)


def test_missing_key_raises(tmp_path):
    """A reference key the mapping reads and the file lacks raises; one it
    skips leaves a parameter missing, and the strict load in the tool
    raises."""
    sd = _tiny_proj_reference()
    with pytest.raises(KeyError, match="running_var"):
        reference_to_state_dict({k: v for k, v in sd.items()
                                 if k != "RGB_net1.1.running_var"}, True)
    # the last point-side conv of the first SA level: the stack ends early
    last = max(k for k in sd if k.startswith("LiDAR_lv1.mlp_convs.") and k.endswith("conv.weight"))
    stem = last[:-len("conv.weight")]
    path = str(tmp_path / "short.pt")
    torch.save({k: v for k, v in sd.items() if not k.startswith(stem)}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        PORT_TOOL.convert(path, str(tmp_path / "out"), True,
                          model=_port_model(True, JaxProjConfig.tiny()))


def test_weights_only_refusal_names_the_file(tmp_path):
    """A file that holds more than tensors and plain containers is refused,
    the error naming it; it is never read with weights_only=False."""
    path = str(tmp_path / "pickled.pt")
    torch.save({"model_state_dict": _tiny_proj_reference(), "args": argparse.Namespace(lr=1.0)},
               path)
    with pytest.raises(ValueError, match="pickled.pt"):
        PORT_TOOL.main([path, str(tmp_path / "out"), "--proj"])


def test_tool_writes_a_log_dir_evaluate_torch_reads(tmp_path):
    """tools/reference_ckpt_to_torch.py writes <out>/torch/best/<best>.pt
    with the port's CheckpointManager (the bridged state_dict bit for bit),
    and evaluate_torch.py --device cpu evaluates it."""
    sd = _tiny_proj_reference(5)
    ckpt = str(tmp_path / "ref.pth")
    torch.save({"model_state_dict": {"module." + k: v for k, v in sd.items()}, "epoch": 9}, ckpt)
    out = str(tmp_path / "ref_log")
    path = PORT_TOOL.convert(ckpt, out, True, model=_port_model(True, JaxProjConfig.tiny()))
    assert path == os.path.join(out, "torch", "best", "model_rotation_best.pt")
    saved = CheckpointManager(out).restore_best("model_rotation_best")["model"]
    want = reference_to_state_dict(sd, True)
    assert sorted(saved) == sorted(want) and all(torch.equal(saved[k], want[k]) for k in want)

    root = write_large_range_tree(str(tmp_path / "data"), (7, 8), 1, 3000, seed=5)
    summary = evaluate_torch.main(["--tiny", "--root_path", root, "--model_dir", out, "--device",
                                   "cpu", "--batch_size", "2", "--log_dir", str(tmp_path / "eval")])
    assert summary["count"] == 2 and np.isfinite(summary["rre_mean"])
