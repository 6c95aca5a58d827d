"""The port's third slice as a whole: the projection-family I2PNetProj eval
forward against the JAX package on the same inputs and weights, on the
CPU (``I2PNetProjConfig.tiny()``, B=2, a 64x128 image, 512 points of which
the tail half is zero padding, as tests/test_model_proj.py).

f32: out3/out4 within 2e-4 (one refinement pass and three), the eval-info
outputs too. bf16: the JAX side runs its selection and encoder-block
kernels in interpret mode, the port their plain versions; out3/out4
within 3e-2 max and 5e-3 mean, the free-point slice's bars
(tests/test_torch_model.py): bf16 roundings fall at other points in the two
frameworks. The JAX runs are shared through module-scoped fixtures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.config import I2PNetProjConfig as JaxProjConfig
from i2pnet_tpu.models import I2PNetProj as JaxI2PNetProj
from i2pnet_tpu.ops import quaternion as JQ
from i2pnet_tpu_torch.config import I2PNetProjConfig
from i2pnet_tpu_torch.models import I2PNetProj
from i2pnet_tpu_torch.ops import conv_cuda, cv_cuda, fps_cuda, select_cuda
from _torch_util import n, port, t

B, H, W, N = 2, 64, 128, 512
CONFIGS = {
    "f32": JaxProjConfig.tiny(),
    "bf16": dataclasses.replace(JaxProjConfig.tiny(), compute_dtype="bfloat16"),
}


def _inputs():
    rng = np.random.default_rng(0)
    rgb = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    raw = (rng.normal(size=(B, N, 3)) * 10).astype(np.float32)
    raw[:, N // 2:] = 0.0  # the zero-padded tail of the large-range loader
    ang = 0.2
    q = np.array([[np.cos(ang / 2), 0, np.sin(ang / 2), 0]] * B, np.float32)
    lidar = np.asarray(JQ.warp_points(raw, q, np.array([[1.0, 0, 0.5]] * B, np.float32)))
    lidar = lidar * (np.sum(raw**2, -1, keepdims=True) > 0)
    k = np.tile(np.array([[[64.0, 0, 64], [0, 64.0, 32], [0, 0, 1]]], np.float32), (B, 1, 1))
    return rgb, lidar.astype(np.float32), raw, k


def _port_cfg(cfg):
    return I2PNetProjConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def variables():
    v = JaxI2PNetProj(CONFIGS["f32"]).init(jax.random.key(0), *_inputs(), train=False)
    return jax.tree_util.tree_map(np.asarray, dict(v))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def slice_run(request, variables):
    """(name, JAX eval-info outputs, port model with eval_info): the JAX
    kernels in interpret mode wherever they route (bf16)."""
    cfg = CONFIGS[request.param]
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "bf16":
            mp.setenv("I2PNET_PROJ_DENSE_EVAL", "interpret")
            mp.setenv("I2PNET_FUSED_EVAL", "interpret")
        ref = JaxI2PNetProj(cfg, eval_info=True).apply(variables, *_inputs(), train=False)
    model = port(I2PNetProj(_port_cfg(cfg), eval_info=True, device="cpu"), variables)
    return request.param, {k: n(ref[k]) for k in ("out3", "out4", "W_l3", "P3", "P4")}, model


def _counts():
    return (fps_cuda.launches, conv_cuda.launches, cv_cuda.launches, select_cuda.launches)


def test_slice_matches_jax(slice_run):
    name, ref, model = slice_run
    counts = _counts()
    with torch.no_grad():
        out = model(*map(t, _inputs()))
    assert _counts() == counts  # CPU: every kernel's plain version
    for key in ("out3", "out4"):
        got = n(out[key])
        assert got.shape == (B, 7) and np.isfinite(got).all()
        d = np.abs(got - ref[key])
        if name == "f32":
            assert float(d.max()) <= 2e-4, key
        else:
            assert float(d.max()) <= 3e-2 and float(d.mean()) <= 5e-3, key
        np.testing.assert_allclose(np.linalg.norm(got[:, :4], axis=-1), 1.0, atol=1e-3)
    assert out["pm3"] is None and out["pm4"] is None
    # eval_info: the l3 grid and the l4 grid exactly, the l3 head's weights
    np.testing.assert_array_equal(n(out["P3"]), ref["P3"])
    np.testing.assert_array_equal(n(out["P4"]), ref["P4"])
    assert out["W_l3"].shape == ref["W_l3"].shape
    if name == "f32":
        np.testing.assert_allclose(n(out["W_l3"]), ref["W_l3"], atol=2e-4)


def test_slice_routes_the_kernels(slice_run, monkeypatch):
    """Every LiDAR level (lidar_lv1-4, layer_idx) takes its multiplicities
    from the selection route at eval, 5 per forward; in bf16 every encoder
    block takes the fused block (6 at the tiny widths), in f32 none."""
    name, _, model = slice_run
    calls = {"select": 0, "block": 0}
    plain, block = select_cuda.selection_multiplicity_plain, conv_cuda.fused_conv_block

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(select_cuda, "selection_multiplicity_plain", count("select", plain))
    monkeypatch.setattr(conv_cuda, "fused_conv_block", count("block", block))
    with torch.no_grad():
        model(*map(t, _inputs()))
    assert calls == {"select": 5, "block": 6 if name == "bf16" else 0}


def test_refine_iters_f32(variables):
    """refine_iters=3 re-runs the l3 refinement with shared weights."""
    cfg = dataclasses.replace(CONFIGS["f32"], refine_iters=3)
    ref = JaxI2PNetProj(cfg).apply(variables, *_inputs(), train=False)
    model = port(I2PNetProj(_port_cfg(cfg), device="cpu"), variables)
    with torch.no_grad():
        out = model(*map(t, _inputs()))
    for key in ("out3", "out4"):
        assert float(np.abs(n(out[key]) - n(ref[key])).max()) <= 2e-4, key


def test_model_builds_on_the_card_by_default(monkeypatch):
    """Without a card, the default device raises; the CPU runs only when
    asked for. A train-mode forward (the gathered route) runs too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        I2PNetProj(I2PNetProjConfig.tiny())
    model = I2PNetProj(I2PNetProjConfig.tiny(), device="cpu")
    out = model(*map(t, _inputs()), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out["out3"]).all() and out["out3"].requires_grad


@pytest.mark.parametrize("make", ["tiny", "shipped"])
def test_bridge_loads_the_proj_variables_strict(make):
    """Every flax leaf of I2PNetProj maps to one state_dict entry and loads
    strictly; BatchStatsNorm_0/{scale, bias} become weight/bias, and the
    only batch_stats are the RGB encoder's. Shapes from jax.eval_shape, so
    the shipped config is never run here."""
    from i2pnet_tpu_torch.convert import flax_to_state_dict, load_flax_variables

    cfg = JaxProjConfig.tiny() if make == "tiny" else JaxProjConfig()
    # the shipped cost_volume2 groups 32 pixels: bench.py's 160x512 image
    x = (1, H, W, 3) if make == "tiny" else (1, 160, 512, 3)
    pts, k = (1, N, 3), (1, 3, 3)
    shapes = jax.eval_shape(
        lambda a, b, c, d: JaxI2PNetProj(cfg).init(jax.random.key(0), a, b, c, d, train=False),
        *(jax.ShapeDtypeStruct(s, np.float32) for s in (x, pts, pts, k)))
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), dict(shapes))
    assert set(variables["batch_stats"]) == {"rgb_encoder"}
    model = I2PNetProj(_port_cfg(cfg), device="cpu")
    sd = flax_to_state_dict(variables)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    load_flax_variables(model, variables)  # strict=True
    norm = variables["params"]["lidar_lv1"]["mlp_convs"]["PointwiseConv_0"]["BatchStatsNorm_0"]
    got = model.lidar_lv1.mlp_convs.PointwiseConv_0.BatchStatsNorm_0
    np.testing.assert_array_equal(got.weight.detach().numpy(), norm["scale"])
    np.testing.assert_array_equal(got.bias.detach().numpy(), norm["bias"])
