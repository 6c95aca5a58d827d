"""The port's slice as a whole: the free-point I2PNet eval forward against
the JAX package on the same inputs and weights, on the CPU.

f32: ``I2PNetConfig.tiny()``, B=2, 64x128 image, 512 points; out3/out4
within 2e-4, the JAX package's bar against the reference (README.md).

bf16: the tiny config with a depth-3 cv1 ``mlp1`` (the tiny config's
depth-2 one fails the fused cv1 gate) and ``compute_dtype="bfloat16"``;
the JAX side runs its encoder-block and cv1 Pallas kernels in interpret
mode, the port their plain versions. Bar: max 3e-2, mean 5e-3 on out3/out4
(the fused kernels' own bar against native, tests/test_cv_pallas.py):
bf16 roundings fall at other points in the two frameworks.

The JAX runs are shared through module-scoped fixtures: the cold bf16 JAX
slice alone takes tens of seconds here.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from i2pnet_tpu.config import I2PNetConfig
from i2pnet_tpu.models import I2PNet as JaxI2PNet
from i2pnet_tpu_torch.models import I2PNet
from i2pnet_tpu_torch.ops import conv_cuda, cv_cuda, fps_cuda
from _torch_util import n, port, randomize_stats, t

B, H, W, N = 2, 64, 128, 512

CONFIGS = {
    "f32": I2PNetConfig.tiny(),
    "bf16": dataclasses.replace(
        I2PNetConfig.tiny(), cost_volume_mlps=((16, 16, 16), (16, 16)), compute_dtype="bfloat16"
    ),
}


def _inputs():
    rng = np.random.default_rng(0)
    rgb = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    lidar = rng.uniform(-10, 10, size=(B, N, 3)).astype(np.float32)
    lidar[..., 2] += 20.0
    k = np.tile(np.array([[[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1))
    return rgb, lidar, k


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def slice_run(request):
    """(cfg, JAX outputs, port model) for one config; JAX kernels in
    interpret mode wherever they route."""
    cfg = CONFIGS[request.param]
    inputs = _inputs()
    jm = JaxI2PNet(cfg)
    v = randomize_stats(jm.init(jax.random.key(0), *inputs, train=False), np.random.default_rng(1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I2PNET_FUSED_EVAL", "interpret")
        mp.setenv("I2PNET_FUSED_CV", "interpret")
        ref = jm.apply(v, *inputs, train=False)
    model = port(I2PNet(cfg, device="cpu"), v)
    return request.param, {k: n(ref[k]) for k in ("out3", "out4")}, model, inputs


def test_slice_matches_jax(slice_run):
    name, ref, model, inputs = slice_run
    counts = (fps_cuda.launches, conv_cuda.launches, cv_cuda.launches)
    with torch.no_grad():
        out = model(*map(t, inputs))
    assert (fps_cuda.launches, conv_cuda.launches, cv_cuda.launches) == counts  # CPU: plain
    for key in ("out3", "out4"):
        got = n(out[key])
        assert got.shape == (B, 7) and np.isfinite(got).all()
        d = np.abs(got - ref[key])
        if name == "f32":
            assert float(d.max()) <= 2e-4, key
        else:
            assert float(d.max()) <= 3e-2 and float(d.mean()) <= 5e-3, key
    q = n(out["out3"])[:, :4]
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-3)


def test_slice_routes_the_fused_paths_in_bf16(slice_run, monkeypatch):
    """bf16 eval routes every encoder block through the fused block and
    cv1 through the fused cost volume (6 blocks and 1 cv1 call at the tiny
    widths); f32 routes neither."""
    name, _, model, inputs = slice_run
    calls = {"block": 0, "cv1": 0}
    block, cv1 = conv_cuda.fused_conv_block, cv_cuda.cv1

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(conv_cuda, "fused_conv_block", count("block", block))
    monkeypatch.setattr(cv_cuda, "cv1", count("cv1", cv1))
    with torch.no_grad():
        model(*map(t, inputs))
    expect = {"block": 6, "cv1": 1} if name == "bf16" else {"block": 0, "cv1": 0}
    assert calls == expect


def test_model_refuses_unported_branches():
    """efgh together with projection masks raises ValueError, as the JAX
    model does (and efgh without calib); a train-mode forward (an nn.Module
    starts in training mode) runs with a dropout generator and moves every
    BatchNorm's running statistics."""
    for kw in (dict(use_projection_mask=True), dict(ground_truth_projection_mask=True),
               dict(ground_truth_projection_mask_eval=True)):
        with pytest.raises(ValueError, match="exclusive"):
            I2PNet(dataclasses.replace(I2PNetConfig.tiny(), efgh=True, **kw), device="cpu")
    with pytest.raises(ValueError, match="calib"):
        I2PNet(dataclasses.replace(I2PNetConfig.tiny(), efgh=True), device="cpu")(*map(t, _inputs()))
    model = I2PNet(I2PNetConfig.tiny(), device="cpu")
    before = {k: b.clone() for k, b in model.named_buffers()}
    out = model(*map(t, _inputs()), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out["out3"]).all() and out["out3"].requires_grad
    moved = {k for k, b in model.named_buffers() if not torch.equal(b, before[k])}
    assert moved == set(before)
