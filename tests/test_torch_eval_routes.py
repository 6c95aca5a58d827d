"""The eval-route switches of the JAX package, read by the port at call
time with the same values, held against JAX with the same value, on the
CPU.

``I2PNET_FUSED_EVAL`` (the encoder block), ``I2PNET_FUSED_CV`` (the fused
cost volume) and ``I2PNET_PROJ_DENSE_EVAL`` (the proj levels' dense route):
``0`` takes the native chain on both sides, ``interpret`` the fused route
(JAX's kernel in interpret mode, the port's plain version); any other
value raises in the port. ``I2PNET_PW_BN_F32=1`` applies the pointwise
BatchNorms in f32 on both sides. Bars: the bf16 stage's 2% of the
activation, the cost volume's 3e-2 max / 5e-3 mean and the proj module's
1e-5 (tests/test_torch_fused.py, tests/test_torch_proj_modules.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.nn.costvolume import CostVolume as JaxCostVolume
from i2pnet_tpu.nn.layers import PointwiseMLP as JaxPointwiseMLP
from i2pnet_tpu.nn.layers import RGBEncoder as JaxRGBEncoder
from i2pnet_tpu.nn.proj_backbone import ProjectPointNet as JaxProjectPointNet
from i2pnet_tpu_torch.nn import costvolume, layers, proj_backbone
from i2pnet_tpu_torch.nn.costvolume import CostVolume
from i2pnet_tpu_torch.nn.layers import PointwiseMLP, RGBEncoder
from i2pnet_tpu_torch.nn.proj_backbone import ProjectPointNet
from i2pnet_tpu_torch.ops import conv_cuda, cv_cuda
from _torch_util import n, port, randomize_stats, t


def _count(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("value", ["0", "interpret"])
def test_fused_eval_switch(monkeypatch, value):
    stages = ((3, (16, 16, 32), (2, 1, 2)),)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    jenc = JaxRGBEncoder(stages, dtype=jnp.bfloat16, bn_compute_dtype=True)
    v = randomize_stats(jenc.init(jax.random.key(0), x, train=False), rng, scale=0.5)
    monkeypatch.setenv("I2PNET_FUSED_EVAL", value)
    ref = jenc.apply(v, x, train=False)[-1]
    calls = _count(monkeypatch, conv_cuda, "fused_conv_block")
    enc = port(RGBEncoder(stages, torch.bfloat16, bn_compute_dtype=True), v)
    with torch.no_grad():
        got = enc(t(x))[-1]
    assert len(calls) == (0 if value == "0" else 3)
    assert tuple(got.shape) == ref.shape and got.dtype == torch.bfloat16
    assert float(np.max(np.abs(n(got) - n(ref)))) <= 0.02 * max(float(np.max(np.abs(n(ref)))), 1.0)


@pytest.mark.parametrize("value", ["0", "interpret"])
def test_fused_cv_switch(monkeypatch, value):
    rng = np.random.default_rng(0)
    inputs = (
        rng.normal(size=(2, 16, 3)).astype(np.float32),
        rng.normal(size=(2, 16, 16)).astype(np.float32),
        rng.normal(size=(2, 32, 3)).astype(np.float32),
        rng.normal(size=(2, 32, 16)).astype(np.float32),
        rng.uniform(1, 5, size=(2, 16, 1)).astype(np.float32),
    )
    kw = dict(nsample=4, nsample_q=-1, mlp1=(16, 8, 8), mlp2=(16, 8), backward_validation=True)
    jcv = JaxCostVolume(dtype=jnp.bfloat16, **kw)
    v = randomize_stats(jcv.init(jax.random.PRNGKey(0), *inputs), np.random.default_rng(7), 0.3)
    monkeypatch.setenv("I2PNET_FUSED_CV", value)
    ref = jcv.apply(v, *inputs)
    calls = _count(monkeypatch, cv_cuda, "fused_cv1_eval")
    cv = port(CostVolume(in_channels=16, dtype=torch.bfloat16, **kw), v)
    with torch.no_grad():
        got = cv(*map(t, inputs))
    assert len(calls) == (0 if value == "0" else 1)
    d = np.abs(n(got) - n(ref))
    assert float(d.max()) <= 3e-2 and float(d.mean()) < 5e-3


@pytest.mark.parametrize("value", ["0", "interpret"])
def test_proj_dense_eval_switch(monkeypatch, value):
    level = dict(out_h=4, out_w=8, stride_h=2, stride_w=2, kernel_size=(3, 5), nsample=4,
                 distance=1.5, mlp=(8, 16))
    rng = np.random.default_rng(1)
    xyz_raw = rng.normal(size=(2, 8, 16, 3)).astype(np.float32)
    holes = rng.random((2, 8, 16)) < 0.3
    xyz_raw[holes] = 0.0
    xyz = xyz_raw + rng.normal(size=xyz_raw.shape).astype(np.float32) * 0.05
    xyz[holes] = 0.0
    feat = rng.normal(size=(2, 8, 16, 3)).astype(np.float32)
    inputs = (xyz_raw, xyz, feat)
    jm = JaxProjectPointNet(**level)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * np.arange(a.size, dtype=np.float32).reshape(a.shape) / a.size,
        dict(jm.init(jax.random.key(0), *inputs, center_mode=True)))
    monkeypatch.setenv("I2PNET_PROJ_DENSE_EVAL", value)
    ref = jm.apply(v, *inputs, center_mode=True)
    calls = _count(monkeypatch, proj_backbone, "dense_pointnet_eval")
    mod = port(ProjectPointNet(in_channels=10, **level), v)
    with torch.no_grad():
        got = mod(*map(t, inputs), center_mode=True)
    assert len(calls) == (0 if value == "0" else 1)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(n(g), n(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bn_stats", [True, False])
def test_pw_bn_f32_switch(monkeypatch, bn_stats):
    x = np.random.default_rng(2).normal(size=(2, 16, 12)).astype(np.float32)
    jm = JaxPointwiseMLP((16, 8), bn_stats=bn_stats, dtype=jnp.bfloat16)
    v = randomize_stats(jm.init(jax.random.key(0), x), np.random.default_rng(3), 0.3)
    mod = port(PointwiseMLP(12, (16, 8), dtype=torch.bfloat16, bn_stats=bn_stats), v)
    outs = {}
    for value in ("0", "1"):
        monkeypatch.setenv("I2PNET_PW_BN_F32", value)
        ref = jm.apply(v, x)
        with torch.no_grad():
            got = mod(t(x))
        # "1": the normalisation's result in f32, as in JAX
        assert str(got.dtype).split(".")[-1] == str(ref.dtype)
        assert got.dtype == (torch.float32 if value == "1" else torch.bfloat16)
        np.testing.assert_allclose(n(got), n(ref), rtol=2e-2, atol=2e-2)
        outs[value] = n(got)
    assert not np.array_equal(outs["0"], outs["1"])


@pytest.mark.parametrize("name", ["I2PNET_FUSED_EVAL", "I2PNET_FUSED_CV", "I2PNET_PROJ_DENSE_EVAL"])
def test_eval_switch_refuses_unknown_values(monkeypatch, name):
    for value in ("auto", "1", "interpret"):
        monkeypatch.setenv(name, value)
        assert layers.eval_route(name)
    monkeypatch.setenv(name, "0")
    assert not layers.eval_route(name)
    monkeypatch.delenv(name)
    assert layers.eval_route(name)
    monkeypatch.setenv(name, "on")
    with pytest.raises(ValueError, match=name):
        layers.eval_route(name)
    assert costvolume.eval_route is layers.eval_route is proj_backbone.eval_route
