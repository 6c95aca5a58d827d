"""Modules of the PyTorch port against the JAX package, f32 native paths,
on the CPU, within 1e-4 (f32 sums in another order through a few Dense
layers, BatchNorms and softmaxes)."""

import jax
import numpy as np
import pytest
import torch

from i2pnet_tpu.nn.costvolume import CostVolume as JaxCostVolume
from i2pnet_tpu.nn.heads import FlowPredictor as JaxFlowPredictor
from i2pnet_tpu.nn.heads import PoseHead as JaxPoseHead
from i2pnet_tpu.nn.layers import PointwiseMLP as JaxPointwiseMLP
from i2pnet_tpu.nn.layers import RGBEncoder as JaxRGBEncoder
from i2pnet_tpu.nn.pointnet import PointNetSetAbstraction as JaxSA
from i2pnet_tpu.nn.upconv import SetUpconv as JaxSetUpconv
from i2pnet_tpu_torch.nn.costvolume import CostVolume
from i2pnet_tpu_torch.nn.heads import FlowPredictor, PoseHead
from i2pnet_tpu_torch.nn.layers import PointwiseMLP, RGBEncoder
from i2pnet_tpu_torch.nn.pointnet import PointNetSetAbstraction
from i2pnet_tpu_torch.nn.upconv import SetUpconv
from _torch_util import n, port, randomize_stats, t

TOL = 1e-4


def _check(jax_module, torch_module, inputs, call_kw=None, torch_kw=None, seed=0):
    """init the JAX module, randomise its running stats, load the same
    variables into the port, run both on the same inputs."""
    rng = np.random.default_rng(seed)
    call_kw = call_kw or {}
    v = randomize_stats(jax_module.init(jax.random.key(0), *inputs, **call_kw), rng)
    ref = jax_module.apply(v, *inputs, **call_kw)
    mod = port(torch_module, v)
    torch_kw = call_kw if torch_kw is None else torch_kw
    tkw = {k: (t(a) if isinstance(a, np.ndarray) else a) for k, a in torch_kw.items()}
    with torch.no_grad():
        got = mod(*[None if a is None else t(a) for a in inputs], **tkw)
    for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(n(g), n(r), rtol=TOL, atol=TOL)


def test_pointwise_mlp():
    x = np.random.default_rng(0).normal(size=(2, 5, 3, 6)).astype(np.float32)
    _check(JaxPointwiseMLP((8, 4)), PointwiseMLP(6, (8, 4)), (x,))


def test_rgb_encoder_f32():
    x = np.random.default_rng(1).normal(size=(2, 16, 32, 3)).astype(np.float32)
    stages = ((3, (8, 8), (2, 1)), (8, (16,), (2,)))
    _check(JaxRGBEncoder(stages), RGBEncoder(stages), (x,))


@pytest.mark.parametrize("feat_mode", ["dim10feat", None])
def test_pointnet_set_abstraction(feat_mode):
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(2, 64, 3)).astype(np.float32)
    pts = rng.normal(size=(2, 64, 5)).astype(np.float32)
    raw = (xyz + 0.1 * rng.normal(size=xyz.shape)).astype(np.float32)
    kw = dict(feat_mode=feat_mode, raw_xyz=raw)
    width = 10 if feat_mode else 8
    _check(JaxSA(16, 8, (8, 16)), PointNetSetAbstraction(16, 8, (8, 16), width), (xyz, pts), kw)


@pytest.mark.parametrize("nsample_q,bval", [(-1, True), (-1, False), (6, False), (6, True)])
def test_cost_volume_f32(nsample_q, bval):
    rng = np.random.default_rng(3)
    B, N, K, C = 2, 12, 24, 8
    inputs = (
        rng.normal(size=(B, N, 3)).astype(np.float32),
        rng.normal(size=(B, N, C)).astype(np.float32),
        rng.normal(size=(B, K, 3)).astype(np.float32),
        rng.normal(size=(B, K, C)).astype(np.float32),
        rng.uniform(1, 5, size=(B, N, 1)).astype(np.float32),
    )
    kw = dict(nsample=4, nsample_q=nsample_q, mlp1=(8, 8), mlp2=(8, 8), backward_validation=bval)
    _check(JaxCostVolume(**kw), CostVolume(in_channels=C, **kw), inputs)


@pytest.mark.parametrize("with_raw", [True, False])
def test_set_upconv(with_raw):
    rng = np.random.default_rng(4)
    xyz1 = rng.normal(size=(2, 32, 3)).astype(np.float32)
    xyz2 = rng.normal(size=(2, 8, 3)).astype(np.float32)
    f1 = rng.normal(size=(2, 32, 6)).astype(np.float32)
    f2 = rng.normal(size=(2, 8, 5)).astype(np.float32)
    kw = {}
    if with_raw:
        kw = dict(raw_xyz1=(xyz1 + 0.1).astype(np.float32), raw_xyz2=(xyz2 - 0.1).astype(np.float32))
    _check(JaxSetUpconv(4, (8,), (8,)), SetUpconv(4, (8,), (8,), 5, 6), (xyz1, xyz2, f1, f2), kw)


def test_flow_predictor():
    rng = np.random.default_rng(5)
    a, b, c = (rng.normal(size=(2, 10, w)).astype(np.float32) for w in (4, 5, 6))
    _check(JaxFlowPredictor((8, 8)), FlowPredictor(15, (8, 8)), (a, b, c))
    _check(JaxFlowPredictor((8,)), FlowPredictor(9, (8,)), (a, None, b))


def test_pose_head_eval():
    rng = np.random.default_rng(6)
    pred = rng.normal(size=(2, 20, 8)).astype(np.float32)
    mask = rng.normal(size=(2, 20, 8)).astype(np.float32)
    xyz = rng.normal(size=(2, 20, 3)).astype(np.float32)
    feat = rng.normal(size=(2, 20, 5)).astype(np.float32)
    jhead = JaxPoseHead(mlp1=(), mlp2=(), hidden=16)
    _check(jhead, PoseHead(8, 16), (pred, mask, xyz, feat), {"train": False}, {})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaky_relu_matches_flax_exactly(dtype):
    """In bf16 JAX multiplies by the slope rounded to bf16 (0.10009765625);
    a product by 0.1 rounds some negative values differently."""
    import jax.numpy as jnp

    from i2pnet_tpu_torch.nn.layers import leaky_relu

    x = np.random.default_rng(7).normal(size=4096).astype(np.float32)
    ref = jax.nn.leaky_relu(jnp.asarray(x, dtype), 0.1)
    got = leaky_relu(t(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(n(got), n(ref))
