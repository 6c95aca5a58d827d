"""The projection family's modules in the PyTorch port against the JAX
package, on the CPU, with the JAX module's weights (the normalisation
affines moved off their neutral init, so a statistics mismatch shows).

f32 within 1e-5 (sums in another order through a few Dense layers,
batch-statistics normalisations and softmaxes); bf16 within 2e-2, the bar
of tests/test_dense_window.py. ``ProjectPointNet`` is held on both routes:
at eval the port takes the dense route, against JAX's dense route (its
selection kernel in interpret mode); in training the gathered one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.nn.layers import BatchStatsNorm as JaxBatchStatsNorm
from i2pnet_tpu.nn.proj_backbone import ProjCostVolume as JaxProjCostVolume
from i2pnet_tpu.nn.proj_backbone import ProjectPointNet as JaxProjectPointNet
from i2pnet_tpu.nn.proj_backbone import ProjFlowPredictor as JaxProjFlowPredictor
from i2pnet_tpu.nn.proj_backbone import ProjSetUpconv as JaxProjSetUpconv
from i2pnet_tpu_torch.nn.layers import BatchStatsNorm
from i2pnet_tpu_torch.nn.proj_backbone import (
    ProjCostVolume,
    ProjectPointNet,
    ProjFlowPredictor,
    ProjSetUpconv,
)
from i2pnet_tpu_torch.ops import select_cuda
from _torch_util import n, port, t

TOL = 1e-5


def _perturb(variables):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.1 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape)
                             / a.size), dict(variables))


def _check(jax_module, torch_module, inputs, call_kw=None, train=False, env=None, tol=TOL):
    """init the JAX module, load its (perturbed) weights into the port, run
    both on the same inputs; ``train`` puts both in training mode, ``env``
    sets the JAX package's route switches for its run."""
    call_kw = call_kw or {}
    v = _perturb(jax_module.init(jax.random.key(0), *inputs, **call_kw))
    with pytest.MonkeyPatch.context() as mp:
        for k, val in (env or {}).items():
            mp.setenv(k, val)
        ref = jax_module.apply(v, *inputs, **call_kw, **({"train": True} if train else {}))
    mod = port(torch_module, v).train(train)
    with torch.no_grad():
        got = mod(*[None if a is None else t(a) for a in inputs], **call_kw)
    for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        assert g.shape == r.shape
        np.testing.assert_allclose(n(g), n(r), rtol=tol, atol=tol)


def _grids(seed, B=2, H=8, W=16, C=3):
    rng = np.random.default_rng(seed)
    xyz_raw = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    holes = rng.random((B, H, W)) < 0.3
    xyz_raw[holes] = 0.0
    xyz = xyz_raw + rng.normal(size=(B, H, W, 3)).astype(np.float32) * 0.05
    xyz[holes] = 0.0
    return xyz_raw, xyz, rng.normal(size=(B, H, W, C)).astype(np.float32)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_batch_stats_norm(dtype):
    x = np.random.default_rng(0).normal(loc=0.5, size=(2, 5, 3, 6)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype else (None, None)
    if dtype:  # values a bf16 Dense could give
        x = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
    _check(JaxBatchStatsNorm(dtype=jdt), BatchStatsNorm(6, tdt), (x,), tol=2e-2 if dtype else TOL)


LEVEL = dict(out_h=4, out_w=8, stride_h=2, stride_w=2, kernel_size=(3, 5), nsample=4,
             distance=1.5, mlp=(8, 16))


@pytest.mark.parametrize("route", ["dense", "gathered"])
@pytest.mark.parametrize("center_mode,using_intens", [(True, False), (True, True), (False, False)])
def test_project_pointnet(route, center_mode, using_intens):
    xyz_raw, xyz, feat = _grids(1)
    width = (10 + 3 * using_intens) if center_mode else 6
    kw = dict(center_mode=center_mode, using_intens=using_intens)
    before = select_cuda.launches
    _check(JaxProjectPointNet(**LEVEL), ProjectPointNet(in_channels=width, **LEVEL),
           (xyz_raw, xyz, feat), kw, train=route == "gathered",
           env={"I2PNET_PROJ_DENSE_EVAL": "interpret"})
    assert select_cuda.launches == before  # CPU: the plain version


@pytest.mark.parametrize("with_feat1", [True, False])
def test_proj_set_upconv(with_feat1):
    rng = np.random.default_rng(2)
    xyz1_raw, xyz1, f1 = _grids(2, C=6)
    xyz2_raw = xyz1_raw[:, ::1, ::2].copy()
    xyz2 = xyz1[:, ::1, ::2].copy()
    f2 = rng.normal(size=xyz2.shape[:3] + (5,)).astype(np.float32)
    kw = dict(out_h=8, out_w=16, stride_h=1, stride_w=2, kernel_size=(3, 3), nsample=4,
              distance=2.0, mlp=(8,), mlp2=(8,))
    _check(JaxProjSetUpconv(**kw),
           ProjSetUpconv(feat2_channels=5, feat1_channels=6 if with_feat1 else 0, **kw),
           (xyz1_raw, xyz2_raw, xyz1, xyz2, f1 if with_feat1 else None, f2))


@pytest.mark.parametrize("nsample_q,bval", [(-1, True), (-1, False), (6, False), (6, True)])
def test_proj_cost_volume(nsample_q, bval):
    rng = np.random.default_rng(3)
    B, H, W, M, C = 2, 4, 8, 24, 8
    N = H * W
    xyz_raw = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    lidar_z = rng.uniform(1, 5, size=(B, N, 1)).astype(np.float32)
    lidar_z[:, ::5] = 0.0  # empty cells: masked out of both softmaxes
    uv = rng.normal(size=(B, N, 3)).astype(np.float32)
    uv[..., 2] = 1.0
    inputs = (
        xyz_raw, uv, rng.normal(size=(B, N, C)).astype(np.float32),
        np.broadcast_to(np.stack(np.meshgrid(np.arange(H), np.arange(W), indexing="ij"), -1)
                        .reshape(1, N, 2), (B, N, 2)).astype(np.int32),
        rng.normal(size=(B, M, 3)).astype(np.float32),
        rng.normal(size=(B, M, C)).astype(np.float32), lidar_z,
    )
    kw = dict(H=H, W=W, kernel_size=(3, 3), distance=4.5, nsample=4, nsample_q=nsample_q,
              mlp1=(8, 8), mlp2=(8, 8), backward_validation=bval)
    _check(JaxProjCostVolume(**kw), ProjCostVolume(in_channels=C, **kw), inputs)


def test_proj_flow_predictor():
    rng = np.random.default_rng(5)
    a, b, c = (rng.normal(size=(2, 10, w)).astype(np.float32) for w in (4, 5, 6))
    _check(JaxProjFlowPredictor((8, 8)), ProjFlowPredictor(15, (8, 8)), (a, b, c))
    _check(JaxProjFlowPredictor((8,)), ProjFlowPredictor(9, (8,)), (a, None, b))
