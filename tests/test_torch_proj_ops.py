"""The projection family's ops in the PyTorch port against the JAX package,
on the CPU: the spherical projection, the windowed grid selects and
feature gathers (exact), the selection-multiplicity kernel's plain version
against JAX's Pallas kernel in interpret mode (exact), and the dense
PointNet level (1e-5 in f32, 2e-2 in bf16: the bars of
tests/test_dense_window.py). Inputs are quantised to quarters where ties
between distances must be broken the same way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.nn.proj_backbone import ProjectPointNet as JaxProjectPointNet
from i2pnet_tpu.ops import dense_window as jdw
from i2pnet_tpu.ops import projection as jproj
from i2pnet_tpu.ops.select_pallas import selection_multiplicity_pallas
from i2pnet_tpu_torch.ops import dense_window, projection, select_cuda
from _torch_util import n, t


def _grid(seed, B=2, H=8, W=16, holes=0.3, quantise=True):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    xyz[rng.random((B, H, W)) < holes] = 0.0
    return np.round(xyz * 4) / 4 if quantise else xyz


def _cloud(seed, B=2, N=512):
    rng = np.random.default_rng(seed)
    raw = (rng.normal(size=(B, N, 3)) * 10).astype(np.float32)
    raw[:, N // 2:] = 0.0  # the zero-padded tail the large-range loader emits
    raw[1, N // 4: N // 2] = raw[1, : N // 4]  # duplicates: equal ranges in a cell
    feat = rng.normal(size=(B, N, 3)).astype(np.float32)
    return raw, feat


@pytest.mark.parametrize("use_rank", [False, True])
@pytest.mark.parametrize("quirk", [False, True])
def test_spherical_project_exact(use_rank, quirk):
    raw, feat = _cloud(0)
    kw = dict(H=16, W=64, fup=2.0, fdown=-24.8, use_rank=use_rank, ref_pad_quirk=quirk)
    ref_xyz, (ref_feat,) = jproj.spherical_project(jnp.asarray(raw), [jnp.asarray(feat)], **kw)
    got_xyz, (got_feat,) = projection.spherical_project(t(raw), [t(feat)], **kw)
    np.testing.assert_array_equal(n(got_xyz), n(ref_xyz))
    np.testing.assert_array_equal(n(got_feat), n(ref_feat))
    assert (n(got_xyz) != 0).any(axis=-1).sum() > 100  # many cells won


def test_grid_helpers():
    xyz = _grid(1)
    np.testing.assert_array_equal(n(projection.check_valid(t(xyz))), n(jproj.check_valid(xyz)))
    np.testing.assert_array_equal(projection.grid_indices(2, 4, 5).numpy(),
                                  np.asarray(jproj.grid_indices(2, 4, 5)))
    np.testing.assert_array_equal(n(projection.strided_downsample(t(xyz), 4, 6, 2, 3)),
                                  n(jproj.strided_downsample(xyz, 4, 6, 2, 3)))


@pytest.mark.parametrize("qstride,stride,kernel,shift", [
    ((2, 2), (1, 1), (3, 5), True),
    ((1, 1), (2, 2), (3, 3), True),
    ((1, 1), (1, 1), (5, 3), False),
])
def test_window_candidates_exact(qstride, stride, kernel, shift):
    src = _grid(2)
    out_h, out_w = 8 // qstride[0], 16 // qstride[1]
    if stride != (1, 1):
        src = src[:, ::stride[0], ::stride[1]].copy()
    args = (out_h, out_w, qstride, stride, kernel, shift)
    ref_cand, ref_ok = jproj.window_candidates(jnp.asarray(src), *args)
    got_cand, got_ok = projection.window_candidates(t(src), *args)
    np.testing.assert_array_equal(n(got_cand), n(ref_cand))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))


# (out_hw, qstride, stride, kernel, K, distance, copy), the second grid
# subsampled by `stride`
SELECTS = [
    ((4, 8), (2, 2), (1, 1), (3, 5), 4, 1.5, True),
    ((4, 8), (2, 2), (1, 1), (3, 5), 4, 1.5, False),
    ((8, 16), (1, 1), (1, 1), (3, 3), 4, 1.0, False),
    ((4, 8), (2, 2), (1, 1), (3, 3), 16, 1.5, True),   # K > khw
    ((4, 8), (2, 2), (1, 1), (3, 3), 16, 1.5, False),  # K > khw
    ((8, 16), (1, 1), (2, 2), (3, 5), 6, 2.0, True),   # coarse second grid
]


@pytest.mark.parametrize("out_hw,qstride,stride,kernel,K,distance,copy", SELECTS)
def test_window_neighbor_select_grid_exact(out_hw, qstride, stride, kernel, K, distance, copy):
    xyz1 = _grid(3)
    xyz2 = xyz1[:, ::stride[0], ::stride[1]].copy() if stride != (1, 1) else xyz1
    kw = dict(stride=stride, distance=distance, shift=True, copy=copy)
    ref_args, ref_mask = jproj.window_neighbor_select_grid(
        jnp.asarray(xyz1), jnp.asarray(xyz2), *out_hw, qstride, kernel, K, **kw)
    got_args, got_mask = projection.window_neighbor_select_grid(
        t(xyz1), t(xyz2), *out_hw, qstride, kernel, K, **kw)
    np.testing.assert_array_equal(got_args.numpy(), np.asarray(ref_args))
    np.testing.assert_array_equal(n(got_mask), n(ref_mask))
    # the features of those selections, on two grids at once
    feat = np.random.default_rng(4).normal(size=xyz2.shape[:3] + (5,)).astype(np.float32)
    wargs = dict(out_h=out_hw[0], out_w=out_hw[1], qstride=qstride, stride=stride,
                 kernel_size=kernel, shift=True)
    ref = jproj.select_window_features_multi([jnp.asarray(xyz2), jnp.asarray(feat)], ref_args,
                                             **wargs)
    got = projection.select_window_features_multi([t(xyz2), t(feat)], got_args, **wargs)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(n(g), n(r))


# the four parametrisations of tests/test_dense_window.py's Pallas test
MULTIPLICITY_CASES = [
    ((4, 8), (2, 2), (3, 5), 4, 1.5),
    ((8, 16), (1, 1), (3, 3), 4, 1.0),
    ((2, 4), (4, 4), (5, 5), 8, 2.0),
    ((4, 8), (2, 2), (3, 3), 16, 1.5),  # K > khw: sentinel / copy fill
]


@pytest.mark.parametrize("out_hw,qstride,kernel,K,distance", MULTIPLICITY_CASES)
def test_selection_multiplicity_plain_matches_pallas(out_hw, qstride, kernel, K, distance):
    """The kernel's plain version reproduces JAX's Pallas kernel (interpret
    mode) exactly on tie-forcing inputs, and its raw layout is the same
    values permuted; on the CPU no kernel launches."""
    rng = np.random.default_rng(11)
    xyz = rng.normal(size=(2, 8, 16, 3)).astype(np.float32)
    xyz[rng.random((2, 8, 16)) < 0.3] = 0.0
    xyz = np.round(xyz * 4) / 4
    kw = dict(out_h=out_hw[0], out_w=out_hw[1], qstride=qstride, kernel_size=kernel, K=K,
              distance=distance)
    ref = selection_multiplicity_pallas(jnp.asarray(xyz), interpret=True, **kw)
    before = select_cuda.launches
    got = select_cuda.selection_multiplicity_plain(t(xyz), *out_hw, qstride, kernel, K, distance)
    np.testing.assert_array_equal(n(got), n(ref))
    np.testing.assert_array_equal(n(got).sum(-1), K)
    raw = select_cuda.window_multiplicity(t(xyz), raw_layout=True, **kw)
    assert raw.shape == (2, out_hw[0], kernel[0] * kernel[1] + 1, out_hw[1])
    np.testing.assert_array_equal(n(raw.permute(0, 1, 3, 2)).reshape(n(got).shape), n(got))
    assert select_cuda.launches == before
    # the slot histogram of the selected indices, as JAX's
    args, _ = jproj.window_neighbor_select_grid(jnp.asarray(xyz), jnp.asarray(xyz), *out_hw,
                                                qstride, kernel, K, distance=distance, copy=True)
    khw = kernel[0] * kernel[1]
    np.testing.assert_array_equal(
        n(dense_window.selection_multiplicity(t(args).long(), khw)),
        n(jdw.selection_multiplicity(args, khw)))


@pytest.mark.parametrize("center_mode,using_intens,dtype", [
    (True, False, None),
    (True, True, "bfloat16"),
    (False, False, None),
])
def test_dense_pointnet_eval(center_mode, using_intens, dtype):
    rng = np.random.default_rng(1)
    B, H, W = 2, 8, 16
    xyz_raw = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    holes = rng.random((B, H, W)) < 0.3
    xyz_raw[holes] = 0.0
    xyz = xyz_raw + rng.normal(size=(B, H, W, 3)).astype(np.float32) * 0.05
    xyz[holes] = 0.0
    feat = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    kw = dict(out_h=4, out_w=8, stride_h=2, stride_w=2, kernel_size=(3, 5), nsample=4,
              distance=1.5, mlp=(8, 16))
    jdt = jnp.bfloat16 if dtype else None
    mod = JaxProjectPointNet(use_trans=True, use_bn=True, dtype=jdt, **kw)
    modes = dict(center_mode=center_mode, using_intens=using_intens)
    v = mod.init(jax.random.PRNGKey(0), xyz_raw, xyz, feat, **modes)
    # a non-trivial normalisation affine, so a statistics mismatch shows
    v = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape) / a.size, v)
    ref = jdw.dense_pointnet_eval(xyz_raw, xyz, feat, v["params"], use_trans=True, dtype=jdt,
                                  **modes, **kw)
    p = v["params"]["mlp_convs"]
    layers = [tuple(t(a) for a in (p[f"PointwiseConv_{i}"]["Dense_0"]["kernel"].T,
                                   p[f"PointwiseConv_{i}"]["Dense_0"]["bias"],
                                   p[f"PointwiseConv_{i}"]["BatchStatsNorm_0"]["scale"],
                                   p[f"PointwiseConv_{i}"]["BatchStatsNorm_0"]["bias"]))
              for i in range(2)]
    kw.pop("mlp")
    got = dense_window.dense_pointnet_eval(
        t(xyz_raw), t(xyz), t(feat), layers, use_trans=True,
        dtype=torch.bfloat16 if dtype else None, **modes, **kw)
    np.testing.assert_array_equal(n(got[0]), n(ref[0]))
    np.testing.assert_array_equal(n(got[1]), n(ref[1]))
    tol = 2e-2 if dtype else 1e-5
    np.testing.assert_allclose(n(got[2]), n(ref[2]), rtol=tol, atol=tol)
