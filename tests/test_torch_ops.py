"""Ops of the PyTorch port against the JAX package, f32 on the CPU.

Quaternions and point ops within 1e-5 (f32 rounding of differently ordered
sums); KNN on tie-free inputs (torch.topk and lax.top_k may order equal
distances differently); FPS with exact index equality, against both the
JAX loop and the Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.ops import pointops as JP
from i2pnet_tpu.ops import quaternion as JQ
from i2pnet_tpu.ops.fps_pallas import fps_pallas
from i2pnet_tpu_torch.ops import fps_cuda
from i2pnet_tpu_torch.ops import pointops as P
from i2pnet_tpu_torch.ops import quaternion as Q
from _torch_util import n, t

TOL = 1e-5


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(n(got), n(ref), rtol=tol, atol=tol)


def _poses(rng, B):
    q = rng.normal(size=(B, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q, rng.normal(size=(B, 3)).astype(np.float32)


def test_quaternion_functions_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 5, 4)).astype(np.float32)
    b = rng.normal(size=(3, 5, 4)).astype(np.float32)
    v = rng.normal(size=(3, 5, 3)).astype(np.float32)
    _close(Q.qmul(t(a), t(b)), JQ.qmul(a, b))
    _close(Q.qinv(t(a)), JQ.qinv(a))
    _close(Q.qrotate(t(a), t(v)), JQ.qrotate(a, v))

    q, tr = _poses(rng, 3)
    xyz = rng.normal(size=(3, 7, 3)).astype(np.float32)
    xyz[..., 2] += 10.0
    _close(Q.warp_points(t(xyz), t(q), t(tr)), JQ.warp_points(xyz, q, tr))
    for got, ref in zip(Q.warp_to_normalized_plane(t(xyz), t(q), t(tr)),
                        JQ.warp_to_normalized_plane(xyz, q, tr)):
        _close(got, ref)
    for got, ref in zip(Q.project_to_normalized_plane(t(xyz)), JQ.project_to_normalized_plane(xyz)):
        _close(got, ref)
    q2, t2 = _poses(rng, 3)
    for got, ref in zip(Q.compose_pose(t(q), t(tr), t(q2), t(t2)), JQ.compose_pose(q, tr, q2, t2)):
        _close(got, ref)


def test_square_distance_and_knn_match_jax():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(2, 40, 3)).astype(np.float32)
    dst = rng.normal(size=(2, 64, 3)).astype(np.float32)
    _close(P.square_distance(t(src), t(dst)), JP.square_distance(src, dst))
    # continuous random points: no equal distances among the 8 nearest
    got = P.knn_point(8, t(dst), t(src))
    ref = JP.knn_point(8, jnp.asarray(dst), jnp.asarray(src), exact=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    z = np.zeros((1, 2, 3), np.float32)
    assert float(P.safe_norm(t(z)).max()) == 0.0
    _close(P.safe_norm(t(src), keepdim=True), JP.safe_norm(src, keepdims=True))


@pytest.mark.parametrize("case", ["quantised", "zero_padded", "pixel_grid"])
def test_knn_orders_ties_as_jax(case):
    """Equal distances straddling the k-th place: the port takes the
    lowest indices first, as ``lax.top_k`` does, index for index. Quarter-
    quantised clouds; a cloud half zero padding queried by itself (the
    large-range loader's tail); queries at the principal point of a
    symmetric pixel grid (a zero point projected, the proj cost volume's
    image side); and distances below zero from the expansion's
    cancellation, which the key must keep in order."""
    rng = np.random.default_rng(4)
    if case == "quantised":
        dst = (np.round(rng.normal(size=(2, 96, 3)) * 2) / 4).astype(np.float32)
        src = (np.round(rng.normal(size=(2, 40, 3)) * 2) / 4).astype(np.float32)
    elif case == "zero_padded":
        dst = (rng.normal(size=(2, 64, 3)) * 20).astype(np.float32)
        dst[:, 24:] = 0.0
        src = dst
    else:
        u, v = np.meshgrid(np.arange(16) - 7.5, np.arange(5) - 2.0)
        grid = np.stack([u / 8, v / 8, np.ones_like(u)], -1).reshape(1, -1, 3)
        dst = np.repeat(grid, 2, 0).astype(np.float32)
        src = np.concatenate([np.zeros((2, 6, 3)), (rng.normal(size=(2, 10, 3)) * 0.5)], 1)
        src = src.astype(np.float32)
    d = np.asarray(JP.square_distance(src, dst))
    for k in (1, 8, 17):
        got = P.knn_point(k, t(dst), t(src)).numpy()
        ref = np.asarray(JP.knn_point(k, jnp.asarray(dst), jnp.asarray(src), exact=True))
        np.testing.assert_array_equal(got, ref)
    # each case holds ties across one of the k-th places (else it would
    # test nothing); the padded cloud's self-distances go below zero
    srt = np.sort(d, -1)
    assert any((srt[..., k - 1] == srt[..., k]).any() for k in (1, 8, 17))
    if case == "zero_padded":
        assert (d < 0).any()


def test_index_points_and_grouping_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(2, 30, 5)).astype(np.float32)
    idx2 = rng.integers(0, 30, size=(2, 7)).astype(np.int32)
    idx3 = rng.integers(0, 30, size=(2, 7, 4)).astype(np.int32)
    _close(P.index_points(t(pts), t(idx2).long()), JP.index_points(pts, idx2))
    _close(P.index_points(t(pts), t(idx3).long()), JP.index_points(pts, idx3))

    feat = rng.normal(size=(2, 50, 6)).astype(np.float32)
    src = rng.normal(size=(2, 50, 3)).astype(np.float32)
    q = rng.normal(size=(2, 9, 3)).astype(np.float32)
    raw_src = rng.normal(size=(2, 50, 3)).astype(np.float32)
    raw_q = rng.normal(size=(2, 9, 3)).astype(np.float32)
    for raw in (False, True):
        kw = dict(raw_src_xyz=raw_src, raw_q_xyz=raw_q) if raw else {}
        got = P.grouping(t(feat), 5, t(src), t(q), **{k: t(v) for k, v in kw.items()})
        ref = JP.grouping(feat, 5, src, q, **kw)
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if g is not None:
                _close(g, r)


@pytest.mark.parametrize("feat_mode,with_raw", [("dim10feat", True), (None, False), (None, True)])
def test_sample_and_group_matches_jax(feat_mode, with_raw):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(2, 128, 3)).astype(np.float32)
    points = rng.normal(size=(2, 128, 4)).astype(np.float32)
    raw = (xyz + 0.1 * rng.normal(size=xyz.shape)).astype(np.float32) if with_raw else None
    got = P.sample_and_group(32, 8, t(xyz), t(points), raw_xyz=None if raw is None else t(raw),
                             feat_mode=feat_mode)
    ref = JP.sample_and_group(32, 8, jnp.asarray(xyz), jnp.asarray(points), raw_xyz=raw,
                              feat_mode=feat_mode)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))  # fps indices
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            _close(g, r)


@pytest.mark.parametrize("B,N,npoint,seed", [(2, 64, 16, 11), (2, 512, 256, 0), (3, 300, 300, 5)])
def test_fps_plain_is_bit_identical_to_jax(B, N, npoint, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    xyz[:, N // 3] = xyz[:, 1]  # a duplicate: ties go to the lowest index
    before = fps_cuda.launches
    got = P.farthest_point_sample(t(xyz), npoint).numpy()
    assert fps_cuda.launches == before  # a CPU tensor takes the plain loop
    ref_loop = np.asarray(JP.farthest_point_sample(jnp.asarray(xyz), npoint, use_pallas=False))
    ref_pallas = np.asarray(fps_pallas(jnp.asarray(xyz), npoint, interpret=True))
    np.testing.assert_array_equal(got, ref_loop)
    np.testing.assert_array_equal(got, ref_pallas)


def test_fps_kernel_wrapper_refuses_cpu_tensors():
    # the kernel wrapper never falls back: a CPU tensor is an error there
    with pytest.raises(ValueError):
        fps_cuda.fps_cuda(torch.zeros(1, 8, 3), 4)
