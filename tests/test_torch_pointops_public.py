"""The port's public point ops that no model path runs, against the JAX
package on the same seeded numpy inputs, f32 on the CPU.

Inputs are quantised to quarters, so that equal distances occur: the
indices must then follow ``lax.top_k``'s order (lowest index first), and
``ball_query``'s hits stay in index order. Indices exactly; distances,
features and weights within 1e-5 (sums in another order); quaternions
within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from i2pnet_tpu.ops import pointops as JP
from i2pnet_tpu.ops import quaternion as JQ
from i2pnet_tpu_torch.ops import pointops as P
from i2pnet_tpu_torch.ops import quaternion as Q
from _torch_util import n, t

TOL = 1e-5


def _quarters(rng, shape, scale=2.0):
    """Points on a grid of quarters: many equal distances."""
    return (np.round(rng.uniform(-scale, scale, size=shape) * 4) / 4).astype(np.float32)


def _has_ties(sqr, k):
    """Some query's k-th and (k+1)-th smallest distances are equal."""
    srt = np.sort(sqr, axis=-1)
    return bool(np.any(srt[..., k - 1] == srt[..., k]))


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_knn_point_orders_ties_as_jax(seed):
    rng = np.random.default_rng(seed)
    xyz, q = _quarters(rng, (2, 64, 3)), _quarters(rng, (2, 16, 3))
    mask = (rng.uniform(size=(2, 64)) > 0.3).astype(np.float32)
    mask[0, :48] = 0.0  # fewer valid points than neighbours in one row
    K = 20
    sqr = np.asarray(JP.square_distance(jnp.asarray(q), jnp.asarray(xyz)))
    assert _has_ties(sqr, K)
    ref = JP.masked_knn_point(K, jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(mask))
    got = P.masked_knn_point(K, t(xyz), t(q), t(mask))
    np.testing.assert_array_equal(n(got), np.asarray(ref))


@pytest.mark.parametrize("radius", [0.5, 1.25])
def test_ball_query_matches_jax(radius):
    rng = np.random.default_rng(2)
    xyz, q = _quarters(rng, (2, 80, 3)), _quarters(rng, (2, 12, 3))
    q[1, 0] = 50.0  # a query with no hit: index 0 throughout
    ref = np.asarray(JP.ball_query(radius, 8, jnp.asarray(xyz), jnp.asarray(q)))
    got = n(P.ball_query(radius, 8, t(xyz), t(q)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[1, 0], 0)
    # padding with the first hit: some query has fewer hits than slots
    assert np.any(got[..., -1] == got[..., 0])


def test_three_nn_and_interpolate_match_jax():
    rng = np.random.default_rng(3)
    unknown, known = _quarters(rng, (2, 40, 3)), _quarters(rng, (2, 24, 3))
    known[0, 5] = known[0, 2]  # duplicated points: equal distances everywhere
    sqr = np.asarray(JP.square_distance(jnp.asarray(unknown), jnp.asarray(known)))
    assert _has_ties(sqr, 3)
    d_ref, i_ref = JP.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    d_got, i_got = P.three_nn(t(unknown), t(known))
    np.testing.assert_array_equal(n(i_got), np.asarray(i_ref))
    np.testing.assert_allclose(n(d_got), np.asarray(d_ref), rtol=TOL, atol=TOL)

    w_ref = JP.interpolation_weights(d_ref)
    w_got = P.interpolation_weights(d_got)
    np.testing.assert_allclose(n(w_got), np.asarray(w_ref), rtol=TOL, atol=TOL)
    feats = rng.normal(size=(2, 24, 6)).astype(np.float32)
    ref = JP.three_interpolate(jnp.asarray(feats), i_ref, w_ref)
    got = P.three_interpolate(t(feats), i_got, w_got)
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_xyz", [False, True])
def test_mask_grouping_matches_jax(use_xyz):
    rng = np.random.default_rng(4)
    xyz, q = _quarters(rng, (2, 48, 3)), _quarters(rng, (2, 10, 3))
    feats = rng.normal(size=(2, 48, 5)).astype(np.float32)
    mask = (rng.uniform(size=(2, 48)) > 0.4).astype(np.float32)
    ref = JP.mask_grouping(jnp.asarray(feats), 6, jnp.asarray(xyz), jnp.asarray(q),
                           jnp.asarray(mask), use_xyz=use_xyz)
    got = P.mask_grouping(t(feats), 6, t(xyz), t(q), t(mask), use_xyz=use_xyz)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(n(g), np.asarray(r), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(n(got[3]), np.asarray(ref[3]))


def test_rotmat_to_quat_matches_jax():
    """Random rotations, and each of Shepperd's four branches by name: the
    identity (trace), half turns about x, y and z (one diagonal entry
    dominant, w = 0, the sign taken from w == 0)."""
    rng = np.random.default_rng(5)
    mats = Rotation.random(64, random_state=6).as_matrix().astype(np.float32)
    half = [Rotation.from_rotvec(np.pi * np.eye(3)[i]).as_matrix() for i in range(3)]
    near = [Rotation.from_rotvec((np.pi - 1e-3) * a / np.linalg.norm(a)).as_matrix()
            for a in rng.normal(size=(4, 3))]
    mats = np.concatenate([mats, np.stack([np.eye(3)] + half + near).astype(np.float32)])
    ref = np.asarray(JQ.rotmat_to_quat(jnp.asarray(mats)))
    got = n(Q.rotmat_to_quat(t(mats)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert np.all(got[:, 0] >= 0)
    np.testing.assert_allclose(n(Q.quat_to_rotmat(t(got))), mats, atol=1e-5)
