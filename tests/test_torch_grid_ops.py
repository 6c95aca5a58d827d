"""The port's generic window select, grid helpers, im2col candidate builder,
exact k-smallest indices and worker seeds against the JAX package, on the
CPU.

Grids are quarter-quantised with 30% empty pixels, so equal distances and
equal scores are common: every index and mask is held exactly, features
exactly (a gather moves values), ``pixel_posinfo`` within 1e-6. The port
builds its grid candidates by im2col wherever the geometry allows; JAX
does under ``I2PNET_GRID_PATCHES=1`` (read at trace time), set by
``monkeypatch``. The port's default builder is reached by patching
``projection._patches_eligible``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.ops import pointops as jpo
from i2pnet_tpu.ops import projection as jproj
from i2pnet_tpu.utils import seeding as jseeding
from i2pnet_tpu_torch.ops import pointops, projection
from i2pnet_tpu_torch.utils import seeding
from _torch_util import n, t

B, H, W = 2, 8, 16

# (out_h, out_w, qstride, source (h2, w2), stride, kernel, K, copy): a
# downsampling level, the cost volume's 3D side, an upconv (the search grid
# coarser than the queries'), K past the window
CASES = [
    (4, 8, (2, 2), (H, W), (1, 1), (3, 5), 4, True),
    (8, 16, (1, 1), (H, W), (1, 1), (3, 3), 4, False),
    (8, 16, (1, 1), (4, 8), (2, 2), (3, 3), 4, True),
    (4, 8, (2, 2), (H, W), (1, 1), (3, 3), 12, False),
    (4, 8, (2, 2), (H, W), (1, 1), (3, 3), 12, True),
]


def _grids(seed=9, C=5):
    rng = np.random.default_rng(seed)
    xyz = np.round(rng.normal(size=(B, H, W, 3)) * 4) / 4
    xyz[rng.random((B, H, W)) < 0.3] = 0.0
    feat = rng.normal(size=(B, H, W, C))
    return xyz.astype(np.float32), feat.astype(np.float32)


def _source(a, src_hw):
    return a if src_hw == (H, W) else a[:, : src_hw[0] * 2: 2, : src_hw[1] * 2: 2]


def test_strided_grid_indices_and_gather_grid():
    for args in [(B, 2, 2, 2, 3), (B, 4, 8, 2, 2), (1, 3, 5, 1, 1)]:
        np.testing.assert_array_equal(n(projection.strided_grid_indices(*args)),
                                      np.asarray(jproj.strided_grid_indices(*args)))
    _, feat = _grids()
    rng = np.random.default_rng(1)
    h = rng.integers(0, H, size=(B, 6, 7)).astype(np.int32)
    w = rng.integers(0, W, size=(B, 6, 7)).astype(np.int32)
    h[:, :, 3] = h[:, :, 0]  # repeated indices, as copy mode makes
    w[:, :, 3] = w[:, :, 0]
    np.testing.assert_array_equal(n(projection.gather_grid(t(feat), t(h), t(w))),
                                  np.asarray(jproj.gather_grid(jnp.asarray(feat), h, w)))
    # the gradient of a repeated index sums, as the transpose of JAX's gather
    src = t(feat).requires_grad_()
    projection.gather_grid(src, t(h), t(w)).sum().backward()
    want = jax.grad(lambda f: jproj.gather_grid(f, h, w).sum())(jnp.asarray(feat))
    np.testing.assert_array_equal(n(src.grad), np.asarray(want))


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_window_neighbor_select(case, shift):
    out_h, out_w, qstride, src_hw, stride, kernel, K, copy = CASES[case]
    xyz, _ = _grids()
    src = _source(xyz, src_hw)
    idx = np.asarray(jproj.strided_grid_indices(B, out_h, out_w, *qstride))
    idx = np.concatenate([idx, idx[:, ::-3]], axis=1)  # queries in any order, repeated
    args = (kernel, K, stride, 1.5, shift, copy)
    want = jproj.window_neighbor_select(jnp.asarray(xyz), jnp.asarray(src), jnp.asarray(idx),
                                        *args)
    got = projection.window_neighbor_select(t(xyz), t(src), t(idx), *args)
    for g, r in zip(got, want):
        assert g.shape == r.shape
        np.testing.assert_array_equal(n(g), np.asarray(r, np.float32))


@pytest.mark.parametrize("patches", ["0", "1"])
def test_grid_select_matches_generic(patches, monkeypatch):
    """window_neighbor_select_grid + select_window_features against
    window_neighbor_select + gather_grid at strided_grid_indices' queries:
    masks equal, features equal in every slot (the no-hit and
    invalid-centre sentinel's included), in both packages, each against
    the other, with JAX's im2col builder off and on (the port's on wherever
    the geometry allows)."""
    monkeypatch.setenv("I2PNET_GRID_PATCHES", patches)
    xyz, feat = _grids()
    for out_h, out_w, qstride, src_hw, stride, kernel, K, copy in CASES[:3]:
        src, srcf = _source(xyz, src_hw), _source(feat, src_hw)
        idx = projection.strided_grid_indices(B, out_h, out_w, *qstride)
        h_g, w_g, m_g = projection.window_neighbor_select(t(xyz), t(src), idx, kernel, K, stride,
                                                          1.5, True, copy)
        feats_g = projection.gather_grid(t(srcf), h_g, w_g)
        args, m_f = projection.window_neighbor_select_grid(t(xyz), t(src), out_h, out_w, qstride,
                                                           kernel, K, stride, 1.5, True, copy)
        feats_f = projection.select_window_features(t(srcf), args, out_h, out_w, qstride, stride,
                                                    kernel, True)
        assert torch.equal(m_g, m_f)
        assert torch.equal(feats_g, feats_f)
        jargs, jm = jproj.window_neighbor_select_grid(jnp.asarray(xyz), jnp.asarray(src), out_h,
                                                      out_w, qstride, kernel, K, stride, 1.5,
                                                      True, copy)
        jfeats = jproj.select_window_features(jnp.asarray(srcf), jargs, out_h, out_w, qstride,
                                              stride, kernel, True)
        np.testing.assert_array_equal(n(args), np.asarray(jargs, np.float32))
        np.testing.assert_array_equal(n(m_f), np.asarray(jm))
        np.testing.assert_array_equal(n(feats_f), np.asarray(jfeats))


def test_patches_builder_is_bit_identical(monkeypatch):
    """The im2col builder against the default (``window_candidates``) in
    the port: the same args, masks and features bit for bit where im2col
    engages (the stride-1 windows of a downsampling level, of the 3D cost
    volume, at an odd-width kernel's wrap); a feature grid's gradient
    through both within f32 rounding (repeated slots summed in another
    order)."""
    xyz, feat = _grids(seed=3)
    cases = [(4, 8, (2, 2), (3, 5), 4, True), (8, 16, (1, 1), (3, 3), 4, False),
             (4, 6, (2, 3), (5, 9), 8, True)]
    eligible = projection._patches_eligible
    cot = np.random.default_rng(4).normal(size=(B, H * W, 8, 5)).astype(np.float32)
    for out_h, out_w, qstride, kernel, K, copy in cases:
        assert eligible(out_h, out_w, qstride, (1, 1), H, W, True)
        runs = {}
        for builder in ("default", "im2col"):
            monkeypatch.setattr(projection, "_patches_eligible",
                                eligible if builder == "im2col" else lambda *a: False)
            args, mask = projection.window_neighbor_select_grid(
                t(xyz), t(xyz), out_h, out_w, qstride, kernel, K, distance=1.5, copy=copy)
            grid = t(feat).requires_grad_()
            feats = [projection.select_window_features(g, args, out_h, out_w, qstride, (1, 1),
                                                       kernel) for g in (grid, t(xyz))]
            N = out_h * out_w
            (grad,) = torch.autograd.grad((feats[0] * t(cot[:, :N, :K])).sum(), grid)
            runs[builder] = [args, mask] + [f.detach() for f in feats] + [grad]
        for a, b in zip(runs["default"][:-1], runs["im2col"][:-1]):
            assert torch.equal(a, b)
        np.testing.assert_allclose(n(runs["im2col"][-1]), n(runs["default"][-1]), rtol=0,
                                   atol=1e-6 * float(runs["default"][-1].abs().max()))
    monkeypatch.setattr(projection, "_patches_eligible", eligible)
    assert not eligible(4, 8, (2, 2), (1, 2), H, W, True)
    assert not eligible(4, 8, (2, 2), (1, 1), H, W, False)
    # patches are laid out (B, N, C, kh*kw), rows outside the image exact zeros
    cand = projection._patches_candidates(t(feat), 4, 8, (2, 2), (3, 5))
    assert cand.shape == (B, 32, 5, 15)
    ref, in_bounds = projection.window_candidates(t(feat), 4, 8, (2, 2), (1, 1), (3, 5))
    assert torch.equal(cand.transpose(2, 3)[:, in_bounds], ref[:, in_bounds])
    assert not cand.transpose(2, 3)[:, ~in_bounds].any()


def test_pixel_posinfo():
    k = np.array([[[50.0, 0, 8], [0, 50.0, 4], [0, 0, 1]],
                  [[721.5, 0, 609.6], [0, 721.5, 172.9], [0, 0, 1]]], np.float32)
    for shape in [(8, 16), (24, 40)]:
        got = projection.pixel_posinfo(2, *shape, t(k))
        want = np.asarray(jproj.pixel_posinfo(2, *shape, jnp.asarray(k)))
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(n(got), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(got[0, 4, 8]), [0, 0, 1], atol=1e-6)


def _scores(shape, seed):
    rng = np.random.default_rng(seed)
    s = (rng.integers(-6, 7, size=shape) / 4).astype(np.float32)
    s[rng.random(shape) < 0.05] = -0.0  # signed zeros: -0.0 ranks first
    return s


@pytest.mark.parametrize("k", [1, 5, 32, 40])
def test_min_k_indices(k):
    s = _scores((3, 7, 300), k)
    got = pointops.min_k_indices(t(s), k)
    np.testing.assert_array_equal(n(got), np.asarray(jpo.min_k_indices(jnp.asarray(s), k, True)))
    # JAX's k-argmin form (unrouted), the same contract
    if k <= 32:
        np.testing.assert_array_equal(
            n(got), np.asarray(jpo.min_k_indices(jnp.asarray(s), k, False)))
    # bf16 scores take the same key; f64 the stable sort
    sb = jnp.asarray(s, jnp.bfloat16)
    np.testing.assert_array_equal(n(pointops.min_k_indices(t(s).bfloat16(), k)),
                                  np.asarray(jpo.min_k_indices(sb, k, True)))
    np.testing.assert_array_equal(n(pointops.min_k_indices(t(s).double(), k)),
                                  np.asarray(jpo.min_k_indices(jnp.asarray(s), k, True)))


@pytest.mark.parametrize("N,k,block", [(4096, 16, 1024), (4096, 64, 512), (3000, 16, 1024),
                                       (1024, 8, 1024)])
def test_blocked_top_k_min(N, k, block):
    s = _scores((2, 5, N), N + k)
    got = pointops.blocked_top_k_min(t(s), k, block)
    np.testing.assert_array_equal(
        n(got), np.asarray(jpo.blocked_top_k_min(jnp.asarray(s), k, block)))
    np.testing.assert_array_equal(n(got), n(pointops.min_k_indices(t(s), k)))


def test_worker_seed():
    for base, worker in [(0, 0), (0, 7), (12345, 3), (2**31, 1), (10**12, 999)]:
        assert seeding.worker_seed(base, worker) == jseeding.worker_seed(base, worker)
