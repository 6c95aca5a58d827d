"""Point-cloud primitives (port of ``i2pnet_tpu/ops/pointops.py``).

KNN is the exact dense form: expanded squared distances with a full-f32
cross term, then a top-k that orders equal distances by index, as
``lax.top_k`` does. FPS is the op ``torch.ops.i2pnet.fps``, which
dispatches on the tensor's device: the CUDA kernel (``ops/fps_cuda.py``)
for a CUDA tensor, the plain loop for a CPU one. Gathers are batched
advanced indexing.
"""

from __future__ import annotations

from typing import Optional

import torch


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """L2 norm that is exactly 0 (with a zero subgradient) at x == 0."""
    sumsq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    positive = sumsq > 0
    one = torch.ones_like(sumsq)
    return torch.where(positive, torch.sqrt(torch.where(positive, sumsq, one)), 0.0)


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance (B, N, M) as |s|^2 + |d|^2 - 2 s.d.

    The cross term is a float32 batched matmul; PyTorch keeps float32
    matmuls in full precision on the card unless TF32 is switched on, and
    the KNN orderings need it.
    """
    cross = torch.bmm(src, dst.transpose(1, 2))
    s2 = torch.sum(src * src, dim=-1)[:, :, None]
    d2 = torch.sum(dst * dst, dim=-1)[:, None, :]
    return s2 + d2 - 2.0 * cross


def _order_key(dist: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """int64 keys that order f32 distances, then indices: the distance's
    bits, mapped to an order-preserving int32 (a negative value, from the
    expansion's cancellation, has its magnitude bits flipped), times 2**32,
    plus the index. Every key is distinct. A distance is never -0.0 here:
    it is a difference of equal non-negative sums at most."""
    bits = dist.view(torch.int32).to(torch.int64)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return key.mul_(1 << 32).add_(index)


def knn_by_key(nsample: int, sqrdists: torch.Tensor) -> torch.Tensor:
    """The nsample smallest of f32 sqrdists (..., N), by distance and then
    index, in that order: a top-k of ``_order_key`` over the whole row."""
    index = torch.arange(sqrdists.shape[-1], device=sqrdists.device)
    key = _order_key(sqrdists, index)
    return torch.topk(key, nsample, dim=-1, largest=False, sorted=True).indices


_KEY_DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # exact in f32


def _min_key(scores: torch.Tensor) -> torch.Tensor:
    """``_order_key`` of scores (..., N) of up to f32 width, for any sign:
    the order of ``lax.top_k`` of their negation, which sets -0.0 before
    +0.0 (a total order) and equal values lowest index first."""
    index = torch.arange(scores.shape[-1], device=scores.device)
    return _order_key(scores.float(), index)


def min_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (..., k) of the k smallest scores along the last axis,
    smallest first, equal scores lowest index first: the contract of
    ``lax.top_k(-scores, k)[1]``, index for index. Scores of up to f32
    width take a top-k of ``_min_key`` (``knn_by_key``'s order); wider ones
    a stable sort."""
    if scores.dtype not in _KEY_DTYPES:
        return torch.sort(scores, dim=-1, stable=True).indices[..., :k]
    key = _min_key(scores)
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).values.bitwise_and_(0xFFFFFFFF)


def blocked_top_k_min(scores: torch.Tensor, k: int, block: int = 1024) -> torch.Tensor:
    """``min_k_indices``, under the JAX package's name. JAX splits long rows
    into blocks of ``block`` for the TPU's top-k; the result is the same
    either way, so ``block`` is taken for the signature and not used."""
    del block
    return min_k_indices(scores, k)


def knn_point(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """Indices (B, S, nsample) of the nearest points of xyz (B, N, C) to
    each query of new_xyz (B, S, C), nearest first and equal distances
    lowest index first: the JAX package's exact path, ``lax.top_k`` of the
    negated distances, index for index.

    The order of ties decides which neighbours a query takes wherever they
    straddle the nsample-th place: duplicated points (a loader's zero
    padding, sampling with repetition) and queries on a regular pixel grid
    (a zero point projects to the principal point) make such ties.

    On the card, ``torch.topk`` of the f32 distances picks the right set:
    its gather takes the values past the k-th in index order and fills the
    rest with the k-th value's ties, first seen first
    (``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py`` hold it
    against ``knn_by_key``); the picks are then ordered by distance and
    index. On the CPU, whose top-k leaves ties in no set order,
    ``knn_by_key`` runs on the whole row (an int64 top-k, too slow for the
    card's first level). Distances wider than f32 (an f64 run) take a
    stable sort."""
    sqrdists = square_distance(new_xyz, xyz)
    if sqrdists.dtype != torch.float32:
        return torch.sort(sqrdists, dim=-1, stable=True).indices[..., :nsample]
    if not sqrdists.is_cuda:
        return knn_by_key(nsample, sqrdists)
    vals, idx = torch.topk(sqrdists, nsample, dim=-1, largest=False, sorted=False)
    return torch.sort(_order_key(vals, idx), dim=-1).values.bitwise_and_(0xFFFFFFFF)


def masked_knn_point(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """KNN where points with mask == 0 sit at distance 1e10: (B, S, nsample)
    indices, nearest first, equal distances lowest index first (the JAX
    package's ``lax.top_k``). mask (B, N) in {0, 1}."""
    sqrdists = square_distance(new_xyz, xyz)
    mask = mask[:, None, :].to(sqrdists.dtype)
    return knn_by_key(nsample, sqrdists * mask + 1e10 * (1.0 - mask))


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """The first nsample points within radius of each query, in index
    order, padded with the first hit: (B, S, nsample) int64. A query with
    no hit takes index 0. Out-of-range points get the sentinel N, a stable
    sort brings the hits forward, and the sentinels left are replaced."""
    N = xyz.shape[1]
    sqrdists = square_distance(new_xyz, xyz)
    arange = torch.arange(N, device=xyz.device).expand(sqrdists.shape)
    cand = torch.where(sqrdists <= radius * radius, arange, N)
    cand = torch.sort(cand, dim=-1, stable=True).values[:, :, :nsample]
    cand = torch.where(cand == N, cand[:, :, 0:1], cand)
    return torch.where(cand == N, 0, cand)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The 3 nearest known points (B, M, 3) of each unknown point (B, N, 3):
    (euclidean distances (B, N, 3), indices (B, N, 3)), nearest first, ties
    lowest index first."""
    sqrdists = square_distance(unknown, known)
    idx = knn_by_key(3, sqrdists)
    return torch.sqrt(torch.clamp(torch.gather(sqrdists, -1, idx), min=0.0)), idx


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Features (B, M, C) gathered at idx (B, N, 3) and summed with weight
    (B, N, 3) -> (B, N, C)."""
    return torch.sum(index_points(points, idx) * weight[..., None], dim=2)


def interpolation_weights(dists: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights (B, N, 3) from three_nn's distances."""
    recip = 1.0 / (dists + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather points (B, N, C) by idx (B, S) or (B, S, K) -> (B, S[, K], C)."""
    if idx.dim() not in (2, 3):
        raise ValueError(f"idx must be rank 2 or 3, got {idx.dim()}")
    B = points.shape[0]
    rows = torch.arange(B, device=points.device).view((B,) + (1,) * (idx.dim() - 1))
    return points[rows, idx]


# the JAX package's name for the neighbour gather (the reference's group_points)
group_points = index_points


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS (B, N, 3) -> (B, npoint) int64, starting at index 0.

    The op ``torch.ops.i2pnet.fps`` (``ops/library.py``): a CUDA tensor goes
    to the kernel (which raises on what it cannot take), a CPU tensor to
    the plain loop. Both give the same indices.
    """
    return torch.ops.i2pnet.fps(xyz, npoint)


def grouping(
    feature: torch.Tensor,
    K: int,
    src_xyz: torch.Tensor,
    q_xyz: torch.Tensor,
    raw_src_xyz: Optional[torch.Tensor] = None,
    raw_q_xyz: Optional[torch.Tensor] = None,
):
    """KNN-group features around query points.

    Returns (grouped_xyz (B,S,K,3), xyz_diff (B,S,K,3), grouped_feature
    (B,S,K,C), idx (B,S,K), grouped_raw_xyz or None). With raw coordinates
    the neighbours come from src/q xyz and the diff from the raw frame.
    """
    idx = knn_point(K, src_xyz, q_xyz)
    grouped_xyz = index_points(src_xyz, idx)
    grouped_feature = index_points(feature, idx)
    grouped_raw = None
    if raw_src_xyz is not None:
        grouped_raw = index_points(raw_src_xyz, idx)
        xyz_diff = grouped_raw - raw_q_xyz[:, :, None, :]
    else:
        xyz_diff = grouped_xyz - q_xyz[:, :, None, :]
    return grouped_xyz, xyz_diff, grouped_feature, idx, grouped_raw


def mask_grouping(feature: torch.Tensor, K: int, src_xyz: torch.Tensor, q_xyz: torch.Tensor,
                  mask: torch.Tensor, use_xyz: bool = False):
    """KNN-group around q_xyz among the source points with mask == 1.
    Returns (grouped_xyz (B,S,K,3), xyz_diff (B,S,K,3), new_points
    (B,S,K,C), or (B,S,K,3+C) with use_xyz, idx (B,S,K))."""
    idx = masked_knn_point(K, src_xyz, q_xyz, mask)
    packed = index_points(torch.cat([src_xyz, feature], dim=-1), idx)
    grouped_xyz, grouped_feature = packed[..., :3], packed[..., 3:]
    xyz_diff = grouped_xyz - q_xyz[:, :, None, :]
    new_points = torch.cat([xyz_diff, grouped_feature], dim=-1) if use_xyz else grouped_feature
    return grouped_xyz, xyz_diff, new_points, idx


def sample_and_group(
    npoint: int,
    nsample: int,
    xyz: torch.Tensor,
    points: Optional[torch.Tensor],
    sample_idx: Optional[torch.Tensor] = None,
    raw_xyz: Optional[torch.Tensor] = None,
    feat_mode: Optional[str] = None,
):
    """FPS-downsample then KNN-group, building per-group features.

    feat_mode None -> [xyz_diff, grouped_points]; 'dim10feat' ->
    [xyz_diff, center, grouped_xyz, dist]; 'dist' -> dist.
    Returns (new_xyz (B,S,3), new_points (B,S,K,F), fps_idx (B,S),
    new_raw_xyz (B,S,3) or None).
    """
    fps_idx = sample_idx if sample_idx is not None else farthest_point_sample(xyz, npoint)
    new_xyz = index_points(xyz, fps_idx)
    new_raw_xyz = index_points(raw_xyz, fps_idx) if raw_xyz is not None else None

    idx = knn_point(nsample, xyz, new_xyz)
    src = raw_xyz if raw_xyz is not None else xyz
    center = new_raw_xyz if raw_xyz is not None else new_xyz
    grouped_xyz = index_points(src, idx)
    grouped_xyz_norm = grouped_xyz - center[:, :, None, :]

    if feat_mode == "dim10feat":
        dist = safe_norm(grouped_xyz_norm, dim=-1, keepdim=True)
        new_points = torch.cat(
            [grouped_xyz_norm, center[:, :, None, :].expand_as(grouped_xyz), grouped_xyz, dist],
            dim=-1,
        )
    elif feat_mode == "dist":
        new_points = safe_norm(grouped_xyz_norm, dim=-1, keepdim=True)
    elif points is not None:
        new_points = torch.cat([grouped_xyz_norm, index_points(points, idx)], dim=-1)
    else:
        new_points = grouped_xyz_norm
    return new_xyz, new_points, fps_idx, new_raw_xyz
