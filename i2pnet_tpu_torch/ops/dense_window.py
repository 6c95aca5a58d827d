"""Dense (all-candidate) form of the projection family's PointNet levels
(port of ``i2pnet_tpu/ops/dense_window.py``).

The gathered level selects K of the kh*kw window slots, gathers them into
(B, N, K, C), then MLP -> BatchStatsNorm -> max over K. The K axis is read
only by order-free reductions (the max and the normalisation's
statistics), so the level can run over all kh*kw + 1 slots (sentinel
included) with the per-slot selection multiplicity m: the max over the
selected slots is the max over {m > 0}, and the statistics over the
gathered multiset are m-weighted statistics over the slots (m sums to
B*N*K). No gather and no sort: m comes from the selection-multiplicity
kernel (``ops/select_cuda.py``) on the card, and there the chain after it
is the dense level kernel (``ops/dense_level_cuda.py``), which visits only
the slots with m > 0, 2L + 1 launches a level.

The same real-number function as the gathered level; the floats differ
only in the statistics' order of summation. Under an ambient mesh
(``parallel/mesh.py``) the select kernel runs per rank on its rows, as the
JAX package runs it per shard, and the weighted statistics take every
rank's valid rows.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from i2pnet_tpu_torch.ops import dense_level_cuda
from i2pnet_tpu_torch.parallel.mesh import global_means
from i2pnet_tpu_torch.ops.projection import strided_downsample
from i2pnet_tpu_torch.ops.select_cuda import selection_multiplicity, window_multiplicity

BN_EPS = 1e-5

__all__ = ["selection_multiplicity", "dense_pointnet_eval", "dense_level_passes"]


def dense_pointnet_eval(xyz_raw: torch.Tensor, xyz: torch.Tensor, feature: torch.Tensor,
                        layers: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                               torch.Tensor]],
                        *, out_h: int, out_w: int, stride_h: int, stride_w: int,
                        kernel_size: Tuple[int, int], nsample: int, distance: float,
                        center_mode: bool = False, dist_mode: bool = False,
                        using_intens: bool = False,
                        raw_feat_point: bool = True,
                        use_trans: bool = True, dtype: Optional[torch.dtype] = None,
                        eps: float = BN_EPS):
    """A ProjectPointNet level with BatchStatsNorm, evaluated densely.

    ``layers``: per MLP layer (Dense weight (out, in), Dense bias, norm
    scale, norm bias). Each layer is Dense (in ``dtype`` when given, its
    result then taken to f32) -> m-weighted two-pass batch statistics and
    normalisation in f32 -> ReLU. The grouped features are those of the
    module's modes: center_mode's ten, ``dist_mode``'s one (the distance to
    the centre) or [diff, feature]. Returns (new_xyz_raw, new_xyz, new_feat
    (B, out_h, out_w, C) f32) like the module.

    After the multiplicities, a call the kernel takes
    (``dense_level_cuda.refusal``: CUDA tensors, bf16, the kernel's widths
    and slot counts, no gradient to carry) runs ``dense_level_passes``; any other runs the plain
    chain below. ``dense_level_cuda.routes`` counts both.
    """
    B = xyz.shape[0]
    N = out_h * out_w
    qstride = (stride_h, stride_w)
    new_xyz = strided_downsample(xyz, out_h, out_w, stride_h, stride_w)
    new_xyz_raw = strided_downsample(xyz_raw, out_h, out_w, stride_h, stride_w)

    m = window_multiplicity(
        xyz if use_trans else xyz_raw, out_h=out_h, out_w=out_w, qstride=qstride,
        kernel_size=kernel_size, K=nsample, distance=distance,
    )  # (B, N, S)

    src = xyz_raw if raw_feat_point else xyz
    mode = dense_level_cuda.level_mode(center_mode, dist_mode, using_intens)
    why = dense_level_cuda.refusal(src, xyz, feature, m, [w for w, _, _, _ in layers], nsample,
                                   dtype, [t for layer in layers for t in layer[1:]])
    if why is None:
        dense_level_cuda.routes["kernel"] += 1
        new_feat = dense_level_passes(src, xyz, feature, m, layers, out_h=out_h, out_w=out_w,
                                      qstride=qstride, kernel_size=kernel_size,
                                      nsample=nsample, mode=mode, bf16=True, eps=eps)
        return new_xyz_raw, new_xyz, new_feat
    dense_level_cuda.routes["plain:" + why] += 1

    x = dense_level_cuda.grouped_features(src, xyz, feature, out_h, out_w, qstride, kernel_size,
                                          mode)
    total = float(B * N * nsample)
    mw = m[..., None]  # (B, N, S, 1)
    dims = (0, 1, 2)
    for weight, bias, scale, shift in layers:
        x = dense_level_cuda.dense_layer(x, weight, bias, dtype)
        # under an ambient mesh, the weighted sums and the selected-slot
        # count of every rank's valid rows, all-reduced
        mean = global_means([x * mw], dims, per_row=N * nsample)
        if mean is None:
            mean = torch.sum(x * mw, dim=dims) / total
            var = torch.sum(torch.square(x - mean) * mw, dim=dims) / total
        else:
            mean = mean[0]
            var = global_means([torch.square(x - mean) * mw], dims, per_row=N * nsample)[0]
        x = dense_level_cuda.normalize_relu(x, mean, var, scale, shift, eps)

    # the max over the selected slots; every query selects K of them
    x = torch.where(mw > 0, x, -torch.inf)
    new_feat = torch.amax(x, dim=2).reshape(B, out_h, out_w, -1)
    return new_xyz_raw, new_xyz, new_feat


def dense_level_passes(src: torch.Tensor, cxyz: torch.Tensor, feature: torch.Tensor,
                       m: torch.Tensor, layers, *, out_h: int, out_w: int,
                       qstride: Tuple[int, int], kernel_size: Tuple[int, int], nsample: int,
                       mode: str, bf16: bool, eps: float = BN_EPS) -> torch.Tensor:
    """The level's features (B, out_h, out_w, C) f32 from the multiplicities
    m (B, N, kh*kw + 1), in 2L + 1 passes of the op
    ``torch.ops.i2pnet.dense_level_pass`` (``ops/library.py``: the kernel on
    CUDA tensors, its plain version on CPU ones): each layer's mean pass,
    then its variance pass, then the max. src is the candidates' grid (raw
    or warped), cxyz the warped grid. A pass's per-batch-row sums go to the
    later passes as they are, with the divisor B*N*K; under an ambient mesh
    (``parallel/mesh.py``) they are first averaged over every rank's valid
    rows (``global_means``), and the divisor is 1."""
    weights, biases, scales, shifts = (list(t) for t in zip(*layers))
    N = out_h * out_w
    denom = float(m.shape[0] * N * nsample)
    stats = []
    args = (out_h, out_w, list(qstride), list(kernel_size), nsample, mode, bf16)
    for layer in range(len(weights)):
        for kind in (dense_level_cuda.MEAN, dense_level_cuda.VAR):
            sums = torch.ops.i2pnet.dense_level_pass(src, cxyz, feature, m, weights, biases,
                                                     scales, shifts, stats, denom, *args, layer,
                                                     kind, eps)
            means = global_means([sums], (0,), per_row=N * nsample)
            if means is not None:
                sums, denom = means[0][None], 1.0
            stats.append(sums)
    return torch.ops.i2pnet.dense_level_pass(src, cxyz, feature, m, weights, biases, scales,
                                             shifts, stats, denom, *args, len(weights) - 1,
                                             dense_level_cuda.MAX, eps)
