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
kernel (``ops/select_cuda.py``) on the card.

The same real-number function as the gathered level; the floats differ
only in the statistics' order of summation. Under an ambient mesh
(``parallel/mesh.py``) the select kernel runs per rank on its rows, as the
JAX package runs it per shard, and the weighted statistics take every
rank's valid rows.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from i2pnet_tpu_torch.ops.pointops import safe_norm
from i2pnet_tpu_torch.parallel.mesh import global_means
from i2pnet_tpu_torch.ops.projection import strided_downsample, window_candidates
from i2pnet_tpu_torch.ops.select_cuda import selection_multiplicity, window_multiplicity

BN_EPS = 1e-5

__all__ = ["selection_multiplicity", "dense_pointnet_eval"]


def _candidates(grid: torch.Tensor, wargs) -> torch.Tensor:
    """Every window slot of every query of grid (B, h2, w2, C), then the
    sentinel slot, the grid's (0, 0) pixel: (B, N, kh*kw + 1, C)."""
    cand = window_candidates(grid, *wargs)[0]
    B, N, _, C = cand.shape
    sentinel = grid[:, 0, 0, :].reshape(B, 1, 1, C).expand(B, N, 1, C)
    return torch.cat([cand, sentinel], dim=2)


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
    ctr = new_xyz_raw if raw_feat_point else new_xyz
    wargs = (out_h, out_w, qstride, (1, 1), kernel_size, True)
    cand_xyz = _candidates(src, wargs)
    grouped_norm = cand_xyz - ctr.reshape(B, N, 1, 3)
    if center_mode:
        parts = [grouped_norm, new_xyz.reshape(B, N, 1, 3).expand_as(cand_xyz), cand_xyz,
                 safe_norm(grouped_norm, dim=-1, keepdim=True)]
        if using_intens:
            parts.append(_candidates(feature, wargs))
        x = torch.cat(parts, dim=-1)
    elif dist_mode:  # every slot's distance to the centre, the sentinel's too
        x = safe_norm(grouped_norm, dim=-1, keepdim=True)
    else:
        x = torch.cat([grouped_norm, _candidates(feature, wargs)], dim=-1)

    total = float(B * N * nsample)
    mw = m[..., None]  # (B, N, S, 1)
    dims = (0, 1, 2)
    for weight, bias, scale, shift in layers:
        if dtype is not None:
            x = torch.matmul(x.to(dtype), weight.to(dtype).t()) + bias.to(dtype)
        else:
            x = torch.matmul(x, weight.t()) + bias
        x = x.float()
        # under an ambient mesh, the weighted sums and the selected-slot
        # count of every rank's valid rows, all-reduced
        mean = global_means([x * mw], dims, per_row=N * nsample)
        if mean is None:
            mean = torch.sum(x * mw, dim=dims) / total
            var = torch.sum(torch.square(x - mean) * mw, dim=dims) / total
        else:
            mean = mean[0]
            var = global_means([torch.square(x - mean) * mw], dims, per_row=N * nsample)[0]
        y = (x - mean) * torch.rsqrt(var + eps)
        x = torch.relu(y * scale + shift)

    # the max over the selected slots; every query selects K of them
    x = torch.where(mw > 0, x, -torch.inf)
    new_feat = torch.amax(x, dim=2).reshape(B, out_h, out_w, -1)
    return new_xyz_raw, new_xyz, new_feat
