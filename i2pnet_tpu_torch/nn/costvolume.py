"""2D-3D cost volume (port of ``i2pnet_tpu/nn/costvolume.py``).

Each (warped) LiDAR point attends over image pixels treated as
normalized-plane 3D points, then the per-point embeddings are smoothed by
attention over a 3D KNN neighbourhood. The correlation is
``elementwise_product`` (mean/std-normalised features multiplied, the
shipped one), ``concat`` (the raw features side by side) or ``cosine``
(unit-norm features multiplied); ``max_cost`` replaces the pixel softmax
by a max over the pixels, and ``backward_fc`` passes the
backward-validation response through a pointwise conv (``PointwiseConv_0``,
as flax names it).

At eval in bf16, the all-pixels elementwise-product pi side runs as the
fused cv1 kernel (``ops/cv_cuda.py``) under the JAX package's routing
condition (costvolume.py:86-94 there, ``CostVolume.fuses_cv1``);
``I2PNET_FUSED_CV=0`` (read at call time) takes the native chain.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from i2pnet_tpu_torch.nn.layers import PointwiseConv, PointwiseMLP, cat, eval_route, softmax
from i2pnet_tpu_torch.ops import cv_cuda
from i2pnet_tpu_torch.ops.cv_cuda import mean_std_normalize
from i2pnet_tpu_torch.ops.pointops import index_points, knn_point, safe_norm

CORR_FUNCS = ("elementwise_product", "concat", "cosine")


def _unit_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(|x|, 1e-12) over channels (the cosine correlation's factor)."""
    return x / torch.clamp(safe_norm(x, dim=-1, keepdim=True), min=1e-12)


class CostVolume(nn.Module):
    """``in_channels`` is C, the width of both the LiDAR and the image
    features; the output is (B, N, mlp1[-1])."""

    def __init__(self, nsample: int, nsample_q: int, mlp1: Sequence[int], mlp2: Sequence[int],
                 in_channels: int, corr_func: str = "elementwise_product",
                 backward_validation: bool = False, max_cost: bool = False,
                 backward_fc: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if corr_func not in CORR_FUNCS:
            raise ValueError(f"CostVolume corr_func={corr_func!r}: expected one of {CORR_FUNCS}")
        C, D = in_channels, mlp1[-1]
        self.nsample, self.nsample_q = nsample, nsample_q
        self.mlp1, self.mlp2 = tuple(mlp1), tuple(mlp2)
        self.corr_func = corr_func
        self.backward_validation = backward_validation
        self.max_cost, self.backward_fc = max_cost, backward_fc
        self.dtype = dtype
        corr_width = 2 * C if corr_func == "concat" else C
        if backward_validation and backward_fc:
            # unnamed in flax, and without the compute dtype
            self.PointwiseConv_0 = PointwiseConv(C, C, use_bn=True)
        self.mlp1_convs = PointwiseMLP(6 + corr_width + (C if backward_validation else 0), mlp1,
                                       dtype=dtype)
        self.pi_encoding = PointwiseConv(6, D, use_bn=True, dtype=dtype)
        # under max_cost the flax tree has no mlp2_convs (pi_encoding stays)
        self.mlp2_convs = None if max_cost else PointwiseMLP(2 * D, mlp2, dtype=dtype)
        self.pc_encoding = PointwiseConv(10, D, use_bn=True, dtype=dtype)
        self.mlp2_convs_2 = PointwiseMLP(2 * D + C, mlp2, dtype=dtype)

    def fuses_cv1(self) -> bool:
        """Whether this call takes the fused cv1 route: every condition of
        the JAX package's (eval, all pixels, the elementwise product, no
        max_cost, no backward_fc, bf16), the kernel's shape gate, and
        ``I2PNET_FUSED_CV`` not 0."""
        return (
            not self.training
            and self.nsample_q <= 0
            and self.corr_func == "elementwise_product"
            and not self.max_cost
            and not self.backward_fc
            and self.dtype == torch.bfloat16
            and cv_cuda.fused_cv1_eval_supported(self.mlp1, self.mlp2)
            and eval_route("I2PNET_FUSED_CV")
        )

    def forward(self, warped_xyz, warped_points, f2_xyz, f2_points, lidar_z):
        """warped_xyz (B,N,3) normalized-plane points; warped_points (B,N,C)
        LiDAR features; f2_xyz (B,M,3) pixel-plane coords; f2_points (B,M,C)
        image features; lidar_z (B,N,1) depths."""
        B, N, _ = warped_xyz.shape
        plane_xyz = warped_xyz
        warped_xyz = warped_xyz * lidar_z  # restore depth

        if self.fuses_cv1():
            pi_feat1_new = cv_cuda.fused_cv1_eval(
                warped_xyz, warped_points, f2_xyz, f2_points,
                [layer.fold_eval() for layer in self.mlp1_convs.layers],
                self.pi_encoding.fold_eval(),
                [layer.fold_eval() for layer in self.mlp2_convs.layers],
                bval=self.backward_validation,
            )
        else:
            pi_feat1_new = self._pi_native(plane_xyz, warped_xyz, warped_points, f2_xyz, f2_points)

        # --- 3D neighbourhood attention over the LiDAR points
        idx = knn_point(self.nsample, warped_xyz, warped_xyz)
        pc_xyz_grouped = index_points(warped_xyz, idx)
        pc_points_grouped = index_points(pi_feat1_new, idx)
        pc_xyz_new = warped_xyz[:, :, None, :].expand(B, N, self.nsample, 3)
        pc_points_new = warped_points[:, :, None, :].expand(B, N, self.nsample, -1)
        pc_xyz_diff = pc_xyz_grouped - pc_xyz_new
        pc_euc_diff = torch.sqrt(torch.sum(pc_xyz_diff * pc_xyz_diff, dim=3, keepdim=True) + 1e-20)
        pc_xyz_encoding = self.pc_encoding(
            torch.cat([pc_xyz_new, pc_xyz_grouped, pc_xyz_diff, pc_euc_diff], dim=3)
        )
        pc_concat = self.mlp2_convs_2(cat([pc_xyz_encoding, pc_points_new, pc_points_grouped], -1))
        return torch.sum(softmax(pc_concat, dim=2) * pc_points_grouped, dim=2)

    def _pi_native(self, plane_xyz, warped_xyz, warped_points, f2_xyz, f2_points):
        """The pi side op by op: correlation with every pixel (or with the
        nsample_q nearest on the normalized plane), mlp1, the position
        encoding, mlp2 and a softmax over the pixels (a max under
        max_cost)."""
        B, N, _ = warped_xyz.shape
        # the correlations' factors are per vector, so computing them before
        # the gather or broadcast gives the same values
        if self.corr_func == "elementwise_product":
            pn, qn = mean_std_normalize(warped_points), mean_std_normalize(f2_points)
        elif self.corr_func == "cosine":
            pn, qn = _unit_normalize(warped_points), _unit_normalize(f2_points)
        else:  # concat: the raw features
            pn, qn = warped_points, f2_points
        if self.nsample_q > 0:
            idx = knn_point(self.nsample_q, f2_xyz, plane_xyz)
            qi_xyz, qi_norm = index_points(f2_xyz, idx), index_points(qn, idx)
        else:
            M = f2_xyz.shape[1]
            qi_xyz = f2_xyz[:, None].expand(B, N, M, 3)
            qi_norm = qn[:, None].expand(B, N, M, qn.shape[-1])
        K = qi_xyz.shape[2]
        pi_xyz_diff_concat = torch.cat([warped_xyz[:, :, None, :].expand(B, N, K, 3), qi_xyz], dim=3)
        pi_norm = pn[:, :, None, :].expand(B, N, K, pn.shape[-1])
        corr = pi_norm * qi_norm if self.corr_func != "concat" or self.backward_validation else None
        if self.corr_func == "concat":
            feats = [pi_xyz_diff_concat, cat([pi_norm, qi_norm], -1)]
        else:
            feats = [pi_xyz_diff_concat, corr]
        if self.backward_validation:
            # image -> lidar max response over all points
            respond = torch.amax(corr, dim=1, keepdim=True)
            if self.backward_fc:
                respond = self.PointwiseConv_0(respond)
            feats.append(respond.expand(B, N, K, respond.shape[-1]))
        pi_feat1_new = self.mlp1_convs(cat(feats, 3))
        if self.max_cost:
            if self.training:
                # feeds nothing under max_cost; run, as flax does, for its
                # running statistics only
                self.pi_encoding(pi_xyz_diff_concat)
            return torch.amax(pi_feat1_new, dim=2)
        pi_xyz_encoding = self.pi_encoding(pi_xyz_diff_concat)
        pi_concat = self.mlp2_convs(cat([pi_xyz_encoding, pi_feat1_new], 3))
        return torch.sum(softmax(pi_concat, dim=2) * pi_feat1_new, dim=2)
