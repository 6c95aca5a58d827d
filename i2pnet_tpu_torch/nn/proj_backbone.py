"""Projection-aware (range-image) backbone modules (port of
``i2pnet_tpu/nn/proj_backbone.py``): ``ProjectPointNet``,
``ProjSetUpconv``, ``ProjCostVolume``, ``ProjFlowPredictor``.

Every normalisation here is the stateless ``BatchStatsNorm`` (the current
batch's statistics, at eval too); ``ProjectPointNet``'s MLP uses ReLU, the
others LeakyReLU(0.1). Grids stay (B, H, W, C); neighbours come from
windowed selects on the grids (``ops/projection.py``).

At eval, ``ProjectPointNet`` with BatchStatsNorm takes the dense route
(``ops/dense_window.py``, multiplicities from the selection kernel on the
card), as the JAX package does on its chip, unless
``I2PNET_PROJ_DENSE_EVAL=0`` (read at call time); in training it takes the
gathered route.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from i2pnet_tpu_torch.nn.layers import PointwiseConv, PointwiseMLP, cat, eval_route, softmax
from i2pnet_tpu_torch.ops.cv_cuda import mean_std_normalize
from i2pnet_tpu_torch.ops.dense_window import dense_pointnet_eval
from i2pnet_tpu_torch.ops.pointops import grouping, safe_norm
from i2pnet_tpu_torch.ops.projection import (
    check_valid,
    select_window_features_multi,
    strided_downsample,
    window_neighbor_select_grid,
)


def mask_logits(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """x where valid is 1, -1e10 where it is 0 (JAX's promotion: bf16 x with
    an f32 mask gives f32)."""
    return x * valid + -1e10 * (1 - valid)


class ProjectPointNet(nn.Module):
    """Strided-grid downsampling + windowed-neighbour PointNet.

    ``in_channels`` is the grouped feature width: 10 (+ the feature width
    with ``using_intens``) in center mode, 1 in dist mode, else 3 + the
    feature width. center_mode builds [diff(3), center(3, warped frame),
    grouped(3), dist(1)]; dist_mode the distance to the centre alone (the
    reference's distance-only backbone); otherwise [diff(3),
    grouped_points(C)]. The modes are call-time flags, as in the JAX
    module; a call whose modes need another width than the one built
    raises ``ValueError``.
    """

    def __init__(self, out_h: int, out_w: int, stride_h: int, stride_w: int,
                 kernel_size: Tuple[int, int], nsample: int, distance: float,
                 mlp: Sequence[int], in_channels: int, use_trans: bool = True,
                 use_bn: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out_h, self.out_w = out_h, out_w
        self.stride = (stride_h, stride_w)
        self.kernel_size = tuple(kernel_size)
        self.nsample, self.distance = nsample, distance
        self.use_trans, self.use_bn, self.dtype = use_trans, use_bn, dtype
        self.mlp_convs = PointwiseMLP(in_channels, mlp, use_bn=use_bn, activation="relu",
                                      dtype=dtype, bn_stats=False)

    def forward(self, xyz_raw, xyz, feature, center_mode: bool = False, dist_mode: bool = False,
                using_intens: bool = False, raw_feat_point: bool = True):
        """xyz_raw, xyz (B, H, W, 3); feature (B, H, W, C) -> (new_xyz_raw,
        new_xyz (B, out_h, out_w, 3), new_feat (B, out_h, out_w, mlp[-1]))."""
        C = feature.shape[-1]
        width = (10 + C * using_intens) if center_mode else 1 if dist_mode else 3 + C
        if self.mlp_convs.layers and width != self.mlp_convs.layers[0].Dense_0.in_features:
            raise ValueError(f"the call's modes group {width} channels; the level was built "
                             f"for {self.mlp_convs.layers[0].Dense_0.in_features}")
        modes = dict(center_mode=center_mode, dist_mode=dist_mode, using_intens=using_intens,
                     raw_feat_point=raw_feat_point)
        if self.use_bn and not self.training and eval_route("I2PNET_PROJ_DENSE_EVAL"):
            layers = [(c.Dense_0.weight, c.Dense_0.bias, c.BatchStatsNorm_0.weight,
                       c.BatchStatsNorm_0.bias) for c in self.mlp_convs.layers]
            return dense_pointnet_eval(
                xyz_raw, xyz, feature, layers, out_h=self.out_h, out_w=self.out_w,
                stride_h=self.stride[0], stride_w=self.stride[1], kernel_size=self.kernel_size,
                nsample=self.nsample, distance=self.distance, use_trans=self.use_trans,
                dtype=self.dtype, **modes,
            )
        return self._gathered(xyz_raw, xyz, feature, **modes)

    def _gathered(self, xyz_raw, xyz, feature, center_mode, dist_mode, using_intens,
                  raw_feat_point):
        B = xyz.shape[0]
        out_h, out_w = self.out_h, self.out_w
        N = out_h * out_w
        new_xyz = strided_downsample(xyz, out_h, out_w, *self.stride)
        new_xyz_raw = strided_downsample(xyz_raw, out_h, out_w, *self.stride)
        xyz_pr = xyz if self.use_trans else xyz_raw
        args, _ = window_neighbor_select_grid(
            xyz_pr, xyz_pr, out_h, out_w, self.stride, self.kernel_size, self.nsample,
            stride=(1, 1), distance=self.distance, shift=True, copy=True,
        )
        src = xyz_raw if raw_feat_point else xyz
        ctr = new_xyz_raw if raw_feat_point else new_xyz
        grouped_points, grouped_xyz = select_window_features_multi(
            [feature, src], args, out_h=out_h, out_w=out_w, qstride=self.stride, stride=(1, 1),
            kernel_size=self.kernel_size, shift=True,
        )
        grouped_norm = grouped_xyz - ctr.reshape(B, N, 1, 3)
        if center_mode:
            # the center is the WARPED grid's, even with raw_feat_point
            parts = [grouped_norm, new_xyz.reshape(B, N, 1, 3).expand_as(grouped_xyz),
                     grouped_xyz, safe_norm(grouped_norm, dim=-1, keepdim=True)]
            if using_intens:
                parts.append(grouped_points)
            new_points = cat(parts, -1)
        elif dist_mode:
            new_points = safe_norm(grouped_norm, dim=-1, keepdim=True)
        else:
            new_points = cat([grouped_norm, grouped_points], -1)
        new_points = self.mlp_convs(new_points)
        new_feat = torch.amax(new_points, dim=2).reshape(B, out_h, out_w, -1)
        return new_xyz_raw, new_xyz, new_feat


class ProjSetUpconv(nn.Module):
    """Windowed coarse -> fine feature upsampling. ``feat2_channels`` and
    ``feat1_channels`` are the coarse and fine feature widths (feat1 None
    means 0); the output is (B, out_h*out_w, out_channels). The geometry
    beside each neighbour's features is its offset from the fine point (3
    channels), or with ``dist_mode`` its distance (1, the reference's
    distance-only backbone). The width is fixed here; the call's
    ``dist_mode`` flag, as the JAX module's, must match it."""

    def __init__(self, out_h: int, out_w: int, stride_h: int, stride_w: int,
                 kernel_size: Tuple[int, int], nsample: int, distance: float,
                 mlp: Sequence[int], mlp2: Sequence[int], feat2_channels: int,
                 feat1_channels: int, use_trans: bool = True, use_bn: bool = True,
                 dtype: Optional[torch.dtype] = None, dist_mode: bool = False):
        super().__init__()
        self.out_h, self.out_w = out_h, out_w
        self.stride = (stride_h, stride_w)
        self.kernel_size = tuple(kernel_size)
        self.nsample, self.distance = nsample, distance
        self.use_trans, self.dist_mode = use_trans, dist_mode
        width = feat2_channels + (1 if dist_mode else 3)
        kw = dict(use_bn=use_bn, dtype=dtype, bn_stats=False)
        self.mlp_conv = PointwiseMLP(width, mlp, **kw) if mlp else None
        width = (mlp[-1] if mlp else width) + feat1_channels
        self.mlp2_conv = PointwiseMLP(width, mlp2, **kw) if mlp2 else None
        self.out_channels = mlp2[-1] if mlp2 else width

    def forward(self, xyz1_raw, xyz2_raw, xyz1, xyz2, feat1, feat2, raw_feat_point: bool = True,
                dist_mode: bool = False):
        """xyz1* (B, out_h, out_w, 3) fine; xyz2* (B, h2, w2, 3) coarse; feat1
        (B, out_h, out_w, C1) or None; feat2 (B, h2, w2, C2)."""
        if dist_mode != self.dist_mode:
            raise ValueError(f"dist_mode={dist_mode}, but the module was built with "
                             f"dist_mode={self.dist_mode}")
        B = xyz1.shape[0]
        N = self.out_h * self.out_w
        xyz1_pr = xyz1 if self.use_trans else xyz1_raw
        xyz2_pr = xyz2 if self.use_trans else xyz2_raw
        wargs = dict(out_h=self.out_h, out_w=self.out_w, qstride=(1, 1), stride=self.stride,
                     kernel_size=self.kernel_size, shift=True)
        args, _ = window_neighbor_select_grid(
            xyz1_pr, xyz2_pr, self.out_h, self.out_w, (1, 1), self.kernel_size, self.nsample,
            stride=self.stride, distance=self.distance, shift=True, copy=True,
        )
        src2 = xyz2_raw if raw_feat_point else xyz2
        ctr1 = xyz1_raw if raw_feat_point else xyz1
        grouped_xyz, grouped_feat2 = select_window_features_multi([src2, feat2], args, **wargs)
        diff = grouped_xyz - ctr1.reshape(B, N, 1, 3)
        net = cat([grouped_feat2, safe_norm(diff, dim=-1, keepdim=True) if dist_mode else diff], 3)
        if self.mlp_conv is not None:
            net = self.mlp_conv(net)
        feat1_new = torch.amax(net, dim=2).reshape(B, self.out_h, self.out_w, -1)
        if feat1 is not None:
            feat1_new = cat([feat1_new, feat1], 3)
        if self.mlp2_conv is not None:
            feat1_new = self.mlp2_conv(feat1_new)
        return feat1_new.reshape(B, N, -1)


class ProjCostVolume(nn.Module):
    """2D-3D cost volume on the range grid. The image side is the free-point
    cost volume's with a validity-masked backward validation; the 3D side
    attends over windowed grid neighbours with a valid-masked softmax.
    ``in_channels`` is C, the width of both the LiDAR and the image
    features; the output is (B, H, W, mlp1[-1])."""

    def __init__(self, H: int, W: int, kernel_size: Tuple[int, int], distance: float,
                 nsample: int, nsample_q: int, mlp1: Sequence[int], mlp2: Sequence[int],
                 in_channels: int, backward_validation: bool = False, use_trans: bool = True,
                 use_bn: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        C, D = in_channels, mlp1[-1]
        self.H, self.W = H, W
        self.kernel_size = tuple(kernel_size)
        self.distance, self.nsample, self.nsample_q = distance, nsample, nsample_q
        self.backward_validation, self.use_trans = backward_validation, use_trans
        kw = dict(use_bn=use_bn, dtype=dtype, bn_stats=False)
        self.mlp1_convs = PointwiseMLP(6 + C + (C if backward_validation else 0), mlp1, **kw)
        self.pi_encoding = PointwiseConv(6, D, **kw)
        self.mlp2_convs = PointwiseMLP(2 * D, mlp2, **kw)
        self.pc_encoding = PointwiseConv(10, D, **kw)
        self.mlp2_convs_2 = PointwiseMLP(2 * D + C, mlp2, **kw)

    def forward(self, xyz_raw, warped_xyz, warped_points, idx_n2, f2_xyz, f2_points, lidar_z):
        """xyz_raw (B, H, W, 3) raw grid; warped_xyz (B, H*W, 3) normalized-
        plane coordinates; warped_points (B, H*W, C); f2_xyz (B, M, 3) and
        f2_points (B, M, C) the image pixels; lidar_z (B, H*W, 1). idx_n2 is
        unused, as in the JAX module."""
        B, N, _ = warped_xyz.shape
        # mean/std normalisation is per vector: normalising before the
        # gather or the broadcast gives the same values
        qn = mean_std_normalize(f2_points)
        if self.nsample_q > 0:
            qi_xyz, _, qi_norm, _, _ = grouping(qn, self.nsample_q, f2_xyz, warped_xyz)
        else:
            M = f2_xyz.shape[1]
            qi_xyz = f2_xyz[:, None].expand(B, N, M, 3)
            qi_norm = qn[:, None].expand(B, N, M, qn.shape[-1])

        warped_xyz = warped_xyz * lidar_z  # restore depth
        K = qi_xyz.shape[2]
        pi_xyz_diff_concat = torch.cat([warped_xyz[:, :, None].expand(B, N, K, 3), qi_xyz], 3)
        pi_norm = mean_std_normalize(warped_points)[:, :, None]
        pi_feat_diff = pi_norm * qi_norm
        feats = [pi_xyz_diff_concat, pi_feat_diff]
        if self.backward_validation:
            valid = check_valid(warped_xyz)[..., None]  # (B, N, 1, 1)
            respond = torch.amax(mask_logits(qi_norm * pi_norm, valid), dim=1, keepdim=True)
            feats.append(respond.expand((B, N) + respond.shape[2:]))
        pi_feat1_new = self.mlp1_convs(cat(feats, 3))
        pi_xyz_encoding = self.pi_encoding(pi_xyz_diff_concat)
        pi_concat = self.mlp2_convs(cat([pi_xyz_encoding, pi_feat1_new], 3))
        pi_feat1_new = torch.sum(softmax(pi_concat, dim=2) * pi_feat1_new, dim=2)

        # --- 3D side: windowed grid neighbours, valid-masked softmax
        H, W = self.H, self.W
        warped_grid = warped_xyz.reshape(B, H, W, 3)
        xyz_pr = warped_grid if self.use_trans else xyz_raw
        args, valid_mask = window_neighbor_select_grid(
            xyz_pr, xyz_pr, H, W, (1, 1), self.kernel_size, self.nsample, stride=(1, 1),
            distance=self.distance, shift=True, copy=False,
        )
        pc_xyz_grouped, pc_points_grouped = select_window_features_multi(
            [warped_grid, pi_feat1_new.reshape(B, H, W, -1)], args, out_h=H, out_w=W,
            qstride=(1, 1), stride=(1, 1), kernel_size=self.kernel_size, shift=True,
        )
        S = self.nsample
        pc_xyz_new = warped_xyz[:, :, None].expand(B, N, S, 3)
        pc_points_new = warped_points[:, :, None].expand(B, N, S, warped_points.shape[-1])
        pc_xyz_diff = pc_xyz_grouped - pc_xyz_new
        pc_euc_diff = torch.sqrt(torch.sum(pc_xyz_diff * pc_xyz_diff, dim=3, keepdim=True) + 1e-20)
        pc_xyz_encoding = self.pc_encoding(
            torch.cat([pc_xyz_new, pc_xyz_grouped, pc_xyz_diff, pc_euc_diff], 3))
        pc_concat = self.mlp2_convs_2(cat([pc_xyz_encoding, pc_points_new, pc_points_grouped], -1))
        wp = softmax(mask_logits(pc_concat, valid_mask), dim=2)
        return torch.sum(wp * pc_points_grouped, dim=2).reshape(B, H, W, -1)


class ProjFlowPredictor(nn.Module):
    """Concat [points_f1, cost_volume(, upsampled)] -> pointwise MLP with
    BatchStatsNorm."""

    def __init__(self, in_channels: int, mlp: Sequence[int], use_bn: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp_conv = PointwiseMLP(in_channels, mlp, use_bn=use_bn, dtype=dtype, bn_stats=False)

    def forward(self, points_f1, upsampled_feat, cost_volume):
        parts = [points_f1, cost_volume]
        if upsampled_feat is not None:
            parts.append(upsampled_feat)
        return self.mlp_conv(cat(parts, -1))
