"""The free-point I2PNet (IRMVLab/I2PNet ``src/config_lidarcenter.py``):
FPS and exact KNN levels, the all-pixel or KNN cost volumes, BatchNorm
with running statistics at eval."""

from __future__ import annotations

import torch

from ..nets import (Run, Schema, batch_norm, compose_pose, dense, flow_predictor, fps, index_points,
                    inverse_intrinsic_grid, knn, mean_std_normalize, mlp, pointwise, pose_head,
                    rgb_encoder, safe_norm, softmax, warp_points)

# the options the reference writes out, with the only value each takes
FIXED = dict(featmode="dim10feat", raw_feat_point=True, backward_fc=False,
             cost_volume_corr_func="elementwise_product", max_cost=False,
             pose_head_mlps=[[[], []], [[], []]], rotation_quat_head_dim=4,
             transition_vec_head_dim=3, split_dp=False, max_head=False,
             use_projection_mask=False, mask_sigmoid=False,
             ground_truth_projection_mask=False, ground_truth_projection_mask_eval=False,
             ground_truth_mask_layer=[False, True], layer_mask=[False, True],
             efgh=False, l1_trans_loss=True, head_pos_embedding=False)
# its norms use running statistics at eval, so an eval batch's rows are
# independent of one another
BATCH_STATS_AT_EVAL = False


def _layer_points(mc):
    pts, n = [], mc["lidar_in_points"]
    for s in mc["lidar_downsample_rate"]:
        n //= s
        pts.append(n)
    return pts


def set_abstraction(r: Run, name: str, npoint, nsample, depth, xyz, points, raw, *,
                    sample_idx=None, dim10: bool = False):
    """FPS (or the given picks), KNN of each pick in xyz, the grouped
    features in the raw frame, per layer Dense -> BatchNorm -> ReLU, a max
    over the group. Returns (new_xyz, new_feat, picks, new_raw)."""
    picks = fps(xyz, npoint) if sample_idx is None else sample_idx
    new_xyz, new_raw = index_points(xyz, picks), index_points(raw, picks)
    idx = knn(nsample, xyz, new_xyz)
    grouped = index_points(raw, idx)
    norm = grouped - new_raw[:, :, None, :]
    if dim10:
        x = torch.cat([norm, new_raw[:, :, None, :].expand_as(grouped), grouped,
                       safe_norm(norm, -1, True)], -1)
    else:
        x = torch.cat([norm, index_points(points, idx)], -1)
    for i in range(depth):
        x = torch.relu(batch_norm(r, f"{name}.BatchNorm_{i}", dense(r, f"{name}.Dense_{i}", x)))
    return new_xyz, torch.amax(x, dim=2), picks, new_raw


def cost_volume(r: Run, name: str, mc, plane_xyz, points, pix_xyz, pix_feat, z, *,
                nsample_q: int, bval: bool):
    """The free-point 2D-3D cost volume with the elementwise-product
    correlation: each point against every pixel (nsample_q <= 0) or its
    nsample_q nearest on the normalised plane, then attention over its 3D
    KNN neighbourhood."""
    m1, m2 = len(mc["cost_volume_mlps"][0]), len(mc["cost_volume_mlps"][1])
    B, N, _ = plane_xyz.shape
    xyz = plane_xyz * z
    pn, qn = mean_std_normalize(points), mean_std_normalize(pix_feat)
    if nsample_q > 0:
        idx = knn(nsample_q, pix_xyz, plane_xyz)
        qi_xyz, qi_norm = index_points(pix_xyz, idx), index_points(qn, idx)
    else:
        M = pix_xyz.shape[1]
        qi_xyz = pix_xyz[:, None].expand(B, N, M, 3)
        qi_norm = qn[:, None].expand(B, N, M, qn.shape[-1])
    K = qi_xyz.shape[2]
    diff_cat = torch.cat([xyz[:, :, None, :].expand(B, N, K, 3), qi_xyz], 3)
    corr = pn[:, :, None, :] * qi_norm
    feats = [diff_cat, corr]
    if bval:
        feats.append(torch.amax(corr, dim=1, keepdim=True).expand(B, N, K, corr.shape[-1]))
    f1 = mlp(r, f"{name}.mlp1_convs", torch.cat(feats, 3), m1)
    enc = pointwise(r, f"{name}.pi_encoding", diff_cat)
    w = mlp(r, f"{name}.mlp2_convs", torch.cat([enc, f1], 3), m2)
    f1 = torch.sum(softmax(w, 2) * f1, dim=2)

    S = mc["cost_volume_nsample"]
    idx = knn(S, xyz, xyz)
    g_xyz, g_pts = index_points(xyz, idx), index_points(f1, idx)
    c_xyz = xyz[:, :, None, :].expand(B, N, S, 3)
    d = g_xyz - c_xyz
    euc = torch.sqrt(torch.sum(d * d, 3, keepdim=True) + 1e-20)
    enc = pointwise(r, f"{name}.pc_encoding", torch.cat([c_xyz, g_xyz, d, euc], 3))
    w = mlp(r, f"{name}.mlp2_convs_2",
            torch.cat([enc, points[:, :, None, :].expand(B, N, S, -1), g_pts], -1), m2)
    return torch.sum(softmax(w, 2) * g_pts, dim=2)


def set_upconv(r: Run, name: str, nsample, d1, d2, xyz1, xyz2, feat1, feat2, raw1, raw2):
    idx = knn(nsample, xyz2, xyz1)
    diff = index_points(raw2, idx) - raw1[:, :, None, :]
    net = torch.cat([index_points(feat2, idx), diff], 3)
    net = torch.amax(mlp(r, f"{name}.mlp_conv", net, d1), dim=2)
    return mlp(r, f"{name}.mlp2_conv", torch.cat([net, feat1], 2), d2)


def forward(r: Run, mc: dict, rgb, lidar, intrinsic, lidar_feats, raw_xyz):
    """The free-point I2PNet: (out3 (B, 7), out4 (B, 7)) as [q, t]."""
    B, H, W, _ = rgb.shape
    pts, ns, mlps = _layer_points(mc), mc["lidar_group_samples"], mc["lidar_encoder_mlps"]
    fpm, upm = mc["flow_predictor_mlps"], mc["setupconv_mlps"]
    RF3 = rgb_encoder(r, mc["rgb_encoder_channels"], rgb)
    h3, w3 = RF3.shape[1:3]
    P1, LF1, _, R1 = set_abstraction(r, "lidar_lv1", pts[0], ns[0], len(mlps[0]), lidar,
                                     lidar_feats, raw_xyz, dim10=True)
    P2, LF2, _, R2 = set_abstraction(r, "lidar_lv2", pts[1], ns[1], len(mlps[1]), P1, LF1, R1)
    P3, LF3, _, R3 = set_abstraction(r, "lidar_lv3", pts[2], ns[2], len(mlps[2]), P2, LF2, R2)
    P4, LF4, fps4, R4 = set_abstraction(r, "lidar_lv4", pts[3], ns[3], len(mlps[3]), P3, LF3, R3)

    pix = inverse_intrinsic_grid(intrinsic, h3, w3, H, W)
    RF3_flat = RF3.reshape(B, h3 * w3, -1)
    z = P3[..., 2:3]
    nq, bv = mc["cost_volume_nsamples_q"], mc["backward_validation"]
    c4 = cost_volume(r, "cost_volume1", mc, P3 / (z + 1e-10), LF3, pix, RF3_flat, z,
                     nsample_q=nq[0], bval=bv[0])
    _, l4_pred, _, _ = set_abstraction(r, "layer_idx", pts[3], ns[4], len(mlps[4]), P3, c4, R3,
                                       sample_idx=fps4)
    l4_w = flow_predictor(r, "flow_predictor0", [LF4, l4_pred], len(fpm[0]), "bn")
    q4, t4 = pose_head(r, "l4_head", l4_pred, l4_w)

    warped = warp_points(P3, q4, t4)
    zw = warped[..., 2:3]
    c3 = cost_volume(r, "cost_volume2", mc, warped / (zw + 1e-10), LF3, pix, RF3_flat, zw,
                     nsample_q=nq[1], bval=bv[1])
    ups = mc["setupconv_nsamples"]
    l3_w_up = set_upconv(r, "set_upconv0_w_upsample", ups[0], len(upm[0][0]), len(upm[0][1]),
                         P3, P4, LF3, l4_w, R3, R4)
    l3_up = set_upconv(r, "set_upconv0_upsample", ups[1], len(upm[1][0]), len(upm[1][1]),
                       P3, P4, LF3, l4_pred, R3, R4)
    l3_pred = flow_predictor(r, "flow_predictor0_predict", [LF3, c3, l3_up], len(fpm[1]), "bn")
    l3_w = flow_predictor(r, "flow_predictor0_w", [LF3, l3_pred, l3_w_up], len(fpm[2]), "bn")
    q3, t3 = pose_head(r, "l3_head", l3_pred, l3_w)
    q, t = compose_pose(q3, t3, q4, t4)
    return torch.cat([q, t], 1), torch.cat([q4, t4], 1)


def schema(mc: dict):
    """Every weight of the model (``nets.Schema``)."""
    s = Schema(mc, "BatchNorm")
    mlps, fpm, bv = mc["lidar_encoder_mlps"], mc["flow_predictor_mlps"], mc["backward_validation"]

    def level(name, fin, widths):
        for i, f in enumerate(widths):
            s.lin(f"{name}.Dense_{i}", fin, f)
            s.bn(f"{name}.BatchNorm_{i}", f)
            fin = f

    level("lidar_lv1", 10, mlps[0])
    level("lidar_lv2", 3 + mlps[0][-1], mlps[1])
    level("lidar_lv3", 3 + mlps[1][-1], mlps[2])
    level("lidar_lv4", 3 + s.C3, mlps[3])
    s.cost("cost_volume1", bv[0])
    level("layer_idx", 3 + s.D, mlps[4])
    s.stack("flow_predictor0.mlp_conv", mlps[3][-1] + s.L4, fpm[0])
    s.head("l4_head", s.L4)
    s.cost("cost_volume2", bv[1])
    s.upconv("set_upconv0_w_upsample", 0, fpm[0][-1])
    s.upconv("set_upconv0_upsample", 1, s.L4)
    return s.refined_head()
