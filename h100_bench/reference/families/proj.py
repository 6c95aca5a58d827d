"""The projection-aware I2PNetProj (IRMVLab/I2PNet
``src/config_proj_lidarcenter.py``): the cloud scattered onto a range
image, windowed grid selects at every level, BatchStatsNorm (the batch's
statistics in training and at eval alike)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..nets import (INVALID_DIST, Run, Schema, compose_pose, flow_predictor, index_points,
                    inverse_intrinsic_grid, knn, mean_std_normalize, mlp, pointwise, pose_head,
                    rgb_encoder, safe_norm, softmax, warp_points)

# the options the reference writes out, with the only value each takes
FIXED = dict(use_bn_p=True, use_trans=True, rank=False, using_intens=False,
             raw_feat_point=True, rotation_quat_head_dim=4, transition_vec_head_dim=3,
             split_dp=False, max_head=False, mask_sigmoid=False, ref_pad_quirk=True,
             refine_iters=1, l1_trans_loss=True)
# its norms take the batch's statistics at eval too: an eval batch's rows
# depend on one another
BATCH_STATS_AT_EVAL = True


def _grid_sizes(init: int, strides):
    out, c = [], 1
    for s in strides:
        c *= s
        out.append(math.ceil(init / c))
    return out


def spherical_project(xyz, features, H: int, W: int, fup: float, fdown: float):
    """Scatter the raw cloud into an (H, W) range image: column from the
    azimuth, row from the elevation (top down), both clamped; the last
    point in input order wins a cell, zero points none. As the shipped
    loader's projection, cell (0, W // 2) is zeroed in every row of the
    batch whose cloud holds a zero point. Returns (xyz grid, [feature
    grids])."""
    B, N, _ = xyz.shape
    dev = xyz.device
    az_res = (2.0 * math.pi) / W
    v_res = (fup - fdown) * math.pi / 180.0 / (H - 1)
    v_offset = -(fdown * math.pi / 180.0) / v_res
    x, y, z = xyz.unbind(-1)
    r = torch.sqrt((x * x + y * y) + z * z)
    valid = r > 0.0
    col = torch.floor((math.pi - torch.atan2(y, x)) / az_res).to(torch.int64)
    beta = torch.asin(torch.where(valid, z / torch.where(valid, r, 1.0), 0.0))
    row = H - torch.floor(beta / v_res + v_offset).to(torch.int64)
    row, col = torch.clamp(row, 0, H - 1), torch.clamp(col, 0, W - 1)
    cells = H * W
    seg = row * W + col + torch.arange(B, device=dev)[:, None] * cells
    seg = torch.where(valid, seg, B * cells).reshape(-1)
    cand = torch.where(valid.reshape(-1), torch.arange(N, device=dev).repeat(B), -1)
    winner = torch.full((B * cells + 1,), -1, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(0, seg, cand, "amax")[: B * cells].reshape(B, cells)
    packed = torch.cat([xyz, *features], -1)
    picked = torch.gather(packed, 1, torch.clamp(winner, min=0)[..., None]
                          .expand(B, cells, packed.shape[-1]))
    picked = torch.where((winner >= 0)[..., None], picked, 0.0).reshape(B, H, W, -1)
    keep = torch.all(valid, dim=1).to(picked.dtype)[:, None]
    picked[:, 0, W // 2, :] = picked[:, 0, W // 2, :] * keep
    out, off = [], 3
    for f in features:
        out.append(picked[..., off: off + f.shape[-1]])
        off += f.shape[-1]
    return picked[..., :3], out


def _sq3(v):
    x, y, z = v.unbind(-1)
    return (x * x + y * y) + z * z


def window_candidates(src, out_h, out_w, qstride, stride, kernel_size):
    """Every kh x kw window slot of every regular-grid query (columns wrap
    around the cylinder; rows outside the image are marked): (cand (B,
    N, kh*kw, C), in_bounds (N, kh*kw)); slot = dh * kw + dw."""
    B, h2, w2, C = src.shape
    kh, kw = kernel_size
    dev = src.device
    ch = (torch.arange(out_h, device=dev) * qstride[0]) // stride[0]
    cw = (torch.arange(out_w, device=dev) * qstride[1]) // stride[1]
    rows = ch[:, None] + (torch.arange(kh, device=dev) - kh // 2)[None, :]
    cols = torch.remainder(cw[:, None] + (torch.arange(kw, device=dev) - kw // 2)[None, :], w2)
    row_ok = (rows >= 0) & (rows < h2)
    in_bounds = (row_ok[:, None, :, None] & torch.ones(1, out_w, 1, kw, dtype=torch.bool,
                                                        device=dev)).reshape(out_h * out_w, -1)
    t = src[:, torch.clamp(rows, 0, h2 - 1)][:, :, :, cols]  # (B, out_h, kh, out_w, kw, C)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(B, out_h * out_w, kh * kw, C), in_bounds


def window_select(xyz1, xyz2, out_h, out_w, qstride, kernel_size, K, stride, distance, copy):
    """The K nearest window slots of each regular-grid query of xyz1 on
    xyz2 within ``distance`` (empty pixels and rows outside rejected;
    equal distances lowest slot first). Returns (slots (B, N, K), with
    slot kh*kw the sentinel, the grid's (0, 0) pixel; mask (B, N, K, 1)).
    ``copy`` fills a missing slot with the nearest hit and masks nothing
    of a valid centre."""
    B = xyz1.shape[0]
    N = out_h * out_w
    center = xyz1[:, : out_h * qstride[0]: qstride[0], : out_w * qstride[1]: qstride[1]]
    center = center.reshape(B, N, 3)
    cand, in_bounds = window_candidates(xyz2, out_h, out_w, qstride, stride, kernel_size)
    d = torch.clamp(_sq3(center[:, :, None, :] - cand), min=1e-10)
    valid = (_sq3(cand) > 1e-10) & (d <= distance * distance) & in_bounds[None]
    d = torch.where(valid, d, INVALID_DIST)
    khw = d.shape[-1]
    if K > khw:
        d = F.pad(d, (0, K - khw), value=INVALID_DIST)
    d_sel, args = torch.sort(d, dim=-1, stable=True)
    d_sel, args = d_sel[..., :K], torch.clamp(args[..., :K], max=khw - 1)
    hit = d_sel < INVALID_DIST
    if copy:
        args = torch.where(hit, args, torch.where(hit[..., :1], args[..., :1], khw))
        mask = torch.ones_like(hit)
    else:
        args = torch.where(hit, args, khw)
        mask = hit
    cv = (_sq3(center) > 1e-10)[..., None]
    return torch.where(cv, args, khw), (mask & cv)[..., None].float()


def window_gather(grid, args, out_h, out_w, qstride, stride, kernel_size):
    B, _, _, C = grid.shape
    N = out_h * out_w
    cand, _ = window_candidates(grid, out_h, out_w, qstride, stride, kernel_size)
    cand = torch.cat([cand, grid[:, 0, 0, :].reshape(B, 1, 1, C).expand(B, N, 1, C)], 2)
    rows = torch.arange(B, device=grid.device)[:, None, None]
    return cand[rows, torch.arange(N, device=grid.device)[None, :, None], args]


def mask_logits(x, valid):
    return x * valid + -1e10 * (1 - valid)


def check_valid(xyz):
    return torch.any(xyz != 0, dim=-1, keepdim=True).float()


def proj_level(r: Run, name: str, depth, out_h, out_w, stride, kernel, nsample, distance,
               xyz_raw, xyz, feature, center_mode: bool = False):
    """A range-grid PointNet level: every stride-th cell, its K nearest
    window neighbours (filled by copy), [diff, centre, neighbour, distance]
    or [diff, neighbour features], per layer Dense -> BatchStatsNorm ->
    ReLU, a max over the neighbours."""
    B = xyz.shape[0]
    N = out_h * out_w
    new_xyz = xyz[:, : out_h * stride[0]: stride[0], : out_w * stride[1]: stride[1]]
    new_raw = xyz_raw[:, : out_h * stride[0]: stride[0], : out_w * stride[1]: stride[1]]
    args, _ = window_select(xyz, xyz, out_h, out_w, stride, kernel, nsample, (1, 1), distance,
                            copy=True)
    wa = (out_h, out_w, stride, (1, 1), kernel)
    g_xyz = window_gather(xyz_raw, args, *wa)
    norm = g_xyz - new_raw.reshape(B, N, 1, 3)
    if center_mode:
        x = torch.cat([norm, new_xyz.reshape(B, N, 1, 3).expand_as(g_xyz), g_xyz,
                       safe_norm(norm, -1, True)], -1)
    else:
        x = torch.cat([norm, window_gather(feature, args, *wa)], -1)
    x = mlp(r, f"{name}.mlp_convs", x, depth, "stats", "relu")
    return new_raw, new_xyz, torch.amax(x, dim=2).reshape(B, out_h, out_w, -1)


def proj_cost_volume(r: Run, name: str, mc, H, W, kernel, distance, plane_xyz, points,
                     pix_xyz, pix_feat, z, *, nsample_q: int, bval: bool):
    m1, m2 = len(mc["cost_volume_mlps"][0]), len(mc["cost_volume_mlps"][1])
    B, N, _ = plane_xyz.shape
    qn = mean_std_normalize(pix_feat)
    if nsample_q > 0:
        idx = knn(nsample_q, pix_xyz, plane_xyz)
        qi_xyz, qi_norm = index_points(pix_xyz, idx), index_points(qn, idx)
    else:
        M = pix_xyz.shape[1]
        qi_xyz = pix_xyz[:, None].expand(B, N, M, 3)
        qi_norm = qn[:, None].expand(B, N, M, qn.shape[-1])
    xyz = plane_xyz * z
    K = qi_xyz.shape[2]
    diff_cat = torch.cat([xyz[:, :, None].expand(B, N, K, 3), qi_xyz], 3)
    pi_norm = mean_std_normalize(points)[:, :, None]
    corr = pi_norm * qi_norm
    feats = [diff_cat, corr]
    if bval:
        valid = check_valid(xyz)[..., None]
        respond = torch.amax(mask_logits(corr, valid), dim=1, keepdim=True)
        feats.append(respond.expand((B, N) + respond.shape[2:]))
    f1 = mlp(r, f"{name}.mlp1_convs", torch.cat(feats, 3), m1, "stats")
    enc = pointwise(r, f"{name}.pi_encoding", diff_cat, "stats")
    w = mlp(r, f"{name}.mlp2_convs", torch.cat([enc, f1], 3), m2, "stats")
    f1 = torch.sum(softmax(w, 2) * f1, dim=2)

    grid = xyz.reshape(B, H, W, 3)
    S = mc["cost_volume_nsample"]
    args, vmask = window_select(grid, grid, H, W, (1, 1), kernel, S, (1, 1), distance,
                                copy=False)
    wa = (H, W, (1, 1), (1, 1), kernel)
    g_xyz = window_gather(grid, args, *wa)
    g_pts = window_gather(f1.reshape(B, H, W, -1), args, *wa)
    c_xyz = xyz[:, :, None].expand(B, N, S, 3)
    d = g_xyz - c_xyz
    euc = torch.sqrt(torch.sum(d * d, 3, keepdim=True) + 1e-20)
    enc = pointwise(r, f"{name}.pc_encoding", torch.cat([c_xyz, g_xyz, d, euc], 3), "stats")
    w = mlp(r, f"{name}.mlp2_convs_2",
            torch.cat([enc, points[:, :, None].expand(B, N, S, -1), g_pts], -1), m2, "stats")
    return torch.sum(softmax(mask_logits(w, vmask), 2) * g_pts, dim=2)


def proj_upconv(r: Run, name: str, d1, d2, out_h, out_w, stride, kernel, nsample, distance,
                xyz1_raw, xyz2_raw, xyz1, xyz2, feat1, feat2):
    B = xyz1.shape[0]
    N = out_h * out_w
    args, _ = window_select(xyz1, xyz2, out_h, out_w, (1, 1), kernel, nsample, stride, distance,
                            copy=True)
    wa = (out_h, out_w, (1, 1), stride, kernel)
    diff = window_gather(xyz2_raw, args, *wa) - xyz1_raw.reshape(B, N, 1, 3)
    net = torch.cat([window_gather(feat2, args, *wa), diff], 3)
    net = torch.amax(mlp(r, f"{name}.mlp_conv", net, d1, "stats"), dim=2)
    net = torch.cat([net.reshape(B, out_h, out_w, -1), feat1], 3)
    return mlp(r, f"{name}.mlp2_conv", net, d2, "stats").reshape(B, N, -1)


def forward(r: Run, mc: dict, rgb, lidar, intrinsic, lidar_feats, raw_xyz):
    """I2PNetProj: (out3 (B, 7), out4 (B, 7)) as [q, t]."""
    B, H, W, _ = rgb.shape
    Hs = _grid_sizes(mc["init_H"], mc["stride_Hs"])
    Ws = _grid_sizes(mc["init_W"], mc["stride_Ws"])
    sH, sW, ks = mc["stride_Hs"], mc["stride_Ws"], mc["kernel_sizes"]
    ns, mlps, dis = mc["lidar_group_samples"], mc["lidar_encoder_mlps"], mc["down_conv_dis"]
    fpm, upm = mc["flow_predictor_mlps"], mc["setupconv_mlps"]
    RF3 = rgb_encoder(r, mc["rgb_encoder_channels"], rgb)
    h3, w3 = RF3.shape[1:3]
    pix = inverse_intrinsic_grid(intrinsic, h3, w3, H, W)
    RF3_flat = RF3.reshape(B, h3 * w3, -1)

    raw_grid, (xyz_grid,) = spherical_project(raw_xyz, [lidar], mc["init_H"], mc["init_W"],
                                              mc["fup"], mc["fdown"])

    def level(i, name, xr, x, f, depth, nsample, center=False):
        return proj_level(r, name, depth, Hs[i], Ws[i], (sH[i], sW[i]), tuple(ks[i]), nsample,
                          dis[i], xr, x, f, center)

    R1, P1, LF1 = level(0, "lidar_lv1", raw_grid, xyz_grid, None, len(mlps[0]), ns[0], True)
    R2, P2, LF2 = level(1, "lidar_lv2", R1, P1, LF1, len(mlps[1]), ns[1])
    R3, P3, LF3 = level(2, "lidar_lv3", R2, P2, LF2, len(mlps[2]), ns[2])
    R4, P4, LF4 = level(3, "lidar_lv4", R3, P3, LF3, len(mlps[3]), ns[3])

    H3, W3, H4, W4 = Hs[2], Ws[2], Hs[3], Ws[3]
    P3f = P3.reshape(B, H3 * W3, 3)
    LF3f = LF3.reshape(B, H3 * W3, -1)
    z = P3f[:, :, 2:]
    nq, bv = mc["cost_volume_nsamples_q"], mc["backward_validation"]
    cks, cdis = mc["cost_volume_kernel_size"], mc["cost_volume_dis"]
    c4 = proj_cost_volume(r, "cost_volume1", mc, H3, W3, tuple(cks[0]), cdis[0],
                          P3f / (z + 1e-10), LF3f, pix, RF3_flat, z, nsample_q=nq[0], bval=bv[0])
    _, _, l4_pred = level(3, "layer_idx", R3, P3, c4.reshape(B, H3, W3, -1), len(mlps[4]), ns[4])

    LF4f = LF4.reshape(B, H4 * W4, -1)
    l4_pred_f = l4_pred.reshape(B, H4 * W4, -1)
    l4_w = mask_logits(flow_predictor(r, "flow_predictor0", [LF4f, l4_pred_f], len(fpm[0]),
                                      "stats"), check_valid(R4).reshape(B, -1, 1))
    q4, t4 = pose_head(r, "l4_head", l4_pred_f, l4_w)

    uks, udis, uns = mc["up_conv_kernel_size"], mc["up_conv_dis"], mc["setupconv_nsamples"]

    def upconv(i, name, feat2):
        return proj_upconv(r, name, len(upm[i][0]), len(upm[i][1]), H3, W3, (sH[3], sW[3]),
                           tuple(uks[i]), uns[i], udis[i], R3, R4, P3, P4, LF3, feat2)

    l3_w_up = upconv(0, "set_upconv0_w_upsample", l4_w.reshape(B, H4, W4, -1))
    l3_up = upconv(1, "set_upconv0_upsample", l4_pred)

    warped = warp_points(P3f, q4, t4) * check_valid(P3f)
    zw = warped[:, :, 2:]
    c3 = proj_cost_volume(r, "cost_volume2", mc, H3, W3, tuple(cks[1]), cdis[1],
                          warped / (zw + 1e-10), LF3f, pix, RF3_flat, zw, nsample_q=nq[1],
                          bval=bv[1])
    l3_pred = flow_predictor(r, "flow_predictor0_predict", [LF3f, c3, l3_up], len(fpm[1]),
                             "stats")
    l3_w = mask_logits(flow_predictor(r, "flow_predictor0_w", [LF3f, l3_pred, l3_w_up],
                                      len(fpm[2]), "stats"), check_valid(R3).reshape(B, -1, 1))
    q3, t3 = pose_head(r, "l3_head", l3_pred, l3_w)
    q, t = compose_pose(q3, t3, q4, t4)
    return torch.cat([q, t], 1), torch.cat([q4, t4], 1)


def schema(mc: dict):
    """Every weight of the model (``nets.Schema``)."""
    s = Schema(mc, "BatchStatsNorm")
    mlps, fpm, bv = mc["lidar_encoder_mlps"], mc["flow_predictor_mlps"], mc["backward_validation"]

    def level(name, fin, widths):
        s.stack(f"{name}.mlp_convs", fin, widths)

    level("lidar_lv1", 10, mlps[0])
    level("lidar_lv2", 3 + mlps[0][-1], mlps[1])
    level("lidar_lv3", 3 + mlps[1][-1], mlps[2])
    level("lidar_lv4", 3 + s.C3, mlps[3])
    s.cost("cost_volume1", bv[0])
    level("layer_idx", 3 + s.D, mlps[4])
    s.stack("flow_predictor0.mlp_conv", mlps[3][-1] + s.L4, fpm[0])
    s.head("l4_head", s.L4)
    s.upconv("set_upconv0_w_upsample", 0, fpm[0][-1])
    s.upconv("set_upconv0_upsample", 1, s.L4)
    s.cost("cost_volume2", bv[1])
    return s.refined_head()
