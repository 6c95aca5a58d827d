"""Projection-aware I2PNet (port of ``i2pnet_tpu/models/i2pnet_proj.py``).

Large-range registration: the raw cloud (up to 150k points) is rasterised
in the forward into a (init_H, init_W) spherical range image; the LiDAR
pyramid decimates the grid by strides and groups windowed grid neighbours
in place of FPS and KNN; empty cells are masked out of the softmaxes with
-1e10 logits. ``cfg.refine_iters > 1`` re-runs the l3 refinement with
shared weights, warping the l3 points by the previous pass's residual.

At eval every LiDAR level runs the dense route, its multiplicities from the
selection kernel on the card (``ops/select_cuda.py``); in bf16 the RGB
encoder runs the fused eval block kernel (``ops/conv_cuda.py``). The
forward makes no host-device synchronisation, so it can be captured as a
CUDA graph. At eval on the card with grad off, the forward replays its two
segments of plain PyTorch as CUDA graphs of its own (``utils/graphs.py``,
``self.graphs``): ``_cost_volume1`` (the l3 grid against the image) and
``_heads`` (the flow predictors, the l4 head, the upconvs, the l3
refinement and the pose compositions). The kernels' callers stay eager
between them: the RGB encoder, the projection, the LiDAR levels and
``layer_idx``. On a replayed call the ``i2pnet/model/cost_volume`` spans
inside the segments do not open; ``i2pnet/model/graph_replay`` does. In
training (``train/step.py`` ``make_train_step_proj``) the
levels take the gathered route, the heads draw their dropout from the
caller's generator, and in bf16 the RGB encoder runs the train kernels
(``ops/conv_train_cuda.py``), or the native chain under
``I2PNET_FUSED_TRAIN=0``, moving its running statistics by flax's rule.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from i2pnet_tpu_torch.config import I2PNetProjConfig
from i2pnet_tpu_torch.models.i2pnet import change_intrinsic, resolve_device, set_id_grid
from i2pnet_tpu_torch.nn.heads import PoseHead
from i2pnet_tpu_torch.nn.layers import RGBEncoder
from i2pnet_tpu_torch.nn.proj_backbone import (
    ProjCostVolume,
    ProjectPointNet,
    ProjFlowPredictor,
    ProjSetUpconv,
    mask_logits,
)
from i2pnet_tpu_torch.ops import quaternion as Q
from i2pnet_tpu_torch.ops.projection import check_valid, grid_indices, spherical_project
from i2pnet_tpu_torch.utils.graphs import Graphs
from i2pnet_tpu_torch.utils.trace import span

FEATURE_WIDTH = 3  # the lidar_feature width (zeros when none is given)


class I2PNetProj(nn.Module):
    """Projection-aware registration network, built on ``device`` (the CUDA
    card by default; ``device="cpu"`` for the CPU). ``forward`` returns a
    dict with out3 (B,7) refined [q, t], out4 (B,7) coarse, pm3/pm4 None and
    the loss weights sx, sq; with ``eval_info`` also W_l3 (the l3 head's
    softmax weights), P3 (B, H3*W3, 3) and P4 (B, H4*W4, 3)."""

    def __init__(self, cfg: I2PNetProjConfig, eval_info: bool = False, device=None):
        super().__init__()
        self.eval_info = eval_info
        self.graphs = Graphs()
        with torch.device(resolve_device(device)):
            self._build(cfg)

    def _build(self, cfg: I2PNetProjConfig):
        self.cfg = cfg
        dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        Hs, Ws, mlps = cfg.lidar_Hs, cfg.lidar_Ws, cfg.lidar_encoder_mlps
        ns, cvm, fpm, upm = (cfg.lidar_group_samples, cfg.cost_volume_mlps,
                             cfg.flow_predictor_mlps, cfg.setupconv_mlps)
        C3 = mlps[2][-1]
        if cfg.rgb_encoder_channels[-1][1][-1] != C3:
            raise ValueError("the last RGB width must equal lidar_encoder_mlps[2][-1]")
        bn, tr = cfg.use_bn_p, cfg.use_trans

        self.rgb_encoder = RGBEncoder(cfg.rgb_encoder_channels, dt, cfg.encoder_bn_compute_dtype)

        def level(i, nsample, mlp, width):
            return ProjectPointNet(Hs[i], Ws[i], cfg.stride_Hs[i], cfg.stride_Ws[i],
                                   cfg.kernel_sizes[i], nsample, cfg.down_conv_dis[i], mlp,
                                   width, tr, bn, dt)

        lv1_width = 10 + (FEATURE_WIDTH if cfg.using_intens else 0)
        self.lidar_lv1 = level(0, ns[0], mlps[0], lv1_width)
        self.lidar_lv2 = level(1, ns[1], mlps[1], 3 + mlps[0][-1])
        self.lidar_lv3 = level(2, ns[2], mlps[2], 3 + mlps[1][-1])
        self.lidar_lv4 = level(3, ns[3], mlps[3], 3 + C3)

        def cost_volume(i):
            return ProjCostVolume(Hs[2], Ws[2], cfg.cost_volume_kernel_size[i],
                                  cfg.cost_volume_dis[i], cfg.cost_volume_nsample,
                                  cfg.cost_volume_nsamples_q[i], cvm[0], cvm[1], C3,
                                  cfg.backward_validation[i], tr, bn, dt)

        def pose_head(width):
            return PoseHead(width, cfg.head_hidden_dim, cfg.rotation_quat_head_dim,
                            cfg.transition_vec_head_dim, (), (), cfg.mask_sigmoid, cfg.max_head,
                            cfg.head_dropout_rate, cfg.split_dp)

        def upconv(i, feat2_width):
            return ProjSetUpconv(Hs[2], Ws[2], cfg.stride_Hs[3], cfg.stride_Ws[3],
                                 cfg.up_conv_kernel_size[i], cfg.setupconv_nsamples[i],
                                 cfg.up_conv_dis[i], upm[i][0], upm[i][1], feat2_width, C3,
                                 tr, bn, dt)

        D, L4 = cvm[0][-1], mlps[4][-1]
        self.cost_volume1 = cost_volume(0)
        self.layer_idx = level(3, ns[4], mlps[4], 3 + D)
        self.flow_predictor0 = ProjFlowPredictor(mlps[3][-1] + L4, fpm[0], bn, dt)
        self.l4_head = pose_head(L4)
        self.set_upconv0_w_upsample = upconv(0, fpm[0][-1])
        self.set_upconv0_upsample = upconv(1, L4)
        self.cost_volume2 = cost_volume(1)
        self.flow_predictor0_predict = ProjFlowPredictor(
            C3 + D + self.set_upconv0_upsample.out_channels, fpm[1], bn, dt)
        self.flow_predictor0_w = ProjFlowPredictor(
            C3 + fpm[1][-1] + self.set_upconv0_w_upsample.out_channels, fpm[2], bn, dt)
        self.l3_head = pose_head(fpm[1][-1])
        self.sq = nn.Parameter(torch.tensor([cfg.sq_init]))
        self.sx = nn.Parameter(torch.tensor([cfg.sx_init]))

    def forward(self, rgb_img, lidar_xyz, raw_xyz, intrinsic, lidar_feature=None,
                generator: Optional[torch.Generator] = None):
        """rgb_img (B,H,W,3); lidar_xyz (B,N,3) the decalibrated cloud
        (camera frame); raw_xyz (B,N,3) the raw cloud, which sets the range
        image's geometry; intrinsic (B,3,3); lidar_feature (B,N,3) or None.
        Zero points are left out by the projection. ``generator`` feeds the
        heads' dropout in training."""
        cfg = self.cfg
        B, H, W, _ = rgb_img.shape
        rf = cfg.raw_feat_point

        feats0 = lidar_feature
        if feats0 is None:
            feats0 = torch.zeros(B, lidar_xyz.shape[1], FEATURE_WIDTH, dtype=lidar_xyz.dtype,
                                 device=lidar_xyz.device)
        raw_grid, (norm_grid, xyz_grid) = spherical_project(
            raw_xyz, [feats0, lidar_xyz], cfg.init_H, cfg.init_W, cfg.fup, cfg.fdown,
            use_rank=cfg.rank, ref_pad_quirk=cfg.ref_pad_quirk,
        )

        with span("i2pnet/model/lidar_encoder"):
            P1_raw, P1, LF1 = self.lidar_lv1(raw_grid, xyz_grid, norm_grid, center_mode=True,
                                             using_intens=cfg.using_intens, raw_feat_point=rf)
            P2_raw, P2, LF2 = self.lidar_lv2(P1_raw, P1, LF1, raw_feat_point=rf)
            P3_raw, P3, LF3 = self.lidar_lv3(P2_raw, P2, LF2, raw_feat_point=rf)
            P4_raw, P4, LF4 = self.lidar_lv4(P3_raw, P3, LF3, raw_feat_point=rf)

        # the image branch after the LiDAR one: the levels give the card
        # work at once, and the RGB encoder's many small launches are issued
        # while it runs
        with span("i2pnet/model/rgb_encoder"):
            RF3 = self.rgb_encoder(rgb_img)[-1]
        h3, w3 = RF3.shape[1], RF3.shape[2]
        # K^-1 in full f32, without linalg.inv's host-synchronising check
        intrinsic3 = change_intrinsic(intrinsic.float(), (h3, w3), (H, W))
        RF3_index = torch.einsum("bij,bnj->bni", torch.linalg.inv_ex(intrinsic3).inverse,
                                 set_id_grid(h3, w3, B, RF3.device))
        RF3_flat = RF3.reshape(B, h3 * w3, RF3.shape[-1])

        concat_4, = self.graphs.run(self, "cost_volume1", self._cost_volume1, P3_raw, P3, LF3,
                                    RF3_index, RF3_flat)
        _, _, l4_points_predict = self.layer_idx(P3_raw, P3, concat_4, raw_feat_point=rf)
        out3, out4, W_l3 = self.graphs.run(
            self, "heads", lambda *a: self._heads(*a, generator=generator), P3_raw, P3, LF3,
            P4_raw, P4, LF4, l4_points_predict, RF3_index, RF3_flat)

        out = {"out3": out3, "out4": out4, "pm3": None, "pm4": None, "sx": self.sx, "sq": self.sq}
        if self.eval_info:
            out.update(W_l3=W_l3, P3=P3.reshape(B, -1, 3), P4=P4.reshape(B, -1, 3))
        return out

    # The two segments of plain PyTorch around ``layer_idx`` (its dense
    # route launches the selection kernel): each is one CUDA graph at eval
    # on the card (``utils/graphs.py``).

    def _cost_volume1(self, P3_raw, P3, LF3, RF3_index, RF3_flat):
        """(concat_4,): the l3 grid against the image at the initial pose."""
        B, H3, W3 = P3.shape[0], self.cfg.lidar_Hs[2], self.cfg.lidar_Ws[2]
        P3_l4 = P3.reshape(B, H3 * W3, 3)
        LF3_flat = LF3.reshape(B, H3 * W3, -1)
        l3_idx_n2 = grid_indices(B, H3, W3, P3.device)
        lidar_z = P3_l4[:, :, 2:]
        lidar_uv = P3_l4 / (lidar_z + 1e-10)

        with span("i2pnet/model/cost_volume"):
            concat_4 = self.cost_volume1(P3_raw, lidar_uv, LF3_flat, l3_idx_n2, RF3_index,
                                         RF3_flat, lidar_z)
        return (concat_4,)

    def _heads(self, P3_raw, P3, LF3, P4_raw, P4, LF4, l4_points_predict, RF3_index, RF3_flat,
               generator=None):
        """(out3, out4, W_l3): the l4 head, the upconvs and the l3
        refinement (``refine_iters`` passes), out3 and out4 in f32."""
        cfg = self.cfg
        B = P3.shape[0]
        H3, W3, H4, W4 = cfg.lidar_Hs[2], cfg.lidar_Ws[2], cfg.lidar_Hs[3], cfg.lidar_Ws[3]
        rf = cfg.raw_feat_point
        P3_l4 = P3.reshape(B, H3 * W3, 3)
        LF3_flat = LF3.reshape(B, H3 * W3, -1)
        l3_idx_n2 = grid_indices(B, H3, W3, P3.device)

        l4_valid = check_valid(P4_raw).reshape(B, -1, 1)
        LF4_flat = LF4.reshape(B, H4 * W4, -1)
        l4_pred_flat = l4_points_predict.reshape(B, H4 * W4, -1)
        l4_cost_volume_w = mask_logits(self.flow_predictor0(LF4_flat, None, l4_pred_flat),
                                        l4_valid)
        q4, t4, _ = self.l4_head(l4_pred_flat, l4_cost_volume_w, P4.reshape(B, H4 * W4, 3),
                                 LF4_flat, generator=generator)
        out4 = torch.cat([q4, t4], dim=1)

        # the upsampled embedding and mask, outside the refinement loop
        l3_cv_w_up = self.set_upconv0_w_upsample(
            P3_raw, P4_raw, P3, P4, LF3, l4_cost_volume_w.reshape(B, H4, W4, -1),
            raw_feat_point=rf)
        l3_cv_up = self.set_upconv0_upsample(P3_raw, P4_raw, P3, P4, LF3, l4_points_predict,
                                              raw_feat_point=rf)

        l3_nowarp_valid = check_valid(P3_l4)
        valid_mask_l3 = check_valid(P3_raw).reshape(B, -1, 1)
        q_iter, t_iter = q4, t4
        for _ in range(max(cfg.refine_iters, 1)):
            P3_warped = Q.warp_points(P3_l4, q_iter, t_iter) * l3_nowarp_valid
            z_w = P3_warped[:, :, 2:]
            uv_w = P3_warped / (z_w + 1e-10)
            with span("i2pnet/model/cost_volume"):
                concat_3 = self.cost_volume2(P3_raw, uv_w, LF3_flat, l3_idx_n2, RF3_index,
                                             RF3_flat, z_w)
            l3_cv_predict = self.flow_predictor0_predict(
                LF3_flat, l3_cv_up, concat_3.reshape(B, H3 * W3, -1))
            l3_cv_w = mask_logits(self.flow_predictor0_w(LF3_flat, l3_cv_w_up, l3_cv_predict),
                                   valid_mask_l3)
            q3, t3, W_l3 = self.l3_head(l3_cv_predict, l3_cv_w, P3_warped, LF3_flat,
                                        generator=generator)
            q, t = Q.compose_pose(q3, t3, q_iter, t_iter)
            q_iter, t_iter = q3, t3  # the next pass warps by the raw residual
        out3 = torch.cat([q, t], dim=1)
        return out3.float(), out4.float(), W_l3
