"""Free-point I2PNet (port of ``i2pnet_tpu/models/i2pnet.py``), eval and
train forward.

Coarse-to-fine 2D-3D registration: RGB pyramid + PointNet++ pyramid ->
cost volume at l3 -> resample to l4 -> coarse pose (q4, t4) -> warp l3
points -> second cost volume -> upconv refinement -> residual pose (q3, t3)
-> compose. Channels-last throughout. ``model.train()`` selects the train
forward (batch-statistics BatchNorm with running-stat updates, head
dropout), ``model.eval()`` the eval one, as flax's ``train`` flag.

Two optional branches. efgh (online calibration): every projection goes
through a per-sample calibration matrix scaled to the feature grid, so the
LiDAR uv and the raw pixel grid share the feature-pixel frame. Projection
masks: a classifier head at l4 and/or l3 (``ProjectMask``) whose mask, or
the in-frustum labels ``gt_project`` subsampled through the FPS levels, or
a ``delay_weight`` mix of the two, gates the pose heads' pooling; the
masks come back as pm3/pm4 for the mask loss.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from i2pnet_tpu_torch.config import I2PNetConfig
from i2pnet_tpu_torch.losses import get_projection_gt
from i2pnet_tpu_torch.nn.costvolume import CostVolume
from i2pnet_tpu_torch.nn.heads import FlowPredictor, PoseHead, ProjectMask, delay_weight
from i2pnet_tpu_torch.nn.layers import BatchNorm, BatchStatsNorm, RGBEncoder
from i2pnet_tpu_torch.nn.pointnet import PointNetSetAbstraction
from i2pnet_tpu_torch.nn.upconv import SetUpconv
from i2pnet_tpu_torch.ops import quaternion as Q
from i2pnet_tpu_torch.ops.pointops import index_points
from i2pnet_tpu_torch.utils.trace import span


def set_id_grid(h: int, w: int, batch: int, device=None) -> torch.Tensor:
    """Homogeneous pixel grid (B, H*W, 3) as (u=j, v=i, 1)."""
    i = torch.arange(h, dtype=torch.float32, device=device)
    j = torch.arange(w, dtype=torch.float32, device=device)
    ii, jj = torch.meshgrid(i, j, indexing="ij")
    grid = torch.stack([jj, ii, torch.ones_like(jj)], dim=-1).reshape(1, h * w, 3)
    return grid.expand(batch, h * w, 3)


def change_intrinsic(intrinsic: torch.Tensor, feat_hw, img_hw) -> torch.Tensor:
    """Rescale K (B, 3, 3) to a downsampled feature grid."""
    sx = feat_hw[1] / img_hw[1]
    sy = feat_hw[0] / img_hw[0]
    # filled on the device: a tensor from a host list would be a
    # synchronising host-to-device copy
    scale = torch.ones(3, 3, dtype=intrinsic.dtype, device=intrinsic.device)
    scale[0, 0::2].fill_(sx)
    scale[1, 1:].fill_(sy)
    return intrinsic * scale


def _feat_in(featmode: Optional[str]) -> int:
    # grouped feature width of the first SA level; featmode None groups
    # [xyz_diff(3), lidar_feature(3)]
    return {"dim10feat": 10, "dist": 1}.get(featmode, 6)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one that raises (the CPU runs
    only when asked for, ``device="cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    return device


class I2PNet(nn.Module):
    """Free-point registration network, built on ``device`` (the CUDA card
    by default; ``device="cpu"`` for the CPU). ``forward`` returns a dict
    with out3 (B,7) refined [q, t], out4 (B,7) coarse, the loss weights
    sx, sq, and pm3/pm4: (mask, points, subsampled gt_project or None) of
    the l3/l4 mask heads, or None."""

    def __init__(self, cfg: I2PNetConfig, device=None):
        super().__init__()
        with torch.device(resolve_device(device)):
            self._build(cfg)

    def _build(self, cfg: I2PNetConfig):
        if cfg.efgh and (cfg.use_projection_mask or cfg.ground_truth_projection_mask
                         or cfg.ground_truth_projection_mask_eval):
            raise ValueError("efgh and projection masks are exclusive")
        self.cfg = cfg
        dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        mlps, pts, ns = cfg.lidar_encoder_mlps, cfg.lidar_layer_points, cfg.lidar_group_samples
        cvm, fpm, upm = cfg.cost_volume_mlps, cfg.flow_predictor_mlps, cfg.setupconv_mlps
        C3 = mlps[2][-1]
        if cfg.rgb_encoder_channels[-1][1][-1] != C3:
            raise ValueError("the last RGB width must equal lidar_encoder_mlps[2][-1]")

        self.rgb_encoder = RGBEncoder(cfg.rgb_encoder_channels, dt, cfg.encoder_bn_compute_dtype)
        self.lidar_lv1 = PointNetSetAbstraction(pts[0], ns[0], mlps[0], _feat_in(cfg.featmode), dt)
        self.lidar_lv2 = PointNetSetAbstraction(pts[1], ns[1], mlps[1], 3 + mlps[0][-1], dt)
        self.lidar_lv3 = PointNetSetAbstraction(pts[2], ns[2], mlps[2], 3 + mlps[1][-1], dt)
        self.lidar_lv4 = PointNetSetAbstraction(pts[3], ns[3], mlps[3], 3 + C3, dt)

        def cost_volume(i):
            return CostVolume(
                cfg.cost_volume_nsample, cfg.cost_volume_nsamples_q[i], cvm[0], cvm[1], C3,
                cfg.cost_volume_corr_func, cfg.backward_validation[i], cfg.max_cost,
                cfg.backward_fc, dt,
            )

        def pose_head(i, width, mask_width, feature_width):
            return PoseHead(
                width, cfg.head_hidden_dim, cfg.rotation_quat_head_dim,
                cfg.transition_vec_head_dim, cfg.pose_head_mlps[i][0], cfg.pose_head_mlps[i][1],
                cfg.mask_sigmoid, cfg.max_head, cfg.head_dropout_rate, cfg.split_dp,
                cfg.head_corr_func, cfg.head_pos_embedding, mask_width, feature_width,
            )

        def project_mask(i, width):
            if cfg.use_projection_mask and cfg.layer_mask[i]:
                return ProjectMask(width, cfg.projection_mask_mlps[i], cfg.mask_sigmoid)
            return None

        D = cvm[0][-1]  # cost-volume output width
        L4 = mlps[4][-1]  # resampled cost-volume width
        self.cost_volume1 = cost_volume(0)
        self.layer_idx = PointNetSetAbstraction(pts[3], ns[4], mlps[4], 3 + D, dt)
        self.flow_predictor0 = FlowPredictor(mlps[3][-1] + L4, fpm[0], dt)
        self.l4_projection_mask = project_mask(0, mlps[3][-1] + L4)
        self.l4_head = pose_head(0, L4, fpm[0][-1], mlps[3][-1])
        self.cost_volume2 = cost_volume(1)
        self.set_upconv0_w_upsample = SetUpconv(
            cfg.setupconv_nsamples[0], upm[0][0], upm[0][1], fpm[0][-1], C3, dt)
        self.set_upconv0_upsample = SetUpconv(
            cfg.setupconv_nsamples[1], upm[1][0], upm[1][1], L4, C3, dt)
        self.flow_predictor0_predict = FlowPredictor(
            C3 + D + self.set_upconv0_upsample.out_channels, fpm[1], dt)
        self.flow_predictor0_w = FlowPredictor(
            C3 + fpm[1][-1] + self.set_upconv0_w_upsample.out_channels, fpm[2], dt)
        self.l3_projection_mask = project_mask(1, C3 + fpm[1][-1])
        self.l3_head = pose_head(1, fpm[1][-1], fpm[2][-1], C3)
        self.sq = nn.Parameter(torch.tensor([cfg.sq_init]))
        self.sx = nn.Parameter(torch.tensor([cfg.sx_init]))

    def forward(self, rgb_img, lidar_xyz, intrinsic, lidar_feature=None, raw_xyz=None,
                gt_project=None, now_step=None, calib=None,
                generator: Optional[torch.Generator] = None):
        """rgb_img (B,H,W,3); lidar_xyz (B,N,3) camera-frame points (under
        efgh, in the frame calib projects from); intrinsic (B,3,3); optional lidar_feature (B,N,3)
        and raw_xyz (B,N,3); gt_project (B,N,2) one-hot in-frustum labels;
        now_step, the delay counter (a tensor; ``cfg.mask_delay_step``
        when None); calib (B,3or4,4), the projection matrix efgh needs;
        ``generator`` (on the model's device) feeds the heads' dropout in
        training."""
        cfg = self.cfg
        B, H, W, _ = rgb_img.shape
        if cfg.efgh and calib is None:
            raise ValueError("cfg.efgh=True requires the calib input")
        if cfg.raw_feat_point and raw_xyz is None:
            raw_xyz = lidar_xyz

        with span("i2pnet/model/rgb_encoder"):
            RF3 = self.rgb_encoder(rgb_img)[-1]
        h3, w3 = RF3.shape[1], RF3.shape[2]

        feats0 = lidar_feature
        if feats0 is None:
            feats0 = torch.zeros(B, lidar_xyz.shape[1], 3, dtype=lidar_xyz.dtype,
                                 device=lidar_xyz.device)
        with span("i2pnet/model/lidar_encoder"):
            P1, LF1, fps1, P1_raw = self.lidar_lv1(lidar_xyz, feats0, feat_mode=cfg.featmode,
                                                   raw_xyz=raw_xyz)
            P2, LF2, fps2, P2_raw = self.lidar_lv2(P1, LF1, raw_xyz=P1_raw)
            P3, LF3, fps3, P3_raw = self.lidar_lv3(P2, LF2, raw_xyz=P2_raw)
            P4, LF4, fps4, P4_raw = self.lidar_lv4(P3, LF3, raw_xyz=P3_raw)

        calib3 = None
        if cfg.efgh:
            # the projection matrix scaled to the feature grid as K is (row 0
            # by w3/W, row 1 by h3/H), in f32: the LiDAR uv and the raw
            # pixel grid (u, v, 1) then share the feature-pixel frame
            c = calib[:, :3, :].float()
            calib3 = torch.cat([c[:, 0:1] * (w3 / W), c[:, 1:2] * (h3 / H), c[:, 2:3]], dim=1)
            RF3_index = set_id_grid(h3, w3, B, RF3.device)
            lidar_uv, lidar_z = Q.project_with_calib(P3, calib3)
        else:
            # pixel grid to the normalized camera plane: K^-1 in full f32.
            # Like jnp.linalg.inv, no singularity check: torch.linalg.inv's
            # check reads a device flag on the host, a synchronisation per
            # forward
            intrinsic3 = change_intrinsic(intrinsic.float(), (h3, w3), (H, W))
            RF3_index = torch.einsum(
                "bij,bnj->bni", torch.linalg.inv_ex(intrinsic3).inverse,
                set_id_grid(h3, w3, B, RF3.device),
            )
            lidar_uv, lidar_z = Q.project_to_normalized_plane(P3)
        RF3_flat = RF3.reshape(B, h3 * w3, RF3.shape[-1])

        with span("i2pnet/model/cost_volume"):
            concat_4 = self.cost_volume1(lidar_uv, LF3, RF3_index, RF3_flat, lidar_z)
        _, l4_points_predict, _, _ = self.layer_idx(P3, concat_4, sample_idx=fps4, raw_xyz=P3_raw)
        l4_cost_volume_w = self.flow_predictor0(LF4, None, l4_points_predict)

        gt_l3 = gt_l4 = None
        if gt_project is not None:
            gt_l3 = index_points(index_points(index_points(gt_project, fps1), fps2), fps3)
            gt_l4 = index_points(gt_l3, fps4)

        def mask_for_head(level, pred, gt):
            if gt_project is None or not cfg.ground_truth_mask_layer[level]:
                return pred
            step = now_step
            if step is None:  # a fresh model's counter (filled on the device)
                step = torch.full((), float(cfg.mask_delay_step), device=gt.device)
            return delay_weight(gt, pred, step, cfg.mask_delay_step, cfg.ab_delay)

        l4_projection_mask = None
        if self.l4_projection_mask is not None:
            l4_projection_mask = self.l4_projection_mask(LF4, l4_points_predict)
        q4, t4, _ = self.l4_head(l4_points_predict, l4_cost_volume_w, P4, LF4,
                                 mask_for_head(0, l4_projection_mask, gt_l4), generator=generator)
        out4 = torch.cat([q4, t4], dim=1)

        if cfg.efgh:
            warped_uv, warped_z = Q.warp_with_calib(P3, q4, t4, calib3)
        else:
            warped_uv, warped_z = Q.warp_to_normalized_plane(P3, q4, t4)
        with span("i2pnet/model/cost_volume"):
            concat_3 = self.cost_volume2(warped_uv, LF3, RF3_index, RF3_flat, warped_z)

        raw = dict(raw_xyz1=P3_raw, raw_xyz2=P4_raw) if cfg.raw_feat_point else {}
        l3_w_up = self.set_upconv0_w_upsample(P3, P4, LF3, l4_cost_volume_w, **raw)
        l3_up = self.set_upconv0_upsample(P3, P4, LF3, l4_points_predict, **raw)
        l3_cost_volume_predict = self.flow_predictor0_predict(LF3, l3_up, concat_3)
        l3_cost_volume_w = self.flow_predictor0_w(LF3, l3_w_up, l3_cost_volume_predict)

        l3_prediction_mask = None
        if self.l3_projection_mask is not None:
            l3_prediction_mask = self.l3_projection_mask(LF3, l3_cost_volume_predict)
        l3_mask_for_head = mask_for_head(1, l3_prediction_mask, gt_l3)
        if not cfg.layer_mask[1] and cfg.ground_truth_mask_layer[1] and gt_project is None:
            # eval-time fallback of a gt-mask-trained model: the labels from
            # the coarse pose stand in for the l3 mask, and come back as pm3
            labels = get_projection_gt(P3, intrinsic, (H, W), q4, t4)
            l3_prediction_mask = F.one_hot(labels.long(), 2).float()
            l3_mask_for_head = l3_prediction_mask
        q3, t3, _ = self.l3_head(l3_cost_volume_predict, l3_cost_volume_w, P3, LF3,
                                 l3_mask_for_head, generator=generator)

        q, t = Q.compose_pose(q3, t3, q4, t4)
        out3 = torch.cat([q, t], dim=1)
        pm3 = (l3_prediction_mask, P3, gt_l3) if l3_prediction_mask is not None else None
        pm4 = None
        if l4_projection_mask is not None and not cfg.one_head_mask:
            pm4 = (l4_projection_mask, P4, gt_l4)
        return {"out3": out3.float(), "out4": out4.float(), "pm3": pm3, "pm4": pm4,
                "sx": self.sx, "sq": self.sq}


# flax's lecun_normal: a normal truncated at 2 std, widened so that the
# truncated draw keeps a variance of 1 / fan_in
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_flax_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh weights from ``generator`` with the distribution the JAX
    package's models start training from (flax's defaults): Dense and Conv
    kernels lecun-normal (truncated at 2 std, variance 1 / fan_in), their
    biases 0; every norm's scale 1 and shift 0, running mean 0 and
    variance 1; sq and sx from the config. Draws on the CPU, in module
    order, so a seed gives the same weights on any device."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            w = module.weight
            std = w[0].numel() ** -0.5 / _TRUNCATED_STD
            w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), 0.0, std, -2 * std, 2 * std,
                                          generator=generator))
            module.bias.zero_()
        elif isinstance(module, (BatchNorm, BatchStatsNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
            if isinstance(module, BatchNorm):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
    return model


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill a model's weights from ``generator``: Dense/Conv weights
    lecun-normal, their biases, every BatchNorm's affine and running
    statistics and every BatchStatsNorm's affine drawn near their neutral
    values so the eval folds are exercised. Draws on the CPU, in module
    order, so a seed gives the same weights on any device."""
    for module in model.modules():
        if isinstance(module, (BatchNorm, BatchStatsNorm)):
            n = module.weight.numel()
            module.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=generator))
            module.bias.copy_(0.1 * torch.randn(n, generator=generator))
        if isinstance(module, BatchNorm):
            module.running_mean.copy_(0.1 * torch.randn(n, generator=generator))
            module.running_var.copy_(0.5 + torch.rand(n, generator=generator))
        elif isinstance(module, (nn.Linear, nn.Conv2d)):
            w = module.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator) / fan_in**0.5)
            module.bias.copy_(0.1 * torch.randn(module.bias.shape, generator=generator))
    return model
