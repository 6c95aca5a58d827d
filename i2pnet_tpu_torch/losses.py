"""Training losses (port of ``i2pnet_tpu/losses.py``).

Plain tensor functions, usable inside the train step. The JAX package's
f32 "HIGHEST" einsums are full-f32 products here: PyTorch keeps float32
matmuls in full precision unless TF32 is switched on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from i2pnet_tpu_torch.ops import quaternion as Q


def get_projection_gt(pcl, K, img_size: Tuple[int, int], decalib_q, decalib_t) -> torch.Tensor:
    """Per-point in-frustum labels: pcl (B,N,3), K (B,3,3), img_size (H, W)
    -> int32 (B,N) in {0, 1}."""
    E = Q.pose_to_matrix(decalib_q, decalib_t)  # (B,3,4)
    cam = torch.einsum("bij,bnj->bni", E[:, :, :3], pcl) + E[:, None, :, 3]
    uvw = torch.einsum("bij,bnj->bni", K.to(cam.dtype), cam)
    z = uvw[..., 2]
    uv = uvw / (z[..., None] + 1e-10)
    u, v = uv[..., 0], uv[..., 1]
    inliers = (u >= 0) & (u <= img_size[1]) & (v >= 0) & (v <= img_size[0]) & (z >= 0.1)
    return inliers.to(torch.int32)


def focal_loss(pred: torch.Tensor, gt: torch.Tensor, gamma: float) -> torch.Tensor:
    """Focal CE, the mean over points: pred (M, C) logits, gt (M,) labels."""
    log_p = F.log_softmax(pred, dim=-1)
    onehot = F.one_hot(gt.long(), pred.shape[-1]).to(pred.dtype)
    ce = -torch.sum(onehot * log_p, dim=-1)
    target_p = torch.sum(F.softmax(pred, dim=-1) * onehot, dim=-1)
    return torch.mean((1.0 - target_p) ** gamma * ce)


def projection_mask_loss(pm: Optional[tuple], intrinsic, img_size: Tuple[int, int], decalib_q,
                         decalib_t, focal: bool = True, focal_gamma: float = 2.0,
                         sigmoid: bool = False) -> Optional[torch.Tensor]:
    """Mask CE / focal / BCE loss. pm = (pred logits (B,N,2|1), points
    (B,N,3)[, gt one-hot (B,N,2)]); None gives None."""
    if pm is None:
        return None
    if len(pm) >= 3 and pm[2] is not None:
        l_gt = torch.argmax(pm[2].detach(), dim=-1)
    else:
        l_gt = get_projection_gt(pm[1], intrinsic, img_size, decalib_q, decalib_t).detach()
    pred = pm[0]
    if sigmoid:
        p = torch.clamp(pred.reshape(-1), 1e-7, 1 - 1e-7)
        y = l_gt.reshape(-1).to(p.dtype)
        return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    pred2 = pred.reshape(-1, 2)
    gt1 = l_gt.reshape(-1).long()
    if focal:
        return focal_loss(pred2, gt1, focal_gamma)
    log_p = F.log_softmax(pred2, dim=-1)
    return -torch.mean(torch.gather(log_p, 1, gt1[:, None]))


def registration_loss(out3, out4, q_gt, t_gt, sx, sq, l1_trans: bool = True):
    """Two-level pose loss with learned homoscedastic weights: out3/out4
    (B, 7) [q, t] -> (loss_sum, quat_loss, trans_loss); 1.6 on the coarse
    (out4) level and 0.8 on the refined (out3) one, as the JAX package."""

    def level_loss(out):
        q_pred, t_pred = out[:, :4], out[:, 4:]
        loss_q = torch.mean(torch.sqrt(torch.sum((q_gt - q_pred) ** 2, dim=-1) + 1e-10))
        if l1_trans:
            loss_x = torch.mean(torch.abs(t_pred - t_gt))
        else:
            loss_x = torch.mean(torch.sqrt(torch.sum((t_pred - t_gt) ** 2, dim=-1) + 1e-10))
        return loss_q, loss_x

    sx = sx.reshape(())
    sq = sq.reshape(())
    l2_loss_q, l2_loss_x = level_loss(out3)
    l3_loss_q, l3_loss_x = level_loss(out4)
    l3 = l3_loss_x * torch.exp(-sx) + sx + l3_loss_q * torch.exp(-sq) + sq
    l2 = l2_loss_x * torch.exp(-sx) + sx + l2_loss_q * torch.exp(-sq) + sq
    loss_sum = 1.6 * l3 + 0.8 * l2
    real_loss = 1.6 * l3_loss_q + 0.8 * l2_loss_q
    dual_loss = 1.6 * l3_loss_x + 0.8 * l2_loss_x
    return loss_sum, real_loss, dual_loss


def pointwise_reprojection_loss(p, intrinsic, img_size: Tuple[int, int], out3, out4, decalib_q,
                                decalib_t) -> torch.Tensor:
    """Reprojection L1 over the in-frustum points."""
    p_projected = get_projection_gt(p, intrinsic, img_size, decalib_q, decalib_t).float()
    K = intrinsic.float()

    def project(q, t):
        E = Q.pose_to_matrix(q, t)
        cam = torch.einsum("bij,bnj->bni", E[:, :, :3], p) + E[:, None, :, 3]
        uvw = torch.einsum("bij,bnj->bni", K, cam)
        return uvw[..., :2] / (uvw[..., 2:] + 1e-10)

    p_gt = project(decalib_q, decalib_t)
    p3 = project(out3[:, :4], out3[:, 4:])
    p4 = project(out4[:, :4], out4[:, 4:])
    denom = torch.sum(p_projected) + 1e-10
    l3 = torch.sum(torch.sum(torch.abs(p3 - p_gt), -1) * p_projected) / denom
    l4 = torch.sum(torch.sum(torch.abs(p4 - p_gt), -1) * p_projected) / denom
    return 1.6 * l3 + 0.8 * l4


def rt_loss(gt_q, gt_t, R3, t3, R4, t4, sq, sx):
    """Rotation-matrix variant -> (real, dual, loss)."""
    gt_R = Q.quat_to_rotmat(gt_q)
    eye = torch.eye(3, dtype=R3.dtype, device=R3.device)

    def one(Rp):
        err = torch.einsum("bji,bjk->bik", gt_R, Rp) - eye
        return torch.mean(torch.sum(err**2, dim=(1, 2)))

    real = 1.6 * one(R4) + 0.8 * one(R3)
    dual = 1.6 * torch.mean(torch.abs(gt_t - t4)) + 0.8 * torch.mean(torch.abs(gt_t - t3))
    loss = torch.exp(-sq) * real + sq + torch.exp(-sx) * dual + sx
    return real, dual, loss
