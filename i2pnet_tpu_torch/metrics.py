"""Evaluation metrics (port of ``i2pnet_tpu/metrics.py``).

Host-side (numpy/scipy) implementations of the eval protocol: extrinsic
composition, per-axis calibration errors, RTE/RRE with recall thresholds,
mask accuracy, and the SE(3) geodesic MSEE/MRR. The Lie maps run in the
port's ``ops/se3.py`` on f32 CPU tensors, as the JAX package runs its own
in f32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

import torch

from i2pnet_tpu_torch.ops import se3 as lie


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def quat_to_rotmat_batch(q: np.ndarray) -> np.ndarray:
    """[B,4] -> [B,3,3] (ref metric.py:9-34)."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = np.stack(
        [
            1 - 2 * y**2 - 2 * z**2,
            2 * x * y - 2 * z * w,
            2 * x * z + 2 * y * w,
            2 * x * y + 2 * z * w,
            1 - 2 * x**2 - 2 * z**2,
            2 * y * z - 2 * x * w,
            2 * x * z - 2 * y * w,
            2 * y * z + 2 * x * w,
            1 - 2 * x**2 - 2 * y**2,
        ],
        axis=-1,
    )
    return r.reshape(-1, 3, 3)


def mult_extrinsic_batch(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """[B,3,4] @ [B,3,4] -> [B,3,4] (ref metric.py:37-50)."""
    B = m1.shape[0]
    pad = np.tile(np.array([[[0.0, 0, 0, 1]]]), (B, 1, 1))
    return (np.concatenate([m1, pad], 1) @ np.concatenate([m2, pad], 1))[:, :3, :]


def inv_extrinsic(m: np.ndarray) -> np.ndarray:
    """[B,3,4] -> [B,3,4] inverse (ref metric.py:53-57)."""
    B = m.shape[0]
    pad = np.tile(np.array([[[0.0, 0, 0, 1]]]), (B, 1, 1))
    return np.linalg.inv(np.concatenate([m, pad], 1))[:, :3, :]


def rotmat_to_euler(rotmat: np.ndarray, out: str = "rad") -> np.ndarray:
    """XYZ euler with singular fallback (ref metric.py:60-85)."""
    sy = np.sqrt(rotmat[:, 0, 0] ** 2 + rotmat[:, 1, 0] ** 2)
    singular = sy < 1e-6
    ns = ~singular
    roll = np.empty_like(sy)
    pitch = np.empty_like(sy)
    yaw = np.empty_like(sy)
    roll[ns] = np.arctan2(rotmat[ns, 2, 1], rotmat[ns, 2, 2])
    pitch[ns] = np.arctan2(-rotmat[ns, 2, 0], sy[ns])
    yaw[ns] = np.arctan2(rotmat[ns, 1, 0], rotmat[ns, 0, 0])
    roll[singular] = np.arctan2(-rotmat[singular, 1, 2], rotmat[singular, 1, 1])
    pitch[singular] = np.arctan2(-rotmat[singular, 2, 0], sy[singular])
    yaw[singular] = 0
    euler = np.stack([roll, pitch, yaw], -1)
    return euler if out == "rad" else euler * 180.0 / np.pi


def calibration_error_batch(e1: np.ndarray, e2: np.ndarray):
    """Per-axis |roll,pitch,yaw| (deg) and |x,y,z| errors
    (ref metric.py:88-100)."""
    err = mult_extrinsic_batch(inv_extrinsic(e1), e2)
    euler = np.abs(rotmat_to_euler(err[:, :3, :3], out="deg"))
    trans = np.abs(err[:, :3, 3])
    return euler[:, 0], euler[:, 1], euler[:, 2], trans[:, 0], trans[:, 1], trans[:, 2]


def get_extrinsic(
    out3: np.ndarray,
    decalib_q_gt: np.ndarray,
    decalib_t_gt: np.ndarray,
    init_extrinsic: np.ndarray,
    out_raw: bool = False,
):
    """Compose predicted/gt decalibrations with the initial extrinsic
    (ref metric.py:103-123 getExtrinsic)."""
    pred_R = quat_to_rotmat_batch(out3[:, :4])
    pred_E = np.concatenate([pred_R, out3[:, 4:].reshape(-1, 3, 1)], axis=-1)
    pred_extrinsic = mult_extrinsic_batch(pred_E, init_extrinsic)
    gt_R = quat_to_rotmat_batch(decalib_q_gt)
    gt_E = np.concatenate([gt_R, decalib_t_gt.reshape(-1, 3, 1)], axis=-1)
    gt_extrinsic = mult_extrinsic_batch(gt_E, init_extrinsic)
    if out_raw:
        return pred_extrinsic, gt_extrinsic, pred_E, gt_E
    return pred_extrinsic, gt_extrinsic


def rte_rre(pred_extrinsic: np.ndarray, gt_extrinsic: np.ndarray):
    """RTE = ||t(inv(pred) gt)||_2; RRE = sum |euler_xzy| in deg
    (ref metric.py:226-259 RteRreEval.addBatch)."""
    P_diff = mult_extrinsic_batch(inv_extrinsic(pred_extrinsic), gt_extrinsic)
    t_diff = np.linalg.norm(P_diff[:, :3, 3], 2, -1)
    R_diff = Rotation.from_matrix(P_diff[:, :3, :3])
    angles_diff = np.sum(np.abs(R_diff.as_euler("xzy", degrees=True)), -1)
    return angles_diff, t_diff


def cal_rete_once(
    out3: np.ndarray, decalib_q_gt: np.ndarray, decalib_t_gt: np.ndarray
):
    """Mean RRE/RTE of raw decalib predictions (ref metric.py:125-147)."""
    pred_R = quat_to_rotmat_batch(out3[:, :4])
    pred = np.concatenate([pred_R, out3[:, 4:].reshape(-1, 3, 1)], -1)
    gt_R = quat_to_rotmat_batch(decalib_q_gt)
    gt = np.concatenate([gt_R, decalib_t_gt.reshape(-1, 3, 1)], -1)
    rre, rte = rte_rre(pred, gt)
    return rre.mean(), rte.mean()


class RteRreEval:
    """Streaming RTE/RRE with optional recall thresholds
    (ref metric.py:205-273)."""

    def __init__(self, threshold: bool = False, rre_th: float = 10.0, rte_th: float = 5.0):
        self.t_diff: list = []
        self.r_diff: list = []
        self.t_diff_all: list = []
        self.r_diff_all: list = []
        self.threshold = threshold
        self.rre_th = rre_th
        self.rte_th = rte_th
        self.acc_count = 0
        self.all_count = 0

    def reset(self):
        self.t_diff.clear()
        self.r_diff.clear()
        self.acc_count = 0
        self.all_count = 0

    def get_recall(self) -> float:
        return self.acc_count / self.all_count

    def add_batch(self, pred_extrinsic: np.ndarray, gt_extrinsic: np.ndarray):
        angles_diff, t_diff = rte_rre(pred_extrinsic, gt_extrinsic)
        self.all_count += len(angles_diff)
        if self.threshold:
            mask = np.logical_and(t_diff < self.rte_th, angles_diff < self.rre_th)
            self.acc_count += int(mask.sum())
            self.t_diff.extend(t_diff[mask].tolist())
            self.r_diff.extend(angles_diff[mask].tolist())
        else:
            self.acc_count += len(angles_diff)
            self.t_diff.extend(t_diff.tolist())
            self.r_diff.extend(angles_diff.tolist())
        self.t_diff_all.extend(t_diff.tolist())
        self.r_diff_all.extend(angles_diff.tolist())
        return angles_diff.tolist(), t_diff.tolist()

    def eval_seq(self) -> Tuple[float, float, float, float]:
        t = np.array(self.t_diff)
        r = np.array(self.r_diff)
        return t.mean(), math.sqrt(np.var(t)), r.mean(), math.sqrt(np.var(r))

    def save_metric(self, path: str):
        np.savez(path, RRE=np.array(self.r_diff_all), RTE=np.array(self.t_diff_all))


def eval_acc(
    pred_logits: np.ndarray, l_gt: np.ndarray, sigmoid: bool = False
) -> np.ndarray:
    """Projection-mask accuracy (ref metric.py:167-179)."""
    if sigmoid:
        pred = (pred_logits.squeeze(-1) >= 0.5).astype(np.int64)
    else:
        pred = pred_logits.argmax(-1)
    N = pred.shape[1]
    err = np.abs(pred - l_gt).sum(-1)
    return 1.0 - err.astype(np.float64) / N


def extrinsic_to_se3(E: np.ndarray) -> np.ndarray:
    """[B,3,4] -> se3 [B,6] (rot, trans) (ref MSEE.py:8-15 SE3_to_se3)."""
    B = E.shape[0]
    pad = np.tile(np.array([[[0.0, 0, 0, 1]]]), (B, 1, 1))
    T = np.concatenate([E, pad], axis=1)
    return lie.se3_log(_f32(T)).numpy()


def eval_msee(
    out3: np.ndarray, gt_se3: np.ndarray, pred_E: np.ndarray = None
) -> np.ndarray:
    """Mean squared SE(3) geodesic error (ref metric.py:182-196 eval_msee).

    pred_E: optional precomputed prediction extrinsic (3,4)-batch — the
    Evaluator already built it via get_extrinsic(out_raw=True), so passing
    it avoids recomputing the rotation matrices per batch."""
    if pred_E is None:
        pred_R = quat_to_rotmat_batch(out3[:, :4])
        pred_E = np.concatenate([pred_R, out3[:, 4:].reshape(-1, 3, 1)], -1)
    pred_se3 = extrinsic_to_se3(pred_E)
    return lie.se3_geodesic_sq_dist(_f32(pred_se3), _f32(gt_se3)).numpy()


def eval_mrr(msee: np.ndarray, gt_se3: np.ndarray) -> np.ndarray:
    """Relative error reduction vs zero prediction (ref metric.py:199-202)."""
    gt = _f32(gt_se3)
    noise = lie.se3_geodesic_sq_dist(torch.zeros_like(gt), gt).numpy()
    return 1.0 - msee / noise


def quaternion_distance(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Angular distance between quaternion batches (ref metric.py:319-331)."""
    r_inv = r.copy()
    r_inv[:, 1:] *= -1
    t = np.stack(
        [
            r_inv[:, 0] * q[:, 0] - r_inv[:, 1] * q[:, 1] - r_inv[:, 2] * q[:, 2] - r_inv[:, 3] * q[:, 3],
            r_inv[:, 0] * q[:, 1] + r_inv[:, 1] * q[:, 0] - r_inv[:, 2] * q[:, 3] + r_inv[:, 3] * q[:, 2],
            r_inv[:, 0] * q[:, 2] + r_inv[:, 1] * q[:, 3] + r_inv[:, 2] * q[:, 0] - r_inv[:, 3] * q[:, 1],
            r_inv[:, 0] * q[:, 3] - r_inv[:, 1] * q[:, 2] + r_inv[:, 2] * q[:, 1] + r_inv[:, 3] * q[:, 0],
        ],
        axis=-1,
    )
    return 2 * np.arctan2(np.linalg.norm(t[:, 1:], axis=1), np.abs(t[:, 0]))


def get_extrinsic_rt(
    R: np.ndarray,
    t: np.ndarray,
    decalib_q_gt: np.ndarray,
    decalib_t_gt: np.ndarray,
    init_extrinsic: np.ndarray,
):
    """getExtrinsic for rotation-matrix outputs (ref metric.py:150-164)."""
    pred_E = np.concatenate([R, t.reshape(-1, 3, 1)], axis=-1)
    pred_extrinsic = mult_extrinsic_batch(pred_E, init_extrinsic)
    gt_R = quat_to_rotmat_batch(decalib_q_gt)
    gt_E = np.concatenate([gt_R, decalib_t_gt.reshape(-1, 3, 1)], axis=-1)
    gt_extrinsic = mult_extrinsic_batch(gt_E, init_extrinsic)
    return pred_extrinsic, gt_extrinsic
