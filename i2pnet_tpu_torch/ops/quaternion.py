"""Quaternion / SE(3) algebra (port of ``i2pnet_tpu/ops/quaternion.py``).

Quaternions are (w, x, y, z) on the trailing axis; every function
broadcasts over leading axes.
"""

from __future__ import annotations

import torch

_EPS = 1e-10


def qconj(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate. q: (..., 4). Built on the device: a constant
    from a host list would be a host-to-device copy, which synchronises."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Quaternion inverse conj(q)/|q|^2."""
    norm_sq = torch.sum(q * q, dim=-1, keepdim=True) + _EPS
    return qconj(q) / norm_sq


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, broadcasting over leading axes."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def qrotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by q (..., 4) as q [0, v] q^-1 (the full
    inverse, so a non-unit q matches the JAX package)."""
    vq = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return qmul(qmul(q, vq), qinv(q))[..., 1:4]


def warp_points(xyz: torch.Tensor, q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Apply (q (B,4), t (B,3)) to points (B, N, 3)."""
    return qrotate(q[:, None, :], xyz) + t[:, None, :]


def warp_to_normalized_plane(xyz, q, t):
    """Warp by (q, t), then divide by depth -> (uvw (B,N,3), z (B,N,1))."""
    warped = warp_points(xyz, q, t)
    z = warped[..., 2:3]
    return warped / (z + _EPS), z


def project_to_normalized_plane(xyz: torch.Tensor):
    """Divide camera-frame points by depth -> (uvw, z)."""
    z = xyz[..., 2:3]
    return xyz / (z + _EPS), z


def compose_pose(q_outer, t_outer, q_inner, t_inner):
    """outer o inner: q = q_o * q_i, t = R_o t_i + t_o. (B,4)/(B,3) each."""
    q = qmul(q_outer, q_inner)
    t = qrotate(q_outer[:, None, :], t_inner[:, None, :])[:, 0, :] + t_outer
    return q, t


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3), the JAX
    package's expansion."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
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
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), w >= 0.
    Shepperd's four candidates, one picked per matrix by ``torch.where``
    (no data-dependent control flow), as the JAX package builds it."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = safe_sqrt(tr + 1.0) * 2.0  # trace-dominant
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0  # m00 dominant
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0  # m11 dominant
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0  # m22 dominant
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w = q[..., 0:1]
    return q * torch.sign(torch.where(w == 0, torch.ones_like(w), w))


def pose_to_matrix(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(q (B,4), t (B,3)) -> extrinsic (B, 3, 4)."""
    return torch.cat([quat_to_rotmat(q), t[..., None]], dim=-1)


def project_with_calib(xyz: torch.Tensor, calib: torch.Tensor):
    """Project points (B, N, 3) through a (B, 3or4, 4) calibration matrix to
    its pixel plane -> (uvw (B,N,3), z (B,N,1)), in full f32 like the JAX
    package's HIGHEST-precision einsum."""
    cam = torch.einsum("bij,bnj->bni", calib[:, :3, :3], xyz) + calib[:, None, :3, 3]
    z = cam[..., 2:3]
    return cam / (z + _EPS), z


def warp_with_calib(xyz: torch.Tensor, q: torch.Tensor, t: torch.Tensor, calib: torch.Tensor):
    """Warp by (q, t), then ``project_with_calib``."""
    return project_with_calib(warp_points(xyz, q, t), calib)
