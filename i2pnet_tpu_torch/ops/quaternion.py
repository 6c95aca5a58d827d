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
