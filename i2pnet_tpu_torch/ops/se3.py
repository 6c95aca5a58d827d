"""SO(3)/SE(3) exp/log maps on torch tensors (port of
``i2pnet_tpu/ops/se3.py``), used by the MSEE/MRR metrics.

se3 vectors are ordered (rotation(3), translation(3)). Every function
broadcasts over leading axes. The small-angle branches are JAX's: a
``where`` between the series and the closed form at |w| < 1e-5, with the
closed form's divisor replaced by 1 on the small side, and the diagonal
construction of ``so3_log`` within 1e-3 of pi. hat(w)^2 is built
elementwise (w w^T - |w|^2 I), as JAX builds it.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], -1),
            torch.stack([wz, zeros, -wx], -1),
            torch.stack([-wy, wx, zeros], -1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _hat_sq(w: torch.Tensor) -> torch.Tensor:
    """hat(w) @ hat(w) == w w^T - |w|^2 I, computed elementwise (exact)."""
    outer = w[..., :, None] * w[..., None, :]
    norm_sq = torch.sum(w * w, dim=-1)[..., None, None]
    return outer - norm_sq * _eye(w)


def _eye(w: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=w.dtype, device=w.device)


def _theta(w: torch.Tensor) -> torch.Tensor:
    """|w| with shape (..., 1, 1) for matrix broadcasting."""
    return torch.sqrt(torch.sum(w * w, dim=-1))[..., None, None]


def _where(cond, a, b):
    return torch.where(cond, a, b)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues. w: (..., 3) -> R (..., 3, 3)."""
    theta = _theta(w)
    small = theta < 1e-5
    safe = _where(small, torch.ones_like(theta), theta)
    A = _where(small, 1.0 - theta**2 / 6.0, torch.sin(theta) / safe)
    B = _where(small, 0.5 - theta**2 / 24.0, (1.0 - torch.cos(theta)) / safe**2)
    return _eye(w) + A * hat(w) + B * _hat_sq(w)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3) -> w (..., 3). Stable away from theta == pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)[..., None]
    small = theta < 1e-5
    factor = _where(
        small,
        0.5 + theta**2 / 12.0,
        theta / (2.0 * torch.sin(_where(small, torch.ones_like(theta), theta))),
    )
    w = factor * vee(R - R.transpose(-1, -2))
    # near pi the antisymmetric part vanishes; use the diagonal construction
    near_pi = theta[..., 0] > math.pi - 1e-3
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis_sq = torch.clamp(
        (diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS), min=0.0
    )
    axis = torch.sqrt(axis_sq)
    one = torch.ones_like(tr)
    signs = [
        _where(R[..., i, j] - R[..., j, i] >= 0, one, -one)
        for i, j in ((2, 1), (0, 2), (1, 0))
    ]
    axis = axis * torch.stack(signs, -1)
    w_pi = axis * theta[..., 0][..., None]
    return _where(near_pi[..., None], w_pi, w)


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta = _theta(w)
    small = theta < 1e-5
    safe = _where(small, torch.ones_like(theta), theta)
    B = _where(small, 0.5 - theta**2 / 24.0, (1.0 - torch.cos(theta)) / safe**2)
    C = _where(small, 1.0 / 6.0 - theta**2 / 120.0, (theta - torch.sin(theta)) / safe**3)
    return _eye(w) + B * hat(w) + C * _hat_sq(w)


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta = _theta(w)
    small = theta < 1e-5
    safe = _where(small, torch.ones_like(theta), theta)
    half = theta / 2.0
    coef = _where(
        small,
        1.0 / 12.0 + theta**2 / 720.0,
        (1.0 - half * torch.cos(half) / _where(small, torch.ones_like(half), torch.sin(half)))
        / safe**2,
    )
    return _eye(w) - 0.5 * hat(w) + coef * _hat_sq(w)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", M, v)


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return row.expand(top.shape[:-2] + (1, 4))


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi (..., 6) = (rot, trans) -> T (..., 4, 4)."""
    w, rho = xi[..., :3], xi[..., 3:]
    top = torch.cat([so3_exp(w), _matvec(_left_jacobian(w), rho)[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """T (..., 4, 4) -> xi (..., 6) = (rot, trans)."""
    w = so3_log(T[..., :3, :3])
    rho = _matvec(_left_jacobian_inv(w), T[..., :3, 3])
    return torch.cat([w, rho], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -_matvec(Rt, T[..., :3, 3])
    top = torch.cat([Rt, ti[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_geodesic_sq_dist(xi_a: torch.Tensor, xi_b: torch.Tensor) -> torch.Tensor:
    """Squared left-canonical geodesic distance between se3 coordinates:
    ||log(exp(xi_a)^-1 exp(xi_b))||^2."""
    rel = torch.einsum("...ij,...jk->...ik", se3_inverse(se3_exp(xi_a)), se3_exp(xi_b))
    diff = se3_log(rel)
    return torch.sum(diff * diff, dim=-1)
