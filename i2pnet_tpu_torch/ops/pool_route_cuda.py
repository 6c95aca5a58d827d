"""The routed backward of the native encoder chain's 3x3 max-pool: the CUDA
kernel ``csrc/pool_route.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``i2pnet_tpu/nn/layers.py`` ``_pool3_route_kernel``
(via ``_pool3_route_pallas``, stride 1 at :256 and stride 2 at :271). Given
the winning tap of every pooled cell (``pool3_argtap``, plain PyTorch on the
card too, as JAX computes it outside its kernel) and the pooled cotangent
ct, dx at each input pixel is the sum, over the pooled cells whose window
covers it, in tap order o = 0..8, of ct where the cell's tap names it; in
ct's dtype, rounded after every add, as JAX's kernel adds.

argtap is uint8 here (0-8, and 9 for a cell that routes nowhere), where JAX
keeps int32: the values are the same, in a quarter of the bytes.

The kernel takes kernel (d)'s layout without the slope: a block stages the
argtap and ct of the pooled cells that cover its tile of input pixels once
(cp.async), then each pixel gathers its candidate cells in tap order (at
stride 2 in parity passes, 1, 2 or 4 cells a pixel) and writes its channels
as one vector. Any C: 8 channels a thread where C and the operands'
alignment allow, else 4, else 1 (one template).

``pool_route_cuda`` counts its launches per stride in ``launches``;
``pool_route`` takes the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from i2pnet_tpu_torch.ops import _build

# kernel launches since the last reset (read by chip_smoke.py)
launches = {"pool_route_s1": 0, "pool_route_s2": 0}

NO_TAP = 9


def _window_views(t, stride: int, H: int, W: int):
    """The 9 window taps of t (B,H,W,C) padded by one on each side, as
    views (B,Ho,Wo,C) in row-major (kh, kw) order."""
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    return [t[:, kh:kh + (Ho - 1) * stride + 1:stride, kw:kw + (Wo - 1) * stride + 1:stride]
            for kh in range(3) for kw in range(3)]


def pool3_argtap(x: torch.Tensor, y: torch.Tensor, stride: int) -> torch.Tensor:
    """JAX's ``_pool3_argtap``: the first tap of each pooled cell's window
    whose input equals the pooled value y, as uint8 (9 where none does)."""
    H, W = x.shape[1:3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=float("-inf"))
    argtap = torch.full(y.shape, NO_TAP, dtype=torch.uint8, device=x.device)
    for o, tap in enumerate(_window_views(xp, stride, H, W)):
        argtap = torch.minimum(argtap, torch.where(tap == y, o, NO_TAP).to(torch.uint8))
    return argtap


def pool_route_plain(argtap: torch.Tensor, ct: torch.Tensor, stride: int) -> torch.Tensor:
    """argtap (B,Ho,Wo,C) uint8, ct (B,Ho,Wo,C) -> dx (B, stride*Ho,
    stride*Wo, C) in ct's dtype, summed tap by tap in that dtype."""
    B, Ho, Wo, C = ct.shape
    H, W = stride * Ho, stride * Wo
    acc = torch.zeros(B, H + 2, W + 2, C, dtype=ct.dtype, device=ct.device)
    for o, view in enumerate(_window_views(acc, stride, H, W)):
        view += torch.where(argtap == o, ct, 0)
    return acc[:, 1:H + 1, 1:W + 1]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("pool_route")
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.pool_route_launch.argtypes = [v, v, v, i, i, i, i, i, i, v]
    lib.pool_route_launch.restype = i
    return lib


def pool_route_cuda(argtap: torch.Tensor, ct: torch.Tensor, stride: int) -> torch.Tensor:
    """Launch ``csrc/pool_route.cu``; operands as ``pool_route_plain``,
    contiguous CUDA tensors, ct bf16 or f32, stride 1 or 2."""
    if ct.dtype not in (torch.bfloat16, torch.float32) or stride not in (1, 2):
        raise ValueError(f"pool_route: unsupported {ct.dtype}, stride {stride}")
    _build.require_cuda(ct, ct.dtype, "pool_route ct")
    _build.require_cuda(argtap, torch.uint8, "pool_route argtap")
    if argtap.shape != ct.shape:
        raise ValueError(f"pool_route: argtap {tuple(argtap.shape)} != ct {tuple(ct.shape)}")
    B, Ho, Wo, C = ct.shape
    dx = torch.empty(B, stride * Ho, stride * Wo, C, dtype=ct.dtype, device=ct.device)
    lib = _lib()
    code = lib.pool_route_launch(
        _build.ptr(argtap), _build.ptr(ct), _build.ptr(dx), B, Ho, Wo, C, stride,
        int(ct.dtype == torch.bfloat16), _build.stream_of(ct))
    _build.check(lib, code, "pool_route_launch")
    launches[f"pool_route_s{stride}"] += 1
    return dx


def pool_route(argtap: torch.Tensor, ct: torch.Tensor, stride: int) -> torch.Tensor:
    if ct.is_cuda:
        return pool_route_cuda(argtap, ct, stride)
    return pool_route_plain(argtap, ct, stride)
