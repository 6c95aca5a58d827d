"""Window selection multiplicities: the CUDA kernel ``csrc/select.cu`` and
its plain PyTorch version.

Replaces the TPU kernel ``i2pnet_tpu/ops/select_pallas.py`` ``_sel_kernel``
(via ``selection_multiplicity_pallas``). For the PointNet levels' window
select (stride (1, 1), cylindrical wrap, copy fill) it gives, per query and
window slot, how many of the K selected neighbours are that slot:
m (B, out_h*out_w, kh*kw + 1) f32, slot kh*kw the sentinel, each row
summing to K. The dense eval route (``ops/dense_window.py``) weights its
BatchNorm statistics and masks its max with m, so no K-gather runs.

On the H100 the work is tiny (a few hundred slots per query) and bound, in
principle, by the bytes of m; the kernel gives each query one warp, the
slots' distances sit in the lanes' registers, a ballot counts the valid
ones, and the selection takes no pass per neighbour: with at most K valid
slots all are selected and one ``redux.sync`` argmin finds the nearest,
with more a ballot radix select finds the K smallest. A block writes its
queries' m rows as 16-byte vectors. Windows of more than 255 slots take a
shared-memory kernel of K shuffle-argmin passes (see the source note in
``csrc/select.cu``).

Both versions give the same m exactly: the distance is ``(dx*dx + dy*dy) +
dz*dz`` with no fused multiply-add, the radius squared is rounded to f32,
and equal distances go to the lowest slot first (the plain version sorts
stably; ``lax.top_k`` orders ties so too).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from i2pnet_tpu_torch.ops import _build
from i2pnet_tpu_torch.ops.projection import window_neighbor_select_grid

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0

# kh*kw + 1 <= 256 keeps the slots in eight registers a lane; larger
# windows, up to a warp's row of kh*kw floats in a block's shared memory,
# take the shared-memory kernel
MAX_SLOTS = (232448 - 128) // 4


def selection_multiplicity(args: torch.Tensor, khw: int) -> torch.Tensor:
    """Selected slot indices (B, N, K) (khw = the sentinel) -> multiplicities
    (B, N, khw + 1) f32; each row sums to K."""
    m = torch.zeros(args.shape[:-1] + (khw + 1,), dtype=torch.float32, device=args.device)
    return m.scatter_add_(-1, args, torch.ones(args.shape, dtype=torch.float32,
                                                device=args.device))


def _dist2(distance: float) -> float:
    """distance**2 rounded to f32, the value both versions compare with."""
    return float(torch.tensor(distance * distance, dtype=torch.float32))


def selection_multiplicity_plain(xyz: torch.Tensor, out_h: int, out_w: int,
                                 qstride: Tuple[int, int], kernel_size: Tuple[int, int], K: int,
                                 distance: float) -> torch.Tensor:
    """xyz (B, h2, w2, 3) f32 -> m (B, out_h*out_w, kh*kw + 1) f32: the
    stable windowed select of ``window_neighbor_select_grid`` (stride
    (1, 1), shift, copy), counted per slot."""
    args, _ = window_neighbor_select_grid(
        xyz, xyz, out_h, out_w, qstride, kernel_size, K, stride=(1, 1), distance=distance,
        shift=True, copy=True,
    )
    return selection_multiplicity(args, kernel_size[0] * kernel_size[1])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("select")
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.select_launch.argtypes = [v, i, i, i, i, i, i, i, i, i, i, ctypes.c_float, v, v]
    lib.select_launch.restype = i
    return lib


def selection_multiplicity_cuda(xyz: torch.Tensor, out_h: int, out_w: int,
                                qstride: Tuple[int, int], kernel_size: Tuple[int, int], K: int,
                                distance: float) -> torch.Tensor:
    """Launch ``csrc/select.cu`` on a contiguous CUDA tensor xyz
    (B, h2, w2, 3) f32."""
    global launches
    _build.require_cuda(xyz, torch.float32, "select xyz")
    B, h2, w2, C = xyz.shape
    (qh, qw), (kh, kw) = qstride, kernel_size
    if (C != 3 or kh * kw > MAX_SLOTS or K < 1 or (out_h - 1) * qh >= h2
            or (out_w - 1) * qw >= w2):
        raise ValueError(f"select: unsupported xyz {tuple(xyz.shape)} -> ({out_h}, {out_w}), "
                         f"qstride {qstride}, kernel {kernel_size}, K {K}")
    lib = _lib()
    m = torch.empty(B, out_h * out_w, kh * kw + 1, dtype=torch.float32, device=xyz.device)
    code = lib.select_launch(
        _build.ptr(xyz), B, h2, w2, out_h, out_w, qh, qw, kh, kw, K, _dist2(distance),
        _build.ptr(m), _build.stream_of(xyz),
    )
    _build.check(lib, code, "select_launch")
    launches += 1
    return m


def window_multiplicity(xyz: torch.Tensor, *, out_h: int, out_w: int, qstride: Tuple[int, int],
                        kernel_size: Tuple[int, int], K: int, distance: float,
                        raw_layout: bool = False) -> torch.Tensor:
    """m (B, out_h*out_w, kh*kw + 1), the op
    ``torch.ops.i2pnet.select_multiplicity`` (``ops/library.py``): the
    kernel for a CUDA tensor, the plain version for a CPU one.
    ``raw_layout`` returns the same values as (B, out_h, kh*kw + 1, out_w)."""
    m = torch.ops.i2pnet.select_multiplicity(xyz.float(), out_h, out_w, list(qstride),
                                             list(kernel_size), K, float(distance))
    if raw_layout:
        m = m.reshape(xyz.shape[0], out_h, out_w, -1).permute(0, 1, 3, 2)
    return m
