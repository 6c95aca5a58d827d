"""Farthest point sampling: the CUDA kernel ``csrc/fps.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``i2pnet_tpu/ops/fps_pallas.py`` ``_fps_kernel``.
On the H100 the loop is latency-bound: npoint dependent steps of a tiny
distance update plus a block-wide argmax, so a step costs the argmax's
critical path. The kernel keeps each thread's contiguous run of points and
their running distances in registers for the whole loop, takes each warp's
argmax as one ``redux.sync`` on the distances' bits plus a ballot (no
shuffle chain), and pays one barrier per step. See the source note in
``csrc/fps.cu`` for the design and the variants measured slower. Clouds
past the registers' reach (more than 16384 points, or 32 a thread) take a
second, simple kernel with no size limit.

Both versions give bit-identical indices: start at index 0, squared
distance as ``(dx*dx + dy*dy) + dz*dz`` with no fused multiply-add, argmax
ties to the lowest index.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from i2pnet_tpu_torch.ops import _build

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0

# past this many points fps_any_kernel keeps its running distances in a
# scratch the wrapper allocates (csrc/fps.cu kAnySmemPoints)
SCRATCH_POINTS = 49152


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) f32 -> (B, npoint) int64, one vectorised step per point."""
    B, N, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    dist = torch.full((B, N), float("inf"), dtype=xyz.dtype, device=xyz.device)
    far = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    out = torch.empty(B, npoint, dtype=torch.int64, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        c = xyz[rows, far]  # (B, 3)
        dx = x - c[:, 0:1]
        dy = y - c[:, 1:2]
        dz = z - c[:, 2:3]
        d = dx * dx + dy * dy + dz * dz  # separate ops: no FMA contraction
        dist = torch.minimum(dist, d)
        far = torch.argmax(dist, dim=-1)  # first maximum
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fps")
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.fps_launch.argtypes = [v, i, i, i, v, i, v, v]
    lib.fps_launch.restype = i
    return lib


def fps_cuda(xyz: torch.Tensor, npoint: int, threads: int = 0) -> torch.Tensor:
    """Launch ``csrc/fps.cu`` on a CUDA tensor (B, N, 3) f32, any N.
    ``threads`` per batch row (a multiple of 32, at most 1024); 0 takes the
    launcher's choice for N. Up to 16384 points and 32 a thread the
    register kernel runs; any other cloud the any-N kernel."""
    global launches
    _build.require_cuda(xyz, torch.float32, "fps")
    B, N, C = xyz.shape
    if C != 3 or N < 1 or not 0 < npoint <= N:
        raise ValueError(f"fps: unsupported shape {tuple(xyz.shape)} -> {npoint}")
    if threads and (threads % 32 or not 32 <= threads <= 1024):
        raise ValueError(f"fps: unsupported thread count {threads}")
    lib = _lib()
    out = torch.empty(B, npoint, dtype=torch.int64, device=xyz.device)
    scratch = (torch.empty(B, N, dtype=torch.float32, device=xyz.device)
               if N > SCRATCH_POINTS else None)
    code = lib.fps_launch(_build.ptr(xyz), B, N, npoint, _build.ptr(out), threads,
                          None if scratch is None else _build.ptr(scratch),
                          _build.stream_of(xyz))
    _build.check(lib, code, "fps_launch")
    launches += 1
    return out

