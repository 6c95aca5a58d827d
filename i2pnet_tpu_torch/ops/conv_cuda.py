"""The fused eval RGB-encoder block: the CUDA kernel ``csrc/conv_block.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``i2pnet_tpu/ops/conv_pallas.py`` ``_block_kernel``
(via ``fused_conv_block``). One block is a 3x3 conv (stride 1, pad 1) on
bf16 inputs with f32 accumulation, then ``y * scale + shift`` in f32 (conv
bias and eval BatchNorm folded by ``fold_bn_eval``), LeakyReLU(0.1), a bf16
cast and a 3x3 max-pool at stride s with pad 1. On the H100 it is bound by
bytes: each block streams its input rows once through a shared-memory ring
and keeps the full-resolution conv rows there, in bf16, until they are
pooled (see the source note in ``csrc/conv_block.cu``).

``stage_supported`` says where the kernel takes a whole stage; elsewhere
``RGBEncoderStage`` runs the native chain, as the JAX package routes by its
own ``stage_supported``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from i2pnet_tpu_torch.ops import _build

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0


def fold_bn_eval(bias, mean, var, gamma, beta, eps: float):
    """Fold conv bias + eval BatchNorm into f32 (scale, shift) per channel:
    (conv + bias - mean) * gamma / sqrt(var + eps) + beta = conv * scale + shift."""
    inv = gamma.float() * torch.rsqrt(var.float() + eps)
    return inv, (bias.float() - mean.float()) * inv + beta.float()


def conv_block_plain(x, w, scale, shift, stride: int) -> torch.Tensor:
    """x (B,H,W,cin), w (3,3,cin,cout) HWIO, both rounded to bf16 and
    convolved in f32; scale/shift (cout,) f32 -> (B,Ho,Wo,cout) bf16.
    On the card, callers switch cuDNN's TF32 off
    (``torch.backends.cudnn.allow_tf32 = False``): TF32 keeps ~3 digits."""
    xf = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wf = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    y = F.conv2d(xf, wf, padding=1)
    y = y * scale[:, None, None] + shift[:, None, None]
    y = torch.where(y >= 0, y, 0.1 * y).to(torch.bfloat16).float()
    y = F.max_pool2d(y, 3, stride, 1)
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


# the kernel's launch plan (csrc/conv_block.cu mirrors the layout)
_STAGES = 8  # input-row ring slots
_CONV_SLOTS = 4  # conv-row ring slots
_RAW_CIN = 5  # input channels up to which the rows stay raw
_EXP_SLOTS = 4  # raw path: rows expanded to 4 or 8 channels a pixel
_MAX_SMEM = 232448 - 128  # dynamic shared memory a block may take
_MAX_MT = 8  # m16 tiles of a conv row: slabs of at most 128 conv pixels
_MAX_CO_T = 64  # output channels a block owns at most


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _block_smem(cin: int, co_t: int, mt: int) -> int:
    """Bytes of dynamic shared memory of a block (``layout`` in the source)."""
    raw = cin <= _RAW_CIN
    cw, cinp = 16 * mt, _round_up(cin, 16)
    c4 = 4 if cin <= 4 else 8  # raw path: channels of an expanded pixel
    kh16 = _round_up(3 * c4, 16)
    kp = 3 * kh16 if raw else 9 * cinp
    xslot = _round_up((cw + 2) * cin + 14, 8) if raw else (cw + 2) * (cinp + 8)
    expanded = _EXP_SLOTS * (cw + kh16 // c4 + 1) * c4 if raw else 0
    weights = _round_up(_round_up(co_t, 16) * (kp + 8) * 2, 16)
    return (weights + 2 * _STAGES * xslot + 2 * expanded + 2 * _CONV_SLOTS * cw * (co_t + 8)
            + 8 * co_t)


class BlockPlan(NamedTuple):
    """The kernel's split of one call: channel tiles of ``co_t``, slabs of
    ``pw`` pooled columns (their conv columns within ``16 * mt`` pixels).
    The launcher cuts the pooled rows into strips, as many as fill one wave
    of the blocks a SM holds."""

    co_t: int
    mt: int
    pw: int
    slabs: int


def _block_plan(B: int, H: int, W: int, cin: int, cout: int, stride: int) -> Optional[BlockPlan]:
    """The widest slab and channel tile whose layout fits in shared memory;
    None where none does, or where the kernel takes no such block (stride
    not 1 or 2, cout not a multiple of 8)."""
    if stride not in (1, 2) or cout % 8 or cin < 1 or cout < 8 or min(B, H, W) < 1:
        return None
    Wo = (W - 1) // stride + 1
    tiles = [d for d in range(min(cout, _MAX_CO_T), 7, -8) if cout % d == 0]
    for mt_cap in range(_MAX_MT, 0, -1):
        pw_max = 16 * mt_cap - 2 if stride == 1 else (16 * mt_cap - 1) // 2
        slabs = -(-Wo // pw_max)
        pw = -(-Wo // slabs)
        mt = -(-(pw + 2 if stride == 1 else 2 * pw + 1) // 16)
        co_t = next((d for d in tiles if _block_smem(cin, d, mt) <= _MAX_SMEM), None)
        if co_t is not None:
            return BlockPlan(co_t, mt, pw, slabs)
    return None


def stage_supported(H: int, W: int, cin: int, channels: Sequence[int],
                    strides: Sequence[int]) -> bool:
    """True if the kernel takes every block of the stage: stride 1 or 2,
    cout a multiple of 8, and a launch plan whose shared memory fits (for
    any batch). The port's counterpart of the JAX package's
    ``stage_supported``, with the port's own limits."""
    for cout, s in zip(channels, strides):
        if _block_plan(1, H, W, cin, cout, s) is None:
            return False
        H, W, cin = (H - 1) // s + 1, (W - 1) // s + 1, cout
    return True


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_block")
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_block_launch.argtypes = [v, v, v, v, v] + [i] * 10 + [v]
    lib.conv_block_launch.restype = i
    return lib


def conv_block_cuda(x, w, scale, shift, stride: int) -> torch.Tensor:
    """Launch ``csrc/conv_block.cu``: x (B,H,W,cin) bf16, w (3,3,cin,cout)
    bf16, scale/shift (cout,) f32, all contiguous CUDA tensors."""
    global launches
    _build.require_cuda(x, torch.bfloat16, "conv_block x")
    _build.require_cuda(w, torch.bfloat16, "conv_block w")
    _build.require_cuda(scale, torch.float32, "conv_block scale")
    _build.require_cuda(shift, torch.float32, "conv_block shift")
    B, H, W, cin = x.shape
    cout = w.shape[3]
    plan = _block_plan(B, H, W, cin, cout, stride) if tuple(w.shape) == (3, 3, cin, cout) else None
    if plan is None:
        raise ValueError(
            f"conv_block: unsupported x {tuple(x.shape)}, w {tuple(w.shape)}, stride {stride}"
        )
    if scale.shape != (cout,) or shift.shape != (cout,):
        raise ValueError("conv_block: scale/shift must be (cout,)")
    if x.data_ptr() % 16:
        raise ValueError("conv_block x: expected 16-byte alignment")
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    out = torch.empty(B, Ho, Wo, cout, dtype=torch.bfloat16, device=x.device)
    w_ohwi = w.permute(3, 0, 1, 2).contiguous()  # the kernel reads each (co, tap) row of cin
    lib = _lib()
    code = lib.conv_block_launch(
        _build.ptr(x), _build.ptr(w_ohwi), _build.ptr(scale), _build.ptr(shift),
        _build.ptr(out), B, H, W, cin, cout, stride, *plan, _build.stream_of(x),
    )
    _build.check(lib, code, "conv_block_launch")
    launches += 1
    return out


def fused_conv_block(x, w, scale, shift, stride: int) -> torch.Tensor:
    """One fused eval encoder block: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.is_cuda:
        return conv_block_cuda(
            x.to(torch.bfloat16).contiguous(), w.to(torch.bfloat16).contiguous(),
            scale.contiguous(), shift.contiguous(), stride,
        )
    return conv_block_plain(x, w, scale, shift, stride)
