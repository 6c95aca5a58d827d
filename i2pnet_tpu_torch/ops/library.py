"""The eval kernels as ``torch.library`` custom ops (namespace ``i2pnet``).

    torch.ops.i2pnet.fps(xyz, npoint)
    torch.ops.i2pnet.conv_block(x, w, scale, shift, stride)
    torch.ops.i2pnet.cv1(pn, t_pi, e_pi, qn, t_qi, e_qi, w1c, w2, b2, w3, b3, v1a, v1b, v1,
                         v2, v2b)
    torch.ops.i2pnet.select_multiplicity(xyz, out_h, out_w, qstride, kernel_size, K,
                                         distance)
    torch.ops.i2pnet.dense_level_pass(src, cxyz, feature, m, weights, biases, scales, shifts,
                                      stats, denom, out_h, out_w, qstride, kernel_size,
                                      nsample, mode, bf16, layer, kind, eps)

Each op has a CPU implementation, the kernel's plain PyTorch version, a
CUDA implementation, the kernel's launcher (``fps_cuda``, ``conv_cuda``,
``cv_cuda``, ``select_cuda``, ``dense_level_cuda``), which raises where the
kernel takes no such call, and a fake implementation that gives the
output's shape, dtype and strides from the inputs alone. The dispatcher
picks the implementation by the inputs' device, so an eager call, a
CUDA-graph replay and a ``torch.export`` program all reach the same
kernel, and an exported forward keeps each kernel as one node.

A serving host that loads an exported program imports this module (and
torch) to register the ops; it needs no model code. The kernels build at
their first call on the card, never at import.

The launchers and plain versions are looked up on their modules at each
call, so a wrapper replaced there (a recorder, a counter) is the one that
runs.
"""

from __future__ import annotations

from typing import List

import torch
from torch import Tensor

from i2pnet_tpu_torch.ops import conv_cuda, cv_cuda, dense_level_cuda, fps_cuda, select_cuda


# --- FPS (csrc/fps.cu) -------------------------------------------------------

@torch.library.custom_op("i2pnet::fps", mutates_args=(), device_types="cpu")
def fps(xyz: Tensor, npoint: int) -> Tensor:
    """(B, N, 3) f32 -> (B, npoint) int64, from index 0."""
    return fps_cuda.fps_plain(xyz, npoint)


@fps.register_kernel("cuda")
def _(xyz, npoint):
    return fps_cuda.fps_cuda(xyz.contiguous(), npoint)


@fps.register_fake
def _(xyz, npoint):
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int64)


# --- the eval encoder block (csrc/conv_block.cu) -----------------------------

@torch.library.custom_op("i2pnet::conv_block", mutates_args=(), device_types="cpu")
def conv_block(x: Tensor, w: Tensor, scale: Tensor, shift: Tensor, stride: int) -> Tensor:
    """x (B,H,W,cin), w (3,3,cin,cout), scale/shift (cout,) f32 ->
    (B,Ho,Wo,cout) bf16; x and w are taken in bf16."""
    return conv_cuda.conv_block_plain(x, w, scale, shift, stride)


@conv_block.register_kernel("cuda")
def _(x, w, scale, shift, stride):
    return conv_cuda.conv_block_cuda(
        x.to(torch.bfloat16).contiguous(), w.to(torch.bfloat16).contiguous(),
        scale.contiguous(), shift.contiguous(), stride,
    )


@conv_block.register_fake
def _(x, w, scale, shift, stride):
    B, H, W, _ = x.shape
    return x.new_empty((B, (H - 1) // stride + 1, (W - 1) // stride + 1, w.shape[3]),
                       dtype=torch.bfloat16)


# --- the eval all-pixels cost volume (csrc/cv1.cu) ---------------------------

@torch.library.custom_op("i2pnet::cv1", mutates_args=(), device_types="cpu")
def cv1(pn: Tensor, t_pi: Tensor, e_pi: Tensor, qn: Tensor, t_qi: Tensor, e_qi: Tensor,
        w1c: Tensor, w2: Tensor, b2: Tensor, w3: Tensor, b3: Tensor, v1a: Tensor,
        v1b: Tensor, v1: Tensor, v2: Tensor, v2b: Tensor) -> Tensor:
    """The operands of ``cv_cuda.cv1_plain`` -> (B, N, H3) f32."""
    return cv_cuda.cv1_plain(pn, t_pi, e_pi, qn, t_qi, e_qi, w1c, w2, b2, w3, b3, v1a, v1b, v1,
                             v2, v2b)


@cv1.register_kernel("cuda")
def _(*operands):
    return cv_cuda.cv1_cuda(*(t.contiguous() for t in operands))


@cv1.register_fake
def _(pn, t_pi, e_pi, qn, t_qi, e_qi, w1c, w2, b2, w3, b3, v1a, v1b, v1, v2, v2b):
    return pn.new_empty((pn.shape[0], pn.shape[1], w3.shape[1]), dtype=torch.float32)


# --- the window selection multiplicities (csrc/select.cu) --------------------

@torch.library.custom_op("i2pnet::select_multiplicity", mutates_args=(), device_types="cpu")
def select_multiplicity(xyz: Tensor, out_h: int, out_w: int, qstride: List[int],
                        kernel_size: List[int], K: int, distance: float) -> Tensor:
    """xyz (B, h2, w2, 3) f32 -> m (B, out_h*out_w, kh*kw + 1) f32."""
    return select_cuda.selection_multiplicity_plain(xyz, out_h, out_w, tuple(qstride),
                                                    tuple(kernel_size), K, distance)


@select_multiplicity.register_kernel("cuda")
def _(xyz, out_h, out_w, qstride, kernel_size, K, distance):
    return select_cuda.selection_multiplicity_cuda(xyz.contiguous(), out_h, out_w,
                                                   tuple(qstride), tuple(kernel_size), K,
                                                   distance)


@select_multiplicity.register_fake
def _(xyz, out_h, out_w, qstride, kernel_size, K, distance):
    return xyz.new_empty((xyz.shape[0], out_h * out_w, kernel_size[0] * kernel_size[1] + 1),
                         dtype=torch.float32)


# --- a dense eval level's passes (csrc/dense_level.cu) -----------------------

@torch.library.custom_op("i2pnet::dense_level_pass", mutates_args=(), device_types="cpu")
def dense_level_pass(src: Tensor, cxyz: Tensor, feature: Tensor, m: Tensor, weights: List[Tensor],
                     biases: List[Tensor], scales: List[Tensor], shifts: List[Tensor],
                     stats: List[Tensor], denom: float, out_h: int, out_w: int,
                     qstride: List[int], kernel_size: List[int], nsample: int, mode: str,
                     bf16: bool, layer: int, kind: int, eps: float) -> Tensor:
    """One pass of ``dense_level_cuda.dense_level_pass_plain``: (B, C) f32
    sums for a mean or variance pass, (B, out_h, out_w, C) f32 for the max."""
    return dense_level_cuda.dense_level_pass_plain(
        src, cxyz, feature, m, weights, biases, scales, shifts, stats, denom, out_h, out_w,
        tuple(qstride), tuple(kernel_size), nsample, mode, bf16, layer, kind, eps)


@dense_level_pass.register_kernel("cuda")
def _(src, cxyz, feature, m, weights, biases, scales, shifts, stats, denom, out_h, out_w,
      qstride, kernel_size, nsample, mode, bf16, layer, kind, eps):
    return dense_level_cuda.dense_level_pass_cuda(
        src, cxyz, feature, m.contiguous(), weights, biases, scales, shifts, stats, denom, out_h,
        out_w, tuple(qstride), tuple(kernel_size), nsample, mode, bf16, layer, kind, eps)


@dense_level_pass.register_fake
def _(src, cxyz, feature, m, weights, biases, scales, shifts, stats, denom, out_h, out_w,
      qstride, kernel_size, nsample, mode, bf16, layer, kind, eps):
    if kind == dense_level_cuda.MAX:
        return m.new_empty((m.shape[0], out_h, out_w, weights[-1].shape[0]), dtype=torch.float32)
    return m.new_empty((m.shape[0], weights[layer].shape[0]), dtype=torch.float32)
