"""The fused eval all-pixels cost volume (cv1): the CUDA kernel
``csrc/cv1.cu``, its plain PyTorch version, and the host-side factors.

Replaces the TPU kernel ``i2pnet_tpu/ops/cv_pallas.py`` ``_cv1_kernel``
(via ``fused_cv1_eval``). At eval every BatchNorm of the chain folds into
its Dense, so per query point the corr -> mlp1 -> pi_encoding -> mlp2 ->
softmax-over-pixels chain needs only (B, N, *) and (B, K, *) factors. The
factors are plain tensor code here, as they are plain XLA around the TPU
kernel: the folded weights, ``pn``/``qn``, ``t_pi``, ``t_qi`` (with the
backward-validation response, factored exactly as ``qn * max_n(pn)`` for
``qn >= 0`` and ``qn * min_n(pn)`` otherwise), ``e_pi`` and ``e_qi``.

On the H100 the chain is bound by its multiply-adds (~105 GFLOP per forward
at the shipped shapes); the kernel runs it on bf16 tensor cores with
nothing (B, N, K, *) in device memory (see the source note in
``csrc/cv1.cu``). Its softmax is an online max-and-rescale across warps;
against the plain two-pass softmax it differs only in rounding.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from i2pnet_tpu_torch.ops import _build

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0

_BF = torch.bfloat16


def mean_std_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-vector mean/std normalisation over channels (ddof=1), std clipped
    at eps; computed in x's dtype."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.sum((x - mean) ** 2, dim=-1, keepdim=True) / max(x.shape[-1] - 1, 1)
    return (x - mean) / torch.clamp(torch.sqrt(var), min=eps)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, 0.1 * x)


def cv1_plain(pn, t_pi, e_pi, qn, t_qi, e_qi, w1c, w2, b2, w3, b3, v1a, v1b, v1, v2, v2b):
    """The kernel's function on whole (B, N, K, *) tensors. bf16 operands
    are multiplied in f32 (exact products, f32 sums), with the kernel's
    rounding points. Returns (B, N, H3) f32."""
    f = lambda t: t.float()
    corr = qn[:, None, :, :] * pn[:, :, None, :]  # bf16 product
    y1 = f(corr) @ f(w1c) + t_qi[:, None] + t_pi[:, :, None]
    h1 = _leaky(y1).to(_BF)
    h2 = _leaky(f(h1) @ f(w2) + b2).to(_BF)
    h3 = _leaky(f(h2) @ f(w3) + b3)
    e = _leaky(e_qi[:, None] + e_pi[:, :, None]).to(_BF)
    g1 = f(e) @ f(v1a) + f(h3.to(_BF)) @ f(v1b) + v1
    g2 = _leaky(f(_leaky(g1).to(_BF)) @ f(v2) + v2b)
    w = torch.exp(g2 - torch.amax(g2, dim=2, keepdim=True))
    return torch.sum(w * h3, dim=2) / torch.sum(w, dim=2)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("cv1")
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.cv1_launch.argtypes = [v] * 17 + [i] * 10 + [v]
    lib.cv1_launch.restype = i
    return lib


def cv1_cuda(pn, t_pi, e_pi, qn, t_qi, e_qi, w1c, w2, b2, w3, b3, v1a, v1b, v1, v2, v2b):
    """Launch ``csrc/cv1.cu``. Operands as ``cv1_plain``: pn/qn and the
    weights bf16, the rest f32, all contiguous CUDA tensors; every width a
    multiple of 16, C/H1/G1 <= 128, H2/H3/E/G2 <= 64, G2 == H3 (the
    kernel's register tiles)."""
    global launches
    B, N, C = pn.shape
    K = qn.shape[1]
    H1, H2, H3 = w1c.shape[1], w2.shape[1], w3.shape[1]
    E, G1, G2 = v1a.shape[0], v1a.shape[1], v2.shape[1]
    expect = {
        "pn": (pn, _BF, (B, N, C)), "t_pi": (t_pi, torch.float32, (B, N, H1)),
        "e_pi": (e_pi, torch.float32, (B, N, E)), "qn": (qn, _BF, (B, K, C)),
        "t_qi": (t_qi, torch.float32, (B, K, H1)), "e_qi": (e_qi, torch.float32, (B, K, E)),
        "w1c": (w1c, _BF, (C, H1)), "w2": (w2, _BF, (H1, H2)), "b2": (b2, torch.float32, (H2,)),
        "w3": (w3, _BF, (H2, H3)), "b3": (b3, torch.float32, (H3,)),
        "v1a": (v1a, _BF, (E, G1)), "v1b": (v1b, _BF, (H3, G1)), "v1": (v1, torch.float32, (G1,)),
        "v2": (v2, _BF, (G1, G2)), "v2b": (v2b, torch.float32, (G2,)),
    }
    for name, (t, dtype, shape) in expect.items():
        _build.require_cuda(t, dtype, f"cv1 {name}")
        if tuple(t.shape) != shape:
            raise ValueError(f"cv1 {name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"cv1 {name}: expected 16-byte alignment")
    dims = (C, H1, H2, H3, E, G1, G2)
    if (any(d % 16 for d in dims) or G2 != H3 or max(C, H1, G1) > 128
            or max(H2, H3, E, G2) > 64):
        raise ValueError(f"cv1: unsupported widths {dims}")
    out = torch.empty(B, N, H3, dtype=torch.float32, device=pn.device)
    lib = _lib()
    ptrs = [_build.ptr(t) for t, _, _ in expect.values()] + [_build.ptr(out)]
    code = lib.cv1_launch(*ptrs, B, N, K, *dims, _build.stream_of(pn))
    _build.check(lib, code, "cv1_launch")
    launches += 1
    return out


def cv1(*operands):
    """The op ``torch.ops.i2pnet.cv1`` (``ops/library.py``): the kernel for
    CUDA operands, the plain version for CPU operands."""
    return torch.ops.i2pnet.cv1(*operands)


def fused_cv1_eval_supported(mlp1, mlp2) -> bool:
    """mlp1 of depth 3, mlp2 of depth 2, and G2 == H3 (the softmax weights
    multiply h3 channel by channel)."""
    return len(mlp1) == 3 and len(mlp2) == 2 and mlp2[-1] == mlp1[-1]


def fused_cv1_eval(pi_xyz, pi_feat, qi_xyz, qi_feat, mlp1, pi_encoding, mlp2, *, bval: bool):
    """pi side of the all-pixels CostVolume at eval -> (B, N, H3) f32.

    pi_xyz (B,N,3) depth-restored points, pi_feat (B,N,C) lidar features,
    qi_xyz (B,K,3) pixel-plane coords, qi_feat (B,K,C) image features.
    mlp1: three folded (W (in,out), b) f32 pairs; pi_encoding: one; mlp2: two.
    """
    C = pi_feat.shape[-1]
    (W1, b1), (W2, b2), (W3, b3) = mlp1
    WE, bE = pi_encoding
    (V1, v1), (V2, v2) = mlp2
    E = WE.shape[1]

    pn = mean_std_normalize(pi_feat)
    qn = mean_std_normalize(qi_feat)
    # layer-1 input is [pi_xyz(3), qi_xyz(3), corr(C), respond(C)]
    t_pi = pi_xyz @ W1[0:3]
    t_qi = qi_xyz @ W1[3:6] + b1
    if bval:
        maxp = torch.amax(pn, dim=1, keepdim=True)
        minp = torch.amin(pn, dim=1, keepdim=True)
        respond = torch.where(qn >= 0, qn * maxp, qn * minp)
        t_qi = t_qi + respond @ W1[6 + C:]
    e_pi = pi_xyz @ WE[0:3]
    e_qi = qi_xyz @ WE[3:6] + bE
    return cv1(
        pn.to(_BF), t_pi, e_pi, qn.to(_BF), t_qi, e_qi,
        W1[6:6 + C].to(_BF), W2.to(_BF), b2, W3.to(_BF), b3,
        V1[:E].to(_BF), V1[E:].to(_BF), v1, V2.to(_BF), v2,
    )
