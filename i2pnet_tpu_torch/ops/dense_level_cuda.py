"""A projection-family PointNet level's dense eval chain after the
multiplicities, pass by pass: the CUDA kernel ``csrc/dense_level.cu`` and
its plain PyTorch version.

Replaces no TPU kernel (``i2pnet_tpu/ops/dense_window.py`` is plain jnp):
the chain of ``ops/dense_window.py`` ``dense_pointnet_eval`` (the grouped
features of every window slot, each MLP layer's Dense and m-weighted
BatchStatsNorm, the max over the selected slots) ran op by op, ~110
launches a level over all kh*kw + 1 slots. The kernel visits only the
slots with m > 0 and recomputes instead of storing, so a level with L
layers is 2L + 1 passes, one launch each (``dense_window.dense_level_passes``):
layer l's mean pass, then its variance pass, each recomputing layers
0..l from the grids, then the max. A mean or variance pass returns the
per-batch-row sums (B, C) of m*h or m*(h - mean)**2 over the selected
slots; the statistics of earlier layers come in as (R, C) sums and one
divisor (the batch rows' sums and B*N*K, or under a mesh the all-reduced
means and 1), so the wrapper's all-reduce sits between passes.

The plain version computes the same passes on every slot in PyTorch and
is the op's CPU implementation (``ops/library.py``
``i2pnet::dense_level_pass``). The two differ only in the statistics'
order of summation. ``refusal`` is the gate of ``dense_pointnet_eval``:
the calls the kernel takes (CUDA tensors, a bf16 level, at most 32
selected slots a query, windows of at most 255 slots, L <= 4, widths up
to 256 and each layer's a multiple of 8, no gradient to carry); ``routes``
counts the kernel's calls and the plain chain's runs by reason
(``kernel``, ``plain:<reason>``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from i2pnet_tpu_torch.ops import _build
from i2pnet_tpu_torch.ops.pointops import safe_norm
from i2pnet_tpu_torch.ops.projection import strided_downsample, window_candidates

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0
# the dense eval levels by route: "kernel", or "plain:<reason>" (refusal's)
routes: collections.Counter = collections.Counter()

MEAN, VAR, MAX = 0, 1, 2
MODES = ("diff_feature", "center", "center_intens", "dist")
MAX_LAYERS, MAX_WIDTH, MAX_ROWS, MAX_SLOTS = 4, 256, 32, 256
_COUNTERS = 1024  # int32 arrival counters per device (one a batch row), zero between calls
_counters = {}  # the counters by device


def level_mode(center_mode: bool, dist_mode: bool, using_intens: bool) -> str:
    """The grouped features' mode of a call of ``ProjectPointNet``."""
    if center_mode:
        return "center_intens" if using_intens else "center"
    return "dist" if dist_mode else "diff_feature"


def candidates(grid: torch.Tensor, wargs) -> torch.Tensor:
    """Every window slot of every query of grid (B, h2, w2, C), then the
    sentinel slot, the grid's (0, 0) pixel: (B, N, kh*kw + 1, C)."""
    cand = window_candidates(grid, *wargs)[0]
    B, N, _, C = cand.shape
    sentinel = grid[:, 0, 0, :].reshape(B, 1, 1, C).expand(B, N, 1, C)
    return torch.cat([cand, sentinel], dim=2)


def grouped_features(src: torch.Tensor, cxyz: torch.Tensor, feature: torch.Tensor, out_h: int,
                     out_w: int, qstride: Tuple[int, int], kernel_size: Tuple[int, int],
                     mode: str) -> torch.Tensor:
    """The grouped features of every window slot (B, N, kh*kw + 1, C): src
    (B, h2, w2, 3) the candidates' points, whose strided cells are the
    centres; cxyz the warped grid, whose strided cells center mode takes;
    feature (B, h2, w2, Cf)."""
    B = src.shape[0]
    N = out_h * out_w
    wargs = (out_h, out_w, qstride, (1, 1), kernel_size, True)
    cand_xyz = candidates(src, wargs)
    ctr = strided_downsample(src, out_h, out_w, *qstride)
    grouped_norm = cand_xyz - ctr.reshape(B, N, 1, 3)
    if mode in ("center", "center_intens"):
        new_xyz = strided_downsample(cxyz, out_h, out_w, *qstride)
        parts = [grouped_norm, new_xyz.reshape(B, N, 1, 3).expand_as(cand_xyz), cand_xyz,
                 safe_norm(grouped_norm, dim=-1, keepdim=True)]
        if mode == "center_intens":
            parts.append(candidates(feature, wargs))
        return torch.cat(parts, dim=-1)
    if mode == "dist":  # every slot's distance to the centre, the sentinel's too
        return safe_norm(grouped_norm, dim=-1, keepdim=True)
    return torch.cat([grouped_norm, candidates(feature, wargs)], dim=-1)


def dense_layer(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A level's Dense (in ``dtype`` when given), its result in f32."""
    if dtype is not None:
        return (torch.matmul(x.to(dtype), weight.to(dtype).t()) + bias.to(dtype)).float()
    return torch.matmul(x, weight.t()) + bias


def normalize_relu(x, mean, var, scale, shift, eps: float) -> torch.Tensor:
    """BatchStatsNorm with the given statistics, then ReLU, in f32."""
    y = (x - mean) * torch.rsqrt(var + eps)
    return torch.relu(y * scale + shift)


def dense_level_pass_plain(src, cxyz, feature, m, weights: Sequence[torch.Tensor],
                           biases: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
                           shifts: Sequence[torch.Tensor], stats: Sequence[torch.Tensor],
                           denom: float, out_h: int, out_w: int, qstride: Tuple[int, int],
                           kernel_size: Tuple[int, int], nsample: int, mode: str, bf16: bool,
                           layer: int, kind: int, eps: float) -> torch.Tensor:
    """One pass on every slot: layers 0..layer (all for MAX), the statistics
    of layer j from stats[2j] (the mean's sums) and stats[2j + 1] (the
    variance's), each (R, C) summed over R and divided by ``denom``.
    Returns the per-batch-row sums (B, C) of m*h (MEAN) or m*(h - mean)**2
    (VAR) of the pass's layer, or the max over the slots with m > 0
    (B, out_h, out_w, C) f32 (MAX)."""
    B = m.shape[0]
    dtype = torch.bfloat16 if bf16 else None
    x = grouped_features(src, cxyz, feature, out_h, out_w, tuple(qstride), tuple(kernel_size),
                         mode)
    mw = m[..., None]
    depth = len(weights) if kind == MAX else layer + 1
    for j in range(depth):
        x = dense_layer(x, weights[j], biases[j], dtype)
        if j == depth - 1 and kind == MEAN:
            return torch.sum(x * mw, dim=(1, 2))
        mean = stats[2 * j].sum(0) / denom
        if j == depth - 1 and kind == VAR:
            return torch.sum(torch.square(x - mean) * mw, dim=(1, 2))
        x = normalize_relu(x, mean, stats[2 * j + 1].sum(0) / denom, scales[j], shifts[j], eps)
    x = torch.where(mw > 0, x, -torch.inf)
    return torch.amax(x, dim=2).reshape(B, out_h, out_w, -1)


def unsupported(src: torch.Tensor, cxyz: torch.Tensor, feature: torch.Tensor, m: torch.Tensor,
                weights: Sequence[torch.Tensor], nsample: int,
                dtype: Optional[torch.dtype]) -> Optional[str]:
    """Why the kernel cannot take such a level call, or None where it can:
    the shapes and layouts it was built for first, then the precision and
    the device."""
    if nsample > MAX_ROWS:
        return "nsample"
    if m.shape[-1] > MAX_SLOTS:
        return "window"
    if not 1 <= len(weights) <= MAX_LAYERS:
        return "depth"
    if (weights[0].shape[1] > MAX_WIDTH
            or any(w.shape[0] % 8 or w.shape[0] > MAX_WIDTH for w in weights)):
        return "width"
    if m.shape[0] > _COUNTERS:
        return "batch"
    if (feature.dtype not in (torch.float32, torch.bfloat16)
            or src.dtype != torch.float32 or cxyz.dtype != torch.float32
            or any(t.stride(-1) != 1 for t in (src, cxyz, feature))):
        return "layout"
    if dtype != torch.bfloat16:
        return "float32"
    if not m.is_cuda:
        return "cpu"
    return None


def refusal(src: torch.Tensor, cxyz: torch.Tensor, feature: torch.Tensor, m: torch.Tensor,
            weights: Sequence[torch.Tensor], nsample: int, dtype: Optional[torch.dtype],
            params: Sequence[torch.Tensor] = ()) -> Optional[str]:
    """The gate: why the kernel takes no such level call, or None where it
    does. A call a gradient could flow through (grad mode on, and a grid,
    the feature, a weight or one of ``params``, the level's other
    parameters, requiring grad) runs the differentiable plain chain, since
    the op has no backward; so does a call under CUDA-graph capture before
    the device's arrival counters exist, since their zeroing would only be
    recorded. Then ``unsupported``'s reasons."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (src, cxyz, feature, *weights, *params)):
        return "grad"
    why = unsupported(src, cxyz, feature, m, weights, nsample, dtype)
    if why is None and torch.cuda.is_current_stream_capturing() and m.device not in _counters:
        return "capture"
    return why


class _Args(ctypes.Structure):
    """``Args`` of ``csrc/dense_level.cu``, field for field."""

    _fields_ = [
        ("src", ctypes.c_void_p), ("cxyz", ctypes.c_void_p), ("feat", ctypes.c_void_p),
        ("m", ctypes.c_void_p),
        ("src_s", ctypes.c_longlong * 3), ("cxyz_s", ctypes.c_longlong * 3),
        ("feat_s", ctypes.c_longlong * 3),
        *((name, ctypes.c_int) for name in ("B", "h2", "w2", "out_h", "out_w", "qh", "qw", "kh",
                                             "kw", "cf", "feat_bf16", "mode", "L")),
        ("cin", ctypes.c_int * MAX_LAYERS), ("cout", ctypes.c_int * MAX_LAYERS),
        *((name, ctypes.c_void_p * MAX_LAYERS)
          for name in ("w", "bias", "scale", "shift", "mean_sum", "var_sum")),
        ("R", ctypes.c_int), ("denom", ctypes.c_float), ("eps", ctypes.c_float),
        ("layer", ctypes.c_int), ("kind", ctypes.c_int),
        ("out", ctypes.c_void_p), ("work", ctypes.c_void_p), ("counters", ctypes.c_void_p),
        ("bpr", ctypes.c_int),
    ]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("dense_level")
    lib.dense_level_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    lib.dense_level_launch.restype = ctypes.c_int
    return lib


def _counter_buffer(device) -> torch.Tensor:
    """The device's arrival counters: zeroed once, outside any graph capture
    (``refusal``), left zero by every call."""
    if device not in _counters:
        _counters[device] = torch.zeros(_COUNTERS, dtype=torch.int32, device=device)
    return _counters[device]


@functools.cache
def _blocks_per_row(device_index: int, B: int, queries: int) -> int:
    """A batch row's blocks of 4 warps: about eight blocks a SM over the
    batch (as many as the registers let stay resident), each warp striding
    over the row's queries."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return max(1, min(math.ceil(queries / 4), math.ceil(8 * sms / B)))


def dense_level_pass_cuda(src, cxyz, feature, m, weights: Sequence[torch.Tensor],
                          biases: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
                          shifts: Sequence[torch.Tensor], stats: Sequence[torch.Tensor],
                          denom: float, out_h: int, out_w: int, qstride: Tuple[int, int],
                          kernel_size: Tuple[int, int], nsample: int, mode: str, bf16: bool,
                          layer: int, kind: int, eps: float) -> torch.Tensor:
    """Launch ``csrc/dense_level.cu``: the plain version's pass, bf16 only,
    on CUDA tensors (the grids with unit channel stride, m contiguous)."""
    global launches
    B, h2, w2, _ = src.shape
    N = out_h * out_w
    (qh, qw), (kh, kw) = qstride, kernel_size
    L = len(weights)
    why = unsupported(src, cxyz, feature, m, weights, nsample, torch.bfloat16 if bf16 else None)
    if (why is not None or tuple(m.shape) != (B, N, kh * kw + 1) or not m.is_contiguous()
            or (out_h - 1) * qh >= h2 or (out_w - 1) * qw >= w2 or kind not in (MEAN, VAR, MAX)
            or any(weights[j].shape[1] != weights[j - 1].shape[0] for j in range(1, L))):
        raise ValueError(f"dense_level: unsupported call ({why}): src {tuple(src.shape)}, m "
                         f"{tuple(m.shape)}, widths {[tuple(w.shape) for w in weights]}")
    lib = _lib()
    f32 = [[t.float().contiguous() for t in ts] for ts in (weights, biases, scales, shifts)]
    stats = [s.float().contiguous() for s in stats]
    a = _Args()
    a.src, a.cxyz, a.feat, a.m = (_build.ptr(t) for t in (src, cxyz, feature, m))
    for name, t in (("src_s", src), ("cxyz_s", cxyz), ("feat_s", feature)):
        setattr(a, name, (ctypes.c_longlong * 3)(*t.stride()[:3]))
    a.B, a.h2, a.w2, a.out_h, a.out_w, a.qh, a.qw, a.kh, a.kw = B, h2, w2, out_h, out_w, qh, qw, \
        kh, kw
    a.cf, a.feat_bf16, a.mode, a.L = feature.shape[-1], feature.dtype == torch.bfloat16, \
        MODES.index(mode), L
    for j in range(L):
        a.cin[j], a.cout[j] = weights[j].shape[1], weights[j].shape[0]
        a.w[j], a.bias[j], a.scale[j], a.shift[j] = (_build.ptr(ts[j]) for ts in f32)
    for i, s in enumerate(stats):
        (a.mean_sum if i % 2 == 0 else a.var_sum)[i // 2] = _build.ptr(s)
    a.R = stats[0].shape[0] if stats else 1
    a.denom, a.eps, a.layer, a.kind = denom, eps, layer, kind
    a.bpr = _blocks_per_row(m.device.index, B, N)
    width = weights[-1 if kind == MAX else layer].shape[0]
    shape = (B, out_h, out_w, width) if kind == MAX else (B, width)
    out = torch.empty(shape, dtype=torch.float32, device=m.device)
    # the blocks' partial sums, held until the launch
    work = torch.empty(B * a.bpr * width if kind != MAX else 0, dtype=torch.float32,
                       device=m.device)
    a.out, a.work, a.counters = _build.ptr(out), _build.ptr(work), \
        _build.ptr(_counter_buffer(m.device))
    code = lib.dense_level_launch(ctypes.byref(a), 16 if nsample <= 16 else 32,
                                  _build.stream_of(m))
    _build.check(lib, code, "dense_level_launch")
    launches += 1
    return out
