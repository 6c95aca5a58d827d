"""The train-mode RGB-encoder blocks, differentiable: six CUDA kernels
(``csrc/conv_train.cu``, ``csrc/bn_pool_train.cu``) and their plain PyTorch
versions. Port of ``i2pnet_tpu/ops/conv_pallas_train.py`` with each of its
four pool backwards.

The kernels, each replacing one TPU kernel of that module:

  (a) ``conv_fwd_cuda`` / ``conv_dx_cuda`` (``_conv_kernel`` :103): the 3x3
      conv + bias, bf16 operands, f32 sums, bf16 out; the input gradient is
      the same kernel on the flipped-transposed weights with no bias. A
      block streams a strip of input rows of one column slab through a
      cp.async ring and computes 4 output rows an iteration for a tile of
      up to 64 output channels (``_conv_plan`` mirrors its launch plan);
  (b) ``conv_dw_cuda`` (``_dw_kernel`` :212 with ``unpack_dw``): the f32
      weight gradient in one launch: each block streams a chunk of image
      rows through a cp.async ring, once per operand, and the chunk
      partials are summed in a fixed order (``_dw_plan`` makes the split);
  (c) ``bn_pool_fwd_cuda`` (``_bn_pool_fwd_idx_kernel`` :656): ``y * sc +
      sh`` in f32, LeakyReLU(0.1), bf16, the 3x3 max-pool (stride s, pad 1),
      and the winning tap of each pooled cell (the first max in row-major
      order) as uint8; a block stages the input pixels that cover its tile
      of cells once, activates each once in shared memory and scans the
      cells' windows there;
  (d) ``bn_pool_bwd_cuda`` (``_bn_pool_bwd_idx_kernel`` :801): the pooled
      cotangent routed to the saved taps, summed in tap order, times the
      LeakyReLU slope, as f32 dz; a block stages the cells that cover its
      tile of pixels once, in shared memory;
  (e) ``bn_pool_fwd_notap_cuda`` (``_bn_pool_kernel`` :302): (c) without the
      taps, the same kernel template;
  (f) ``bn_pool_bwd_recompute_cuda`` (``_bn_pool_bwd_kernel`` :397): (d)'s
      dz from y, sc, sh and g alone, the taps recomputed: a block stages the
      y and g that its tile of pixels needs once, activates and scans as (c)
      and gathers as (d), the slope taken from z (not from a, which is -0
      both at z = -0, slope 1, and at a tiny z < 0, slope 0.1).

``bn_pool`` picks the backward as JAX's ``bn_pool`` does, from
``I2PNET_POOL_BWD`` (read at call time): ``idx`` (the default) runs (c) and
(d); ``native`` and ``sas`` run (e), then autograd of a plain formulation
(the merged max tree, whose ``torch.maximum`` halves the cotangent of a
tie as ``jnp.maximum`` does; ``F.max_pool2d``, first max); any other value
(``pallas``, the JAX package's name for it) runs (e) and (f). A call that
needs no gradient runs (e) alone on every backend, as the primal of JAX's
custom VJP.

All six are bound by bytes on the H100 (see the source notes), though (a)
and the small calls of each run below that bound's rate: each iteration's
chain of copies, mma chains and stores, and at 24x80 and 48x160 a block's
start, set their pace (measured, NVIDIA H100 80GB HBM3, 700.00 W). (b)
streams x and g once each through a shared-memory ring and sums in one
launch; an earlier design, which read x once per output-channel tile,
staged it by transposing stores and took a second launch, ran 2.4x
slower. (a) replaced a block per 16x16 output tile, staged whole and then
computed, that read its input once per 32-channel tile; (c) and (d)
grid-stride loops over (pixel, channel group) that divided 64-bit indices
and tested all 9 taps, (c) activating each input pixel once for each
window that holds it; (f) a block per 8x8 pixels that staged f32
activations, scanned them a channel at a time and read g from device
memory once per covering tap. Layouts
are NHWC, which has the memory of the JAX package's merged ``(B, H, W*C)``;
weights keep the port's ``nn.Conv2d`` layout ``(cout, cin, 3, 3)`` at
``conv_train``. Each ``*_cuda`` wrapper takes CUDA tensors only and counts
its launches in ``launches``; the dispatchers (``conv_fwd``, ...) take the
plain version for CPU tensors. The autograd functions look the dispatchers
up when they run, so a wrapper replaced on the module sees the backward's
calls too.

``stage_supported_train`` states where these kernels take a whole stage,
the port's counterpart of the JAX package's gate of the same name, with
the port's own limits; ``RGBEncoderStage`` runs the native chain
elsewhere. Where only one package's gate holds, the two differ only in
rounding points.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from i2pnet_tpu_torch.ops import _build
from i2pnet_tpu_torch.parallel.mesh import global_means

# kernel launches since the last reset (read by chip_smoke.py); one per
# call, each one CUDA launch
launches = dict.fromkeys(("conv_fwd", "conv_dx", "conv_dw", "bn_pool_fwd", "bn_pool_bwd",
                          "bn_pool_fwd_notap", "bn_pool_bwd_recompute"), 0)

_BF = torch.bfloat16
# (b)'s split (chip_smoke.py's per-shape times on the H100 chose them)
_DW_BLOCKS = 240
_DW_MIN_ROWS = 8
_DW_SLAB = 128  # pixels a column slab is wide at most
_DW_RAW_CIN = 5  # input channels up to which the x rows stay raw
_DW_CLUSTER = 8  # consecutive chunks whose blocks add their sums together
_DW_COUNTERS = 1024  # int32 arrival counters per device (one a tile), zero between calls


# ---- plain versions --------------------------------------------------------

def _conv_plain(x, w, bias):
    xf = x.float().permute(0, 3, 1, 2)
    y = F.conv2d(xf, w.float().permute(0, 3, 1, 2), padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias
    return y.to(_BF).contiguous()


def conv_fwd_plain(x, w, bias):
    """x (B,H,W,cin) bf16, w (cout,3,3,cin) bf16, bias (cout,) f32 ->
    y (B,H,W,cout) bf16: the products exact in f32, f32 sums, bias added in
    f32, one rounding. On the card, callers switch cuDNN's TF32 off."""
    return _conv_plain(x, w, bias)


def conv_dx_plain(g, wt):
    """g (B,H,W,cout) bf16, wt (cin,3,3,cout) bf16 the flipped-transposed
    weights -> dx (B,H,W,cin) bf16 (the conv with no bias)."""
    return _conv_plain(g, wt, None)


def conv_dw_plain(x, g):
    """x (B,H,W,cin) bf16, g (B,H,W,cout) bf16 -> dw (3,3,cin,cout) f32,
    dw[kh,kw] = sum over pixels of x shifted by (kh-1, kw-1), times g."""
    B, H, W, cin = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    gf = g.float().reshape(-1, g.shape[-1])
    taps = [xp[:, kh:kh + H, kw:kw + W].reshape(-1, cin).t() @ gf
            for kh in range(3) for kw in range(3)]
    return torch.stack(taps).reshape(3, 3, cin, g.shape[-1])


def _pool_taps(a, stride):
    """The 9 window taps of a (B,H,W,C) padded with -inf: views
    (B,Ho,Wo,C) in row-major (kh, kw) order."""
    B, H, W, C = a.shape
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    ap = F.pad(a, (0, 0, 1, 1, 1, 1), value=float("-inf"))
    return [ap[:, kh:kh + (Ho - 1) * stride + 1:stride, kw:kw + (Wo - 1) * stride + 1:stride]
            for kh in range(3) for kw in range(3)]


def _affine(y, sc, sh):
    return y.float() * sc + sh  # two roundings, as the kernels


def bn_pool_fwd_plain(y, sc, sh, stride: int):
    """y (B,H,W,C) bf16, sc/sh (C,) f32 -> (out (B,Ho,Wo,C) bf16, taps
    (B,Ho,Wo,C) uint8): the first max by strict >, as the JAX kernel's
    running-max scan."""
    z = _affine(y, sc, sh)
    a = torch.where(z >= 0, z, 0.1 * z).to(_BF).float()
    views = _pool_taps(a, stride)
    best = views[0]
    taps = torch.zeros(best.shape, dtype=torch.uint8, device=y.device)
    for k, v in enumerate(views[1:], start=1):
        upd = v > best
        taps = torch.where(upd, k, taps).to(torch.uint8)
        best = torch.where(upd, v, best)
    return best.to(_BF), taps


def bn_pool_bwd_plain(y, sc, sh, taps, g, stride: int):
    """dz (B,H,W,C) f32: for each pixel the pooled cotangents g (bf16)
    whose saved tap is this pixel, summed in tap order k = 0..8, times the
    LeakyReLU slope at z = y * sc + sh."""
    B, H, W, C = y.shape
    Ho, Wo = taps.shape[1:3]
    gf = g.float()
    acc = torch.zeros(B, (Ho - 1) * stride + 3, (Wo - 1) * stride + 3, C, device=y.device)
    for k in range(9):
        kh, kw = divmod(k, 3)
        view = acc[:, kh:kh + (Ho - 1) * stride + 1:stride, kw:kw + (Wo - 1) * stride + 1:stride]
        view += torch.where(taps == k, gf, 0.0)
    z = _affine(y, sc, sh)
    return acc[:, 1:H + 1, 1:W + 1] * torch.where(z >= 0, 1.0, 0.1)


def bn_pool_fwd_notap_plain(y, sc, sh, stride: int):
    """(B,Ho,Wo,C) bf16: ``bn_pool_fwd_plain``'s out, no taps."""
    z = _affine(y, sc, sh)
    a = torch.where(z >= 0, z, 0.1 * z).to(_BF).float()
    return functools.reduce(torch.maximum, _pool_taps(a, stride)).to(_BF)


def bn_pool_bwd_recompute_plain(y, sc, sh, g, stride: int):
    """dz (B,H,W,C) f32 as ``bn_pool_bwd_plain`` with the taps that
    ``bn_pool_fwd_plain`` finds."""
    return bn_pool_bwd_plain(y, sc, sh, bn_pool_fwd_plain(y, sc, sh, stride)[1], g, stride)


# ---- the CUDA kernels --------------------------------------------------------

@functools.cache
def _conv_lib() -> ctypes.CDLL:
    lib = _build.load("conv_train")
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_launch.argtypes = [v, v, v, v, i, i, i, i, i, v]
    lib.conv3x3_launch.restype = i
    lib.conv3x3_launch_plan.argtypes = [v, v, v, v] + [i] * 11 + [v]
    lib.conv3x3_launch_plan.restype = i
    lib.conv3x3_plan.argtypes = [i] * 6 + [v]
    lib.conv3x3_plan.restype = i
    lib.conv_dw_launch.argtypes = [v, v, v, v, v] + [i] * 12 + [v]
    lib.conv_dw_launch.restype = i
    return lib


@functools.cache
def _pool_lib() -> ctypes.CDLL:
    lib = _build.load("bn_pool_train")
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.bn_pool_fwd_launch.argtypes = [v, v, v, v, v, i, i, i, i, i, v]
    lib.bn_pool_fwd_launch.restype = i
    lib.bn_pool_bwd_launch.argtypes = [v, v, v, v, v, v, i, i, i, i, i, v]
    lib.bn_pool_bwd_launch.restype = i
    lib.bn_pool_fwd_notap_launch.argtypes = [v, v, v, v, i, i, i, i, i, v]
    lib.bn_pool_fwd_notap_launch.restype = i
    lib.bn_pool_bwd_recompute_launch.argtypes = [v, v, v, v, v, i, i, i, i, i, v]
    lib.bn_pool_bwd_recompute_launch.restype = i
    return lib


def _lib():
    """Build (if needed) and load both kernel libraries."""
    return _conv_lib(), _pool_lib()


def _require(t, dtype, shape, what):
    _build.require_cuda(t, dtype, what)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: expected 16-byte alignment")


def _conv3x3(x, w, bias, what):
    B, H, W, cin = x.shape
    cout = w.shape[0]
    _require(x, _BF, (B, H, W, cin), f"{what} x")
    _require(w, _BF, (cout, 3, 3, cin), f"{what} w")
    if bias is not None:
        _require(bias, torch.float32, (cout,), f"{what} bias")
    if cout % 8:
        raise ValueError(f"{what}: {cout} output channels, not a multiple of 8")
    if _conv_plan(B, H, W, cin, cout) is None:
        raise ValueError(f"{what}: no launch plan for {(B, H, W, cin, cout)}")
    y = torch.empty(B, H, W, cout, dtype=_BF, device=x.device)
    lib = _conv_lib()
    code = lib.conv3x3_launch(
        _build.ptr(x), _build.ptr(w), None if bias is None else _build.ptr(bias), _build.ptr(y),
        B, H, W, cin, cout, _build.stream_of(x))
    _build.check(lib, code, "conv3x3_launch")
    launches[what] += 1
    return y


def conv_plan_on_card(B: int, H: int, W: int, cin: int, cout: int, device=None) -> ConvPlan:
    """The plan ``conv3x3_launch`` takes on this card (``conv_plan`` in the
    source, on its SM count), for holding ``_conv_plan`` to it."""
    out = (ctypes.c_int * 6)()
    sms = torch.cuda.get_device_properties(device or torch.cuda.current_device()).multi_processor_count
    lib = _conv_lib()
    _build.check(lib, lib.conv3x3_plan(B, H, W, cin, cout, sms, out), "conv3x3_plan")
    return ConvPlan(*out)


def conv_fwd_cuda(x, w, bias):
    """Kernel (a) forward; operands as ``conv_fwd_plain``, contiguous CUDA
    tensors, cout % 8 == 0."""
    return _conv3x3(x, w, bias, "conv_fwd")


def conv_dx_cuda(g, wt):
    """Kernel (a) on the cotangent; operands as ``conv_dx_plain``."""
    return _conv3x3(g, wt, None, "conv_dx")


class DwPlan(NamedTuple):
    """Kernel (b)'s split of one call, a function of the shape alone.

    Chunk c covers batch row ``c // (slabs * rowchunks)``, the columns
    ``[s * sw, (s + 1) * sw)`` with ``s = c // rowchunks % slabs`` and the
    rows ``[rc * rows, (rc + 1) * rows)`` with ``rc = c % rowchunks``, each
    clipped to the image (``dw_chunks``). Grid: (nchunks rounded up to
    clusters of ``_DW_CLUSTER``, ci tiles, co tiles); ci_t x co_t is a
    block's channel tile, where for cin <= 5 (the raw-row path) ci_t is the
    M of its 3 x 16 (kh, kw, channel) rows. A cluster's blocks add their
    sums in block order, then the clusters' partials are added in cluster
    order."""

    raw: bool
    ci_t: int
    co_t: int
    citiles: int
    cotiles: int
    sw: int
    slabs: int
    rows: int
    rowchunks: int
    nchunks: int

    @property
    def nclusters(self) -> int:
        return -(-self.nchunks // _DW_CLUSTER)

    @property
    def tile_floats(self) -> int:
        """f32 of one block's partial: M x co_t."""
        return (self.ci_t if self.raw else 9 * self.ci_t) * self.co_t


def _dw_plan(B: int, H: int, W: int, cin: int, cout: int) -> DwPlan:
    raw = cin <= _DW_RAW_CIN
    if raw:  # 3 kh x 16 rows of (kw, ci)
        ci_t, citiles = 48, 1
    else:
        ci_t = min(64, max(16, 1 << (cin - 1).bit_length()))
        citiles = -(-cin // ci_t)
    co_t = 16 if cout <= 16 else 32
    cotiles = -(-cout // co_t)
    slabs = -(-W // _DW_SLAB)
    sw = -(-(-(-W // slabs)) // 16) * 16
    # rows per chunk: about _DW_BLOCKS blocks (one wave at two a SM), but at
    # least _DW_MIN_ROWS rows a block, which the fixed cost of a block (its
    # first loads, its sums) would otherwise dominate
    tiles = citiles * cotiles
    rows = min(H, max(_DW_MIN_ROWS, -(-B * slabs * H // -(-_DW_BLOCKS // tiles))))
    rowchunks = -(-H // rows)
    rows = -(-H // rowchunks)
    return DwPlan(raw, ci_t, co_t, citiles, cotiles, sw, slabs, rows, rowchunks,
                  B * slabs * rowchunks)


def dw_chunks(plan: DwPlan, H: int, W: int):
    """The (batch row, row range, column range) of every chunk, in chunk
    order, as kernel (b) reads them."""
    for c in range(plan.nchunks):
        b, s, rc = c // (plan.slabs * plan.rowchunks), c // plan.rowchunks % plan.slabs, \
            c % plan.rowchunks
        yield (b, (rc * plan.rows, min(H, (rc + 1) * plan.rows)),
               (s * plan.sw, min(W, (s + 1) * plan.sw)))


# kernel (a)'s launch plan (csrc/conv_train.cu conv_layout / conv_plan mirror it)
_CONV_ROWS = 4  # output rows an iteration computes
_CONV_RAW_CIN = 5  # input channels up to which the rows stay raw
_CONV_EXP_SLOTS = 10  # raw path: rows expanded to 4 or 8 channels a pixel
_SM_SMEM = 233472  # shared memory of a SM
_BLOCK_RESERVE = 1024 + 128  # per block: the runtime's 1 KB and the static raw_at
_CONV_SMEM_MAX = 232448 - 128  # dynamic shared memory a block may take
_SMS = 132  # the H100's SMs, for plans made off the card
_CONV_START_ROWS = 12  # a block's start (weights, first 6 rows), in rows of work


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _conv_smem(cin: int, co_t: int, mt: int) -> int:
    """Bytes of kernel (a)'s dynamic shared memory (``conv_layout`` in the
    source): the tile's weights, the input-row ring (10 slots; 14 raw rows
    for cin <= 5, with 10 of their 4- or 8-channel expansions), 4 staged
    output rows and the bias."""
    raw = cin <= _CONV_RAW_CIN
    cw, cinp = 16 * mt, _round_up(cin, 16)
    c4 = 4 if cin <= 4 else 8
    kh16 = _round_up(3 * c4, 16)
    kp = 3 * kh16 if raw else 9 * cinp
    xslot = _round_up((cw + 2) * cin + 14, 8) if raw else (cw + 2) * (cinp + 8)
    expanded = _CONV_EXP_SLOTS * (cw + kh16 // c4 + 1) * c4 if raw else 0
    weights = _round_up(_round_up(co_t, 16) * (kp + 8) * 2, 16)
    stages = 14 if raw else 10
    return (weights + 2 * stages * xslot + 2 * expanded + 2 * _CONV_ROWS * cw * (co_t + 8)
            + 4 * co_t)


class ConvPlan(NamedTuple):
    """Kernel (a)'s split of one call. Block (batch row, slab, strip,
    channel tile) computes the output columns ``[s * sw, (s + 1) * sw)``,
    rows ``[rc * rows, (rc + 1) * rows)`` (clipped to the image) and the
    channels ``[ct * co_t, (ct + 1) * co_t)``; its slab row is ``16 * mt``
    pixels wide."""

    co_t: int
    mt: int
    sw: int
    slabs: int
    rows: int
    rowchunks: int


def _conv_slab(W: int, cin: int, co_t: int, budget: int):
    """(mt, sw, slabs) of the widest slab whose layout fits budget, or None."""
    for mt_cap in range(8, 0, -1):
        slabs = -(-W // (16 * mt_cap))
        sw = -(-W // slabs)
        mt = -(-sw // 16)
        if _conv_smem(cin, co_t, mt) <= budget:
            return mt, sw, slabs
    return None


def _conv_plan(B: int, H: int, W: int, cin: int, cout: int, sms: int = _SMS) -> Optional[ConvPlan]:
    """``conv_plan`` of the source: the widest channel tile (a multiple of 8
    dividing cout, <= 64) whose layout fits a block at all; the widest slab
    (<= 128 pixels) whose layout lets 3 blocks share a SM if it is at least
    4 m16 tiles wide, else 2, else 1. The channel tile halved where even one
    block per 4 rows would leave SMs empty; the rows cut into strips
    (multiples of 4) that fill one wave of resident blocks. None where no
    layout fits or the kernel takes no such call."""
    if cout % 8 or cin < 1 or min(B, H, W) < 1:
        return None
    co_t = next((d for d in range(min(cout, 64) // 8 * 8, 7, -8)
                 if cout % d == 0 and _conv_smem(cin, d, 1) <= _CONV_SMEM_MAX), None)
    if co_t is None:
        return None
    slab = _conv_slab(W, cin, co_t, _SM_SMEM // 3 - _BLOCK_RESERVE)
    if slab is None or slab[0] < 4:
        slab = (_conv_slab(W, cin, co_t, _SM_SMEM // 2 - _BLOCK_RESERVE)
                or _conv_slab(W, cin, co_t, _CONV_SMEM_MAX))
    plan = (co_t, *slab)
    co_t, mt, sw, slabs = plan
    maxrc = -(-H // _CONV_ROWS)
    while B * slabs * (cout // co_t) * maxrc < sms and co_t % 16 == 0:
        co_t //= 2
    strips = B * slabs * (cout // co_t)
    # one wave of the blocks the SMs hold, or two where that spreads the
    # rows more evenly: the fewer (blocks a SM) x (rows + a block's start),
    # ties to one wave
    per_sm = min(3, _SM_SMEM // (_conv_smem(cin, co_t, mt) + _BLOCK_RESERVE))

    rc1 = max(1, min(maxrc, per_sm * sms // strips))

    def cut(waves):
        rc = min(maxrc, rc1 * waves)
        rows = _round_up(-(-H // rc), _CONV_ROWS)
        return -(-strips * -(-H // rows) // sms) * (rows + _CONV_START_ROWS), rows

    rows = cut(2)[1] if cut(2)[0] < cut(1)[0] else cut(1)[1]
    return ConvPlan(co_t, mt, sw, slabs, rows, -(-H // rows))


def conv_blocks(plan: ConvPlan, B: int, H: int, W: int, cout: int):
    """The (batch row, row range, column range, channel range) of every
    block of kernel (a), in block order, as the kernel reads them."""
    cotiles = cout // plan.co_t
    for blk in range(B * plan.slabs * plan.rowchunks * cotiles):
        ct, rest = blk % cotiles, blk // cotiles
        rc, rest = rest % plan.rowchunks, rest // plan.rowchunks
        s, b = rest % plan.slabs, rest // plan.slabs
        yield (b, (rc * plan.rows, min(H, (rc + 1) * plan.rows)),
               (s * plan.sw, min(W, (s + 1) * plan.sw)), (ct * plan.co_t, (ct + 1) * plan.co_t))


def stage_supported_train(H: int, W: int, cin: int, channels: Sequence[int],
                          strides: Sequence[int], input_grad: bool = False) -> bool:
    """True if the train kernels take every block of the stage: stride 1
    or 2; cout a multiple of 8 (kernel (a)'s forward and bn_pool's C);
    a launch plan of kernel (a) (its layout within a block's shared memory)
    for the forward and, where
    the block's input takes a gradient (every block after the first, and
    the first with ``input_grad``), for dx, whose output channels (cin)
    must then be a multiple of 8 too; and dw's tiles within its counter
    buffer. The port's counterpart of the JAX package's
    ``stage_supported_train``, with the port's own limits."""
    for j, (cout, s) in enumerate(zip(channels, strides)):
        if s not in (1, 2) or cout % 8 or cout < 8 or _conv_plan(1, H, W, cin, cout) is None:
            return False
        if (j > 0 or input_grad) and (cin % 8 or _conv_plan(1, H, W, cout, cin) is None):
            return False
        p = _dw_plan(1, H, W, cin, cout)
        if p.citiles * p.cotiles > _DW_COUNTERS:
            return False
        H, W, cin = (H - 1) // s + 1, (W - 1) // s + 1, cout
    return True


_dw_counters = {}


def _dw_counter_buffer(device) -> torch.Tensor:
    """The device's arrival counters of kernel (b): zeroed once, left zero
    by every call (the last block resets them), so a call allocates none
    and a CUDA graph may capture it. Calls on one device share them, so
    they must not run concurrently on two streams."""
    if device not in _dw_counters:
        _dw_counters[device] = torch.zeros(_DW_COUNTERS, dtype=torch.int32, device=device)
    return _dw_counters[device]


def conv_dw_cuda(x, g):
    """Kernel (b); operands as ``conv_dw_plain``, cout % 8 == 0."""
    B, H, W, cin = x.shape
    cout = g.shape[-1]
    _require(x, _BF, (B, H, W, cin), "conv_dw x")
    _require(g, _BF, (B, H, W, cout), "conv_dw g")
    if cout % 8:
        raise ValueError(f"conv_dw: {cout} output channels, not a multiple of 8")
    p = _dw_plan(B, H, W, cin, cout)
    tiles = p.citiles * p.cotiles
    if tiles > _DW_COUNTERS:
        raise ValueError(f"conv_dw: shape {(B, H, W, cin, cout)} needs too many counters")
    work = torch.empty(tiles * p.nclusters * p.tile_floats, dtype=torch.float32, device=x.device)
    dw = torch.empty(3, 3, cin, cout, dtype=torch.float32, device=x.device)
    lib = _conv_lib()
    code = lib.conv_dw_launch(
        _build.ptr(x), _build.ptr(g), _build.ptr(work), _build.ptr(_dw_counter_buffer(x.device)),
        _build.ptr(dw), B, H, W, cin, cout, p.ci_t, p.co_t, p.sw, p.slabs, p.rows, p.rowchunks,
        p.nchunks, _build.stream_of(x))
    _build.check(lib, code, "conv_dw_launch")
    launches["conv_dw"] += 1
    return dw


def _pool_shape(y, sc, sh, stride, what):
    B, H, W, C = y.shape
    _require(y, _BF, (B, H, W, C), f"{what} y")
    _require(sc, torch.float32, (C,), f"{what} sc")
    _require(sh, torch.float32, (C,), f"{what} sh")
    if C % 8 or stride not in (1, 2):
        raise ValueError(f"{what}: unsupported C={C}, stride={stride}")
    return B, H, W, C, (H - 1) // stride + 1, (W - 1) // stride + 1


def bn_pool_fwd_cuda(y, sc, sh, stride: int):
    """Kernel (c); operands as ``bn_pool_fwd_plain``, C % 8 == 0."""
    B, H, W, C, Ho, Wo = _pool_shape(y, sc, sh, stride, "bn_pool_fwd")
    out = torch.empty(B, Ho, Wo, C, dtype=_BF, device=y.device)
    taps = torch.empty(B, Ho, Wo, C, dtype=torch.uint8, device=y.device)
    lib = _pool_lib()
    code = lib.bn_pool_fwd_launch(
        _build.ptr(y), _build.ptr(sc), _build.ptr(sh), _build.ptr(out), _build.ptr(taps),
        B, H, W, C, stride, _build.stream_of(y))
    _build.check(lib, code, "bn_pool_fwd_launch")
    launches["bn_pool_fwd"] += 1
    return out, taps


def bn_pool_bwd_cuda(y, sc, sh, taps, g, stride: int):
    """Kernel (d); operands as ``bn_pool_bwd_plain``."""
    B, H, W, C, Ho, Wo = _pool_shape(y, sc, sh, stride, "bn_pool_bwd")
    _require(taps, torch.uint8, (B, Ho, Wo, C), "bn_pool_bwd taps")
    _require(g, _BF, (B, Ho, Wo, C), "bn_pool_bwd g")
    dz = torch.empty(B, H, W, C, dtype=torch.float32, device=y.device)
    lib = _pool_lib()
    code = lib.bn_pool_bwd_launch(
        _build.ptr(y), _build.ptr(sc), _build.ptr(sh), _build.ptr(taps), _build.ptr(g),
        _build.ptr(dz), B, H, W, C, stride, _build.stream_of(y))
    _build.check(lib, code, "bn_pool_bwd_launch")
    launches["bn_pool_bwd"] += 1
    return dz


def bn_pool_fwd_notap_cuda(y, sc, sh, stride: int):
    """Kernel (e); operands as ``bn_pool_fwd_notap_plain``, C % 8 == 0."""
    B, H, W, C, Ho, Wo = _pool_shape(y, sc, sh, stride, "bn_pool_fwd_notap")
    out = torch.empty(B, Ho, Wo, C, dtype=_BF, device=y.device)
    lib = _pool_lib()
    code = lib.bn_pool_fwd_notap_launch(
        _build.ptr(y), _build.ptr(sc), _build.ptr(sh), _build.ptr(out),
        B, H, W, C, stride, _build.stream_of(y))
    _build.check(lib, code, "bn_pool_fwd_notap_launch")
    launches["bn_pool_fwd_notap"] += 1
    return out


def bn_pool_bwd_recompute_cuda(y, sc, sh, g, stride: int):
    """Kernel (f); operands as ``bn_pool_bwd_recompute_plain``."""
    B, H, W, C, Ho, Wo = _pool_shape(y, sc, sh, stride, "bn_pool_bwd_recompute")
    _require(g, _BF, (B, Ho, Wo, C), "bn_pool_bwd_recompute g")
    dz = torch.empty(B, H, W, C, dtype=torch.float32, device=y.device)
    lib = _pool_lib()
    code = lib.bn_pool_bwd_recompute_launch(
        _build.ptr(y), _build.ptr(sc), _build.ptr(sh), _build.ptr(g), _build.ptr(dz),
        B, H, W, C, stride, _build.stream_of(y))
    _build.check(lib, code, "bn_pool_bwd_recompute_launch")
    launches["bn_pool_bwd_recompute"] += 1
    return dz


# ---- dispatch: the kernel for CUDA tensors, the plain version for CPU ones ---

def conv_fwd(x, w, bias):
    return conv_fwd_cuda(x, w, bias) if x.is_cuda else conv_fwd_plain(x, w, bias)


def conv_dx(g, wt):
    return conv_dx_cuda(g, wt) if g.is_cuda else conv_dx_plain(g, wt)


def conv_dw(x, g):
    return conv_dw_cuda(x, g) if x.is_cuda else conv_dw_plain(x, g)


def bn_pool_fwd(y, sc, sh, stride: int):
    return bn_pool_fwd_cuda(y, sc, sh, stride) if y.is_cuda else bn_pool_fwd_plain(y, sc, sh, stride)


def bn_pool_bwd(y, sc, sh, taps, g, stride: int):
    if y.is_cuda:
        return bn_pool_bwd_cuda(y, sc, sh, taps, g, stride)
    return bn_pool_bwd_plain(y, sc, sh, taps, g, stride)


def bn_pool_fwd_notap(y, sc, sh, stride: int):
    if y.is_cuda:
        return bn_pool_fwd_notap_cuda(y, sc, sh, stride)
    return bn_pool_fwd_notap_plain(y, sc, sh, stride)


def bn_pool_bwd_recompute(y, sc, sh, g, stride: int):
    if y.is_cuda:
        return bn_pool_bwd_recompute_cuda(y, sc, sh, g, stride)
    return bn_pool_bwd_recompute_plain(y, sc, sh, g, stride)


# ---- autograd ----------------------------------------------------------------

class _ConvTrain(torch.autograd.Function):
    """(x (B,H,W,cin), w (cout,cin,3,3) f32, b (cout,) f32) -> y bf16, as
    ``_make_conv_train`` (conv_pallas_train.py:1124-1178)."""

    @staticmethod
    def forward(ctx, x, w, b):
        x = x.to(_BF).contiguous()
        ctx.save_for_backward(x, w)
        return conv_fwd(x, w.permute(0, 2, 3, 1).to(_BF).contiguous(), b.float().contiguous())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(_BF).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            # transposed conv = the conv of g with w flipped in space, its
            # channel axes swapped: wt[ci, kh, kw, co] = w[co, ci, 2-kh, 2-kw]
            dx = conv_dx(g, w.flip(2, 3).permute(1, 2, 3, 0).to(_BF).contiguous())
        dw = conv_dw(x, g).permute(3, 2, 0, 1)
        db = g.float().sum((0, 1, 2))
        return dx, dw, db


def _bn_pool_grads(dz, y, sc):
    """(dy bf16, dsc, dsh) from dz, as conv_pallas_train.py:1003-1006."""
    return (dz * sc).to(_BF), (dz * y.float()).sum((0, 1, 2)), dz.sum((0, 1, 2))


class _BnPool(torch.autograd.Function):
    """(y bf16, sc f32, sh f32) -> pooled bf16, as ``_make_bn_pool``'s idx
    pair (conv_pallas_train.py:1053-1076)."""

    @staticmethod
    def forward(ctx, y, sc, sh, stride):
        out, taps = bn_pool_fwd(y, sc, sh, stride)
        ctx.save_for_backward(y, sc, sh, taps)
        ctx.stride = stride
        return out

    @staticmethod
    def backward(ctx, g):
        y, sc, sh, taps = ctx.saved_tensors
        dz = bn_pool_bwd(y, sc, sh, taps, g.to(_BF).contiguous(), ctx.stride)
        return *_bn_pool_grads(dz, y, sc), None


def _leaky_st(y, sc, sh):
    """LeakyReLU(y * sc + sh) in f32 with the bf16 rounding straight
    through: bf16 values forward, the cotangent stays f32 (JAX's native and
    sas formulations)."""
    z = y.float() * sc + sh
    a = torch.where(z >= 0, z, 0.1 * z)
    return a + (a.to(_BF).float() - a).detach()


def _bn_pool_native_merged(y, sc, sh, stride):
    """JAX's ``_bn_pool_native_merged`` (conv_pallas_train.py:614-653) on
    NHWC: the pool as a max tree over column then row shifts (pad -inf,
    which no finite activation equals), then subsampled."""
    a = _leaky_st(y, sc, sh)
    wl = F.pad(a[:, :, :-1], (0, 0, 1, 0), value=float("-inf"))
    wr = F.pad(a[:, :, 1:], (0, 0, 0, 1), value=float("-inf"))
    wmax = torch.maximum(a, torch.maximum(wl, wr))
    up = F.pad(wmax[:, :-1], (0, 0, 0, 0, 1, 0), value=float("-inf"))
    dn = F.pad(wmax[:, 1:], (0, 0, 0, 0, 0, 1), value=float("-inf"))
    rmax = torch.maximum(wmax, torch.maximum(up, dn))
    return rmax[:, ::stride, ::stride].to(_BF)


def _bn_pool_sas(y, sc, sh, stride):
    """JAX's unmerged ``reduce_window`` formulation (:1035-1047), whose
    gradient goes to the first max (``F.max_pool2d``'s backward)."""
    a = _leaky_st(y, sc, sh).permute(0, 3, 1, 2)
    return F.max_pool2d(a, 3, stride, 1).permute(0, 2, 3, 1).to(_BF)


class _BnPoolRecompute(torch.autograd.Function):
    """(y, sc, sh) -> pooled bf16 with kernel (e) forward, saving no taps;
    the backward is (f) (JAX's pallas backend, :996-1007)."""

    @staticmethod
    def forward(ctx, y, sc, sh, stride):
        ctx.save_for_backward(y, sc, sh)
        ctx.stride = stride
        return bn_pool_fwd_notap(y, sc, sh, stride)

    @staticmethod
    def backward(ctx, g):
        y, sc, sh = ctx.saved_tensors
        dz = bn_pool_bwd_recompute(y, sc, sh, g.to(_BF).contiguous(), ctx.stride)
        return *_bn_pool_grads(dz, y, sc), None


class _BnPoolFormulation(torch.autograd.Function):
    """(y, sc, sh) -> pooled bf16 with kernel (e) forward, saving no taps;
    the backward is autograd of a plain formulation (JAX's native and sas
    backends, :1009-1051)."""

    @staticmethod
    def forward(ctx, y, sc, sh, stride, formulation):
        ctx.save_for_backward(y, sc, sh)
        ctx.stride, ctx.formulation = stride, formulation
        return bn_pool_fwd_notap(y, sc, sh, stride)

    @staticmethod
    def backward(ctx, g):
        y, sc, sh = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (y, sc, sh)]
            out = ctx.formulation(*leaves, ctx.stride)
            dy, dsc, dsh = torch.autograd.grad(out, leaves, g.to(_BF))
        return dy, dsc, dsh, None, None


_FORMULATIONS = {"native": _bn_pool_native_merged, "sas": _bn_pool_sas}


def conv_train(x, w, b):
    """Differentiable 3x3 conv + bias: x (B,H,W,cin) (cast to bf16), w
    (cout,cin,3,3) f32, b (cout,) f32 -> (B,H,W,cout) bf16."""
    return _ConvTrain.apply(x, w, b)


def bn_pool(y, sc, sh, stride: int):
    """Differentiable scale/shift -> LeakyReLU(0.1) -> bf16 -> 3x3 max-pool
    (stride s, pad 1): y (B,H,W,C) bf16, sc/sh (C,) f32 -> (B,Ho,Wo,C) bf16.
    The backward follows ``I2PNET_POOL_BWD`` (module docstring); without a
    gradient to take, kernel (e) alone."""
    y, sc, sh = y.contiguous(), sc.float().contiguous(), sh.float().contiguous()
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (y, sc, sh))):
        return bn_pool_fwd_notap(y, sc, sh, stride)
    bwd = os.environ.get("I2PNET_POOL_BWD", "idx")
    if bwd == "idx":
        return _BnPool.apply(y, sc, sh, stride)
    if bwd in _FORMULATIONS:
        return _BnPoolFormulation.apply(y, sc, sh, stride, _FORMULATIONS[bwd])
    # "pallas", and any other value, as JAX's ``.get(bwd, f_bwd_pallas)`` (:1081)
    return _BnPoolRecompute.apply(y, sc, sh, stride)


def fused_stage_train(x, blocks, strides, eps: float = 1e-5):
    """One RGB-encoder stage in train mode, as ``fused_stage_train``
    (conv_pallas_train.py:1218-1274): x (B,H,W,cin); blocks per block
    (w (cout,cin,3,3), b, gamma, beta). Per block: ``conv_train``, the batch
    moments of the bf16 conv output in f32 (``var = mean2 - mean**2``,
    unclipped), ``sc = gamma * rsqrt(var + eps)``, ``sh = beta - mean *
    sc``, then ``bn_pool``. The stats coupling is plain autograd.

    Under an ambient mesh (``parallel/mesh.py``) the kernels run on this
    rank's rows and ``s1 = sum y``, ``s2 = sum y**2`` and n are all-reduced,
    differentiably, before the moments, as the JAX package psums them
    inside its per-shard ``shard_map`` (conv_pallas_train.py:1261-1264).

    Returns ((B,Ho,Wo,channels[-1]) bf16, [(mean_j, var_j), ...])."""
    x = x.to(_BF)
    stats = []
    for (w, b, gamma, beta), s in zip(blocks, strides):
        y = conv_train(x, w, b)
        yf = y.float()
        moments = global_means([yf, yf * yf], (0, 1, 2))
        if moments is None:
            n = y.shape[0] * y.shape[1] * y.shape[2]
            mean = yf.sum((0, 1, 2)) / n
            mean2 = (yf * yf).sum((0, 1, 2)) / n
        else:
            mean, mean2 = moments
        var = mean2 - mean * mean
        sc = gamma.float() * torch.rsqrt(var + eps)
        sh = beta.float() - mean * sc
        x = bn_pool(y, sc, sh, s)
        stats.append((mean, var))
    return x, stats
