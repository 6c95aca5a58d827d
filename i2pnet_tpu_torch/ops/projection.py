"""Range-image (spherical projection) ops (port of
``i2pnet_tpu/ops/projection.py``).

* ``spherical_project`` scatters a raw cloud into an (H, W) range image;
  one point wins each cell: the last in input order (``use_rank=False``,
  the shipped config) or the nearest (``use_rank=True``), both decided by
  deterministic scatter reductions of point indices.
* ``window_neighbor_select_grid`` is the windowed K-nearest select of the
  reference's fused_conv_select_k kernel for regular-grid queries: scan a
  kh x kw window of a (possibly strided) second grid, reject empty pixels,
  out-of-image rows and pixels beyond ``distance``, keep the K nearest.
  ``shift`` wraps the columns cylindrically; ``copy`` fills missing
  neighbours with the nearest hit. Selection is a stable sort of the masked
  distances, so equal distances keep the lowest window slot first, as
  ``lax.top_k`` does (``torch.topk`` leaves their order unspecified).
* ``select_window_features(_multi)`` gathers grid features for those
  selections; slot ``kh*kw`` is the sentinel, the grid's (0, 0) pixel.
  Both build their candidates by im2col (``_patches_candidates``) wherever
  the geometry allows it (stride-1 windows on cylindrical columns), else by
  two index gathers (``window_candidates``): the same candidates bit for
  bit, and on the card im2col is the faster at every such call of the
  shipped proj model, forward and backward (``chip_smoke.py`` phase 33), so
  the JAX package's opt-in switch ``I2PNET_GRID_PATCHES`` has no
  counterpart here. A backward sums a grid's repeated slots in another
  order than the gathers' backward, so gradients move at rounding level.
* ``window_neighbor_select`` is the same select for queries at any grid
  coordinates, returning (h, w) indices for ``gather_grid``;
  ``strided_grid_indices`` gives a regular grid's coordinates and
  ``pixel_posinfo`` every pixel centre's normalised-plane coordinates.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

INVALID_DIST = 1e10


def _patches_eligible(out_h, out_w, qstride, stride, h2, w2, shift) -> bool:
    """Whether the im2col candidate builder applies: windows centred on the
    queries themselves (stride 1), cylindrical columns, and the patches'
    geometry landing on (out_h, out_w)."""
    if tuple(stride) != (1, 1) or not shift:
        return False
    oh = (h2 - 1) // qstride[0] + 1
    ow = (w2 - 1) // qstride[1] + 1
    return oh == out_h and ow == out_w


def _patches_candidates(src: torch.Tensor, out_h: int, out_w: int, qstride: Tuple[int, int],
                        kernel_size: Tuple[int, int]) -> torch.Tensor:
    """The window candidates of src (B, h2, w2, C) as im2col patches, laid
    out (B, out_h*out_w, C, kh*kw): the columns wrapped by concatenating the
    edge strips, the rows padded with exact zeros (an empty pixel, which
    the select rejects as the default builder's in-bounds mask does)."""
    B, h2, w2, C = src.shape
    kh, kw = kernel_size
    x = torch.cat([src[:, :, w2 - kw // 2:], src, src[:, :, : kw - 1 - kw // 2]], dim=2)
    x = F.pad(x.permute(0, 3, 1, 2), (0, 0, kh // 2, kh - 1 - kh // 2))  # (B, C, H', W')
    p = x.unfold(2, kh, qstride[0]).unfold(3, kw, qstride[1])  # (B, C, out_h, out_w, kh, kw)
    return p.permute(0, 2, 3, 1, 4, 5).reshape(B, out_h * out_w, C, kh * kw)


def check_valid(xyz: torch.Tensor) -> torch.Tensor:
    """1.0 where any coordinate is nonzero, (..., 1) f32."""
    return torch.any(xyz != 0, dim=-1, keepdim=True).float()


def grid_indices(B: int, H: int, W: int, device=None) -> torch.Tensor:
    """(B, H*W, 2) int32 (h, w) coordinates, row-major."""
    h = torch.arange(H, dtype=torch.int32, device=device)
    w = torch.arange(W, dtype=torch.int32, device=device)
    hh, ww = torch.meshgrid(h, w, indexing="ij")
    return torch.stack([hh, ww], dim=-1).reshape(1, H * W, 2).expand(B, H * W, 2)


def strided_grid_indices(B: int, out_h: int, out_w: int, stride_h: int, stride_w: int,
                         device=None) -> torch.Tensor:
    """(B, out_h*out_w, 2) int32 coordinates of the strided grid in the
    fine frame, row-major."""
    h = torch.arange(out_h, dtype=torch.int32, device=device) * stride_h
    w = torch.arange(out_w, dtype=torch.int32, device=device) * stride_w
    hh, ww = torch.meshgrid(h, w, indexing="ij")
    return torch.stack([hh, ww], dim=-1).reshape(1, out_h * out_w, 2).expand(B, out_h * out_w, 2)


def gather_grid(feature: torch.Tensor, h_idx: torch.Tensor, w_idx: torch.Tensor) -> torch.Tensor:
    """feature (B, H, W, C) at per-batch (h, w) index arrays of any shape
    (B, ...) -> (B, ..., C)."""
    B, H, W, C = feature.shape
    lin = (h_idx.long() * W + w_idx.long()).reshape(B, -1)
    # indexing, not torch.gather: the select's copy mode repeats indices,
    # and on the card gather's backward scatter-adds them with atomics
    rows = torch.arange(B, device=feature.device)[:, None]
    return feature.reshape(B, H * W, C)[rows, lin].reshape(h_idx.shape + (C,))


def strided_downsample(grid: torch.Tensor, out_h: int, out_w: int, stride_h: int,
                       stride_w: int) -> torch.Tensor:
    """Every (stride_h, stride_w)-th cell of (B, H, W, C)."""
    return grid[:, : out_h * stride_h : stride_h, : out_w * stride_w : stride_w]


def spherical_project(xyz: torch.Tensor, features: Sequence[torch.Tensor], H: int, W: int,
                      fup: float = 2.0, fdown: float = -24.8, use_rank: bool = True,
                      ref_pad_quirk: bool = False) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Project xyz (B, N, 3) and features [(B, N, Di)] into a range image:
    (xyz_proj (B, H, W, 3), [feat_proj (B, H, W, Di)]). Zero points (r = 0)
    never win a cell; a cell with no winner is zero. Column from the
    azimuth, row from the elevation (top down), both clamped into the grid.

    ``ref_pad_quirk`` reproduces the reference's NaN-row scatter of zero-pad
    points: cell (0, W // 2) of every row with any pad point is zeroed.
    """
    B, N, _ = xyz.shape
    dev = xyz.device
    # the constants are formed in double and rounded to f32 where they meet
    # the f32 tensors, as JAX's weak-typed Python floats are
    az_res = (2.0 * math.pi) / W
    v_res = (fup - fdown) * math.pi / 180.0 / (H - 1)
    v_offset = -(fdown * math.pi / 180.0) / v_res

    x, y, z = xyz.unbind(-1)
    r = torch.sqrt((x * x + y * y) + z * z)
    valid = r > 0.0
    col = torch.floor((math.pi - torch.atan2(y, x)) / az_res).to(torch.int32)
    beta = torch.asin(torch.where(valid, z / torch.where(valid, r, 1.0), 0.0))
    row = H - torch.floor(beta / v_res + v_offset).to(torch.int32)
    row = torch.clamp(row, 0, H - 1)
    col = torch.clamp(col, 0, W - 1)

    # one flat segment per (batch, cell); invalid points go to a trash cell
    cells = H * W
    seg = row.long() * W + col.long() + torch.arange(B, device=dev)[:, None] * cells
    seg = torch.where(valid, seg, B * cells).reshape(-1)
    point_idx = torch.arange(N, device=dev).expand(B, N).reshape(-1)
    if use_rank:
        # nearest wins, ties to the lowest point index
        r_flat = torch.where(valid, r, math.inf).reshape(-1)
        min_r = torch.full((B * cells + 1,), math.inf, device=dev)
        min_r = min_r.scatter_reduce(0, seg, r_flat, "amin")
        winner = (r_flat <= min_r[seg]) & (r_flat < math.inf)
        cand = torch.where(winner, point_idx, N)
        winner_idx = torch.full((B * cells + 1,), N, dtype=torch.int64, device=dev)
        winner_idx = winner_idx.scatter_reduce(0, seg, cand, "amin")
    else:
        # the last write in input order wins: the largest point index
        cand = torch.where(valid.reshape(-1), point_idx, -1)
        winner_idx = torch.full((B * cells + 1,), -1, dtype=torch.int64, device=dev)
        winner_idx = winner_idx.scatter_reduce(0, seg, cand, "amax")
        winner_idx = torch.where(winner_idx >= 0, winner_idx, N)
    winner_idx = winner_idx[: B * cells].reshape(B, cells)
    has_winner = (winner_idx < N)[..., None]
    safe_idx = torch.clamp(winner_idx, max=N - 1)

    packed = torch.cat([xyz, *features], dim=-1)
    picked = torch.gather(packed, 1, safe_idx[..., None].expand(B, cells, packed.shape[-1]))
    picked = torch.where(has_winner, picked, 0.0).reshape(B, H, W, packed.shape[-1])
    if ref_pad_quirk:
        keep = torch.all(valid, dim=1).to(picked.dtype)[:, None]  # (B, 1)
        picked[:, 0, W // 2, :] = picked[:, 0, W // 2, :] * keep
    xyz_proj = picked[..., :3]
    feat_projs, off = [], 3
    for f in features:
        feat_projs.append(picked[..., off: off + f.shape[-1]])
        off += f.shape[-1]
    return xyz_proj, feat_projs


def _window_index(out_h, out_w, qstride, stride, kernel_size, h2, w2, shift, device):
    """Row and column indices of every window slot and the slot's in-bounds
    mask (out_h*out_w, kh*kw), in ``window_candidates``' slot order."""
    kh, kw = kernel_size
    ch = (torch.arange(out_h, device=device) * qstride[0]) // stride[0]
    cw = (torch.arange(out_w, device=device) * qstride[1]) // stride[1]
    rows = ch[:, None] + (torch.arange(kh, device=device) - kh // 2)[None, :]  # (out_h, kh)
    cols = cw[:, None] + (torch.arange(kw, device=device) - kw // 2)[None, :]  # (out_w, kw)
    row_ok = (rows >= 0) & (rows < h2)
    if shift:
        cols_idx = torch.remainder(cols, w2)
        col_ok = torch.ones_like(cols, dtype=torch.bool)
    else:
        col_ok = (cols >= 0) & (cols < w2)
        cols_idx = torch.clamp(cols, 0, w2 - 1)
    rows_idx = torch.clamp(rows, 0, h2 - 1)
    in_bounds = (row_ok[:, None, :, None] & col_ok[None, :, None, :]).reshape(
        out_h * out_w, kh * kw)
    return rows_idx, cols_idx, in_bounds


def window_candidates(src: torch.Tensor, out_h: int, out_w: int, qstride: Tuple[int, int],
                      stride: Tuple[int, int], kernel_size: Tuple[int, int], shift: bool = True):
    """The kh x kw window of every regular-grid query: query (i, j) sits at
    (i * qstride_h, j * qstride_w) and its window centres at that over
    ``stride`` on src (B, h2, w2, C). Returns (cand (B, out_h*out_w, kh*kw,
    C), in_bounds (out_h*out_w, kh*kw)); slot = dh * kw + dw. Out-of-image
    rows are clamped in ``cand`` and marked out of bounds."""
    B, h2, w2, C = src.shape
    kh, kw = kernel_size
    rows_idx, cols_idx, in_bounds = _window_index(out_h, out_w, qstride, stride, kernel_size,
                                                  h2, w2, shift, src.device)
    t1 = src[:, rows_idx]  # (B, out_h, kh, w2, C)
    t2 = t1[:, :, :, cols_idx]  # (B, out_h, kh, out_w, kw, C)
    cand = t2.permute(0, 1, 3, 2, 4, 5).reshape(B, out_h * out_w, kh * kw, C)
    return cand, in_bounds


def _grid_candidates(src, out_h, out_w, qstride, stride, kernel_size, shift):
    """(cand (B, N, kh*kw, C), in_bounds or None) from the im2col builder
    where ``_patches_eligible`` holds (a view of its (B, N, C, kh*kw)
    patches; its out-of-image rows are zeros, so no mask), else from
    ``window_candidates``."""
    h2, w2 = src.shape[1:3]
    if _patches_eligible(out_h, out_w, qstride, stride, h2, w2, shift):
        return _patches_candidates(src, out_h, out_w, qstride, kernel_size).transpose(2, 3), None
    return window_candidates(src, out_h, out_w, qstride, stride, kernel_size, shift)


def _sq_norm3(v: torch.Tensor) -> torch.Tensor:
    """(x*x + y*y) + z*z over the last axis of 3, in that order."""
    x, y, z = v.unbind(-1)
    return (x * x + y * y) + z * z


def _stable_k_smallest(d_masked: torch.Tensor, K: int):
    """(values, slots) of the K smallest of d_masked (..., S), equal values
    lowest slot first, as ``lax.top_k`` of the negation orders them
    (``torch.topk`` leaves ties in no set order); K > S pads with invalid
    slots."""
    S = d_masked.shape[-1]
    if K > S:
        d_masked = F.pad(d_masked, (0, K - S), value=INVALID_DIST)
    d_sorted, order = torch.sort(d_masked, dim=-1, stable=True)
    return d_sorted[..., :K], order[..., :K]


def window_neighbor_select(xyz1: torch.Tensor, xyz2: torch.Tensor, idx_hw: torch.Tensor,
                           kernel_size: Tuple[int, int], K: int, stride: Tuple[int, int] = (1, 1),
                           distance: float = 10.0, shift: bool = True, copy: bool = False):
    """K nearest window slots of queries at any coordinates.

    xyz1 (B, H, W, 3) query grid; xyz2 (B, h2, w2, 3) search grid; idx_hw
    (B, N, 2) query coordinates into xyz1; each window centres at (h //
    stride_h, w // stride_w) on xyz2. Returns (h_idx, w_idx (B, N, K) int64,
    mask (B, N, K, 1) f32). A slot that is no hit, and every slot of an
    invalid centre, is (0, 0) with mask 0. ``copy`` fills missing slots with
    the nearest hit, or (0, 0) where there is none, and sets the mask in
    every slot of a valid centre. ``K > kh*kw`` pads with invalid slots.
    """
    h2, w2 = xyz2.shape[1:3]
    kh, kw = kernel_size
    dev = xyz1.device
    idx_hw = idx_hw.long()
    center = gather_grid(xyz1, idx_hw[..., 0], idx_hw[..., 1])  # (B, N, 3)
    center_valid = _sq_norm3(center) > 1e-10

    slot = torch.arange(kh * kw, device=dev)
    hh = (idx_hw[..., 0] // stride[0])[..., None] + (slot // kw - kh // 2)  # (B, N, khw)
    ww = (idx_hw[..., 1] // stride[1])[..., None] + (slot % kw - kw // 2)
    valid = (hh >= 0) & (hh < h2)
    if shift:
        ww = torch.remainder(ww, w2)
    else:
        valid = valid & (ww >= 0) & (ww < w2)
    hc = torch.clamp(hh, 0, h2 - 1)
    wc = torch.clamp(ww, 0, w2 - 1)

    q = gather_grid(xyz2, hc, wc)  # (B, N, khw, 3)
    d = torch.clamp(_sq_norm3(center[:, :, None, :] - q), min=1e-10)
    valid = valid & (_sq_norm3(q) > 1e-10) & (d <= distance * distance)
    d_sel, args = _stable_k_smallest(torch.where(valid, d, INVALID_DIST), K)
    if K > kh * kw:  # the pad slots point at (0, 0), as the pads of JAX's
        hc = F.pad(hc, (0, K - kh * kw))
        wc = F.pad(wc, (0, K - kh * kw))
    h_sel = torch.gather(hc, -1, args)
    w_sel = torch.gather(wc, -1, args)
    mask = d_sel < INVALID_DIST
    if copy:
        any_hit = mask[..., :1]
        h_sel = torch.where(mask, h_sel, torch.where(any_hit, h_sel[..., :1], 0))
        w_sel = torch.where(mask, w_sel, torch.where(any_hit, w_sel[..., :1], 0))
        mask = torch.ones_like(mask)
    mask = mask & center_valid[..., None]
    h_sel = torch.where(mask, h_sel, 0)
    w_sel = torch.where(mask, w_sel, 0)
    return h_sel, w_sel, mask[..., None].float()


def window_neighbor_select_grid(xyz1: torch.Tensor, xyz2: torch.Tensor, out_h: int, out_w: int,
                                qstride: Tuple[int, int], kernel_size: Tuple[int, int], K: int,
                                stride: Tuple[int, int] = (1, 1), distance: float = 10.0,
                                shift: bool = True, copy: bool = False):
    """K nearest window slots of each regular-grid query of xyz1 on xyz2.

    Returns (args (B, N, K) int64 slot indices, mask (B, N, K, 1) f32);
    ``args == kh*kw`` is the sentinel slot (the grid's (0, 0) pixel, the
    reference kernel's zero-initialised scratch) for missing neighbours and
    invalid centres. ``copy`` fills missing slots with the nearest hit (or
    the sentinel when there is none) and sets the mask for every slot of a
    valid centre.
    """
    B = xyz1.shape[0]
    N = out_h * out_w
    center = strided_downsample(xyz1, out_h, out_w, qstride[0], qstride[1]).reshape(B, N, 3)
    center_valid = _sq_norm3(center) > 1e-10
    cand, in_bounds = _grid_candidates(xyz2, out_h, out_w, qstride, stride, kernel_size, shift)
    q_valid = _sq_norm3(cand) > 1e-10
    d = torch.clamp(_sq_norm3(center[:, :, None, :] - cand), min=1e-10)
    valid = q_valid & (d <= distance * distance)
    if in_bounds is not None:
        valid = valid & in_bounds[None]
    d_masked = torch.where(valid, d, INVALID_DIST)

    khw = d_masked.shape[-1]
    d_sel, args = _stable_k_smallest(d_masked, K)
    hit = d_sel < INVALID_DIST
    args = torch.clamp(args, max=khw - 1)  # the K > khw pad slots
    if copy:
        nearest = torch.where(hit[..., :1], args[..., :1], khw)
        args = torch.where(hit, args, nearest)
        mask = torch.ones_like(hit)
    else:
        args = torch.where(hit, args, khw)
        mask = hit
    cv = center_valid[..., None]
    args = torch.where(cv, args, khw)
    mask = mask & cv
    return args, mask[..., None].float()


def select_window_features(feat_grid: torch.Tensor, args: torch.Tensor, out_h: int, out_w: int,
                           qstride: Tuple[int, int], stride: Tuple[int, int],
                           kernel_size: Tuple[int, int], shift: bool = True) -> torch.Tensor:
    """Features (B, N, K, C) of the selected window slots of feat_grid
    (B, h2, w2, C); slot kh*kw is the grid's (0, 0) pixel."""
    B, _, _, C = feat_grid.shape
    N, K = out_h * out_w, args.shape[-1]
    cand, _ = _grid_candidates(feat_grid, out_h, out_w, qstride, stride, kernel_size, shift)
    sentinel = feat_grid[:, 0, 0, :].reshape(B, 1, 1, C).expand(B, N, 1, C)
    cand = torch.cat([cand, sentinel], dim=2)
    # indexing, not torch.gather: on the card gather's backward scatter-adds
    # with atomics, and copy-filled slots repeat; indexing's backward
    # accumulates repeated slots in a fixed order, so a step repeats bit for bit
    rows = torch.arange(B, device=cand.device)[:, None, None]
    return cand[rows, torch.arange(N, device=cand.device)[None, :, None], args]


def select_window_features_multi(feat_grids: Sequence[torch.Tensor], args: torch.Tensor,
                                 **wargs) -> List[torch.Tensor]:
    """``select_window_features`` of each grid in turn."""
    return [select_window_features(f, args, **wargs) for f in feat_grids]


def pixel_posinfo(B: int, H: int, W: int, intrinsic: torch.Tensor) -> torch.Tensor:
    """Normalised-plane coordinates K^-1 [u, v, 1] of every pixel centre:
    (B, H, W, 3) f32. The grid is built on the intrinsic's device and the
    inverse taken without ``linalg.inv``'s host-synchronising check."""
    dev = intrinsic.device
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    grid = torch.stack([u, v, torch.ones_like(u)], dim=-1).reshape(1, H * W, 3)
    k_inv = torch.linalg.inv_ex(intrinsic.float()).inverse
    out = torch.einsum("bij,bnj->bni", k_inv, grid.expand(B, H * W, 3))
    return out.reshape(B, H, W, 3)
