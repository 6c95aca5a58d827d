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

Not ported: the opt-in im2col candidate path (``I2PNET_GRID_PATCHES=1``
there, a measured negative), ``window_neighbor_select``, ``gather_grid``,
``strided_grid_indices`` and ``pixel_posinfo``: no model path runs them.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

INVALID_DIST = 1e10


def check_valid(xyz: torch.Tensor) -> torch.Tensor:
    """1.0 where any coordinate is nonzero, (..., 1) f32."""
    return torch.any(xyz != 0, dim=-1, keepdim=True).float()


def grid_indices(B: int, H: int, W: int, device=None) -> torch.Tensor:
    """(B, H*W, 2) int32 (h, w) coordinates, row-major."""
    h = torch.arange(H, dtype=torch.int32, device=device)
    w = torch.arange(W, dtype=torch.int32, device=device)
    hh, ww = torch.meshgrid(h, w, indexing="ij")
    return torch.stack([hh, ww], dim=-1).reshape(1, H * W, 2).expand(B, H * W, 2)


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


def _sq_norm3(v: torch.Tensor) -> torch.Tensor:
    """(x*x + y*y) + z*z over the last axis of 3, in that order."""
    x, y, z = v.unbind(-1)
    return (x * x + y * y) + z * z


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
    cand, in_bounds = window_candidates(xyz2, out_h, out_w, qstride, stride, kernel_size, shift)
    q_valid = _sq_norm3(cand) > 1e-10
    d = torch.clamp(_sq_norm3(center[:, :, None, :] - cand), min=1e-10)
    valid = in_bounds[None] & q_valid & (d <= distance * distance)
    d_masked = torch.where(valid, d, INVALID_DIST)

    khw = d_masked.shape[-1]
    if K > khw:
        d_masked = torch.nn.functional.pad(d_masked, (0, K - khw), value=INVALID_DIST)
    # stable: equal distances keep the lowest slot first, as lax.top_k
    d_sorted, order = torch.sort(d_masked, dim=-1, stable=True)
    d_sel, args = d_sorted[..., :K], order[..., :K]
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
    cand, _ = window_candidates(feat_grid, out_h, out_w, qstride, stride, kernel_size, shift)
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
