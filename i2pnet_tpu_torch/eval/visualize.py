"""Visualisation (port of ``i2pnet_tpu/eval/visualize.py``; ref
src/visualize.py, src/util/vis_tools.py, evaluation_vis*.py).

Renders LiDAR points projected through an extrinsic and an intrinsic over
the RGB image, coloured by depth (the core artifact of the reference's
visual-evaluation scripts), the init/pred/gt panel, the reprojection-error
heat and projection-mask panels, a depth image and a PLY export: numpy
only, the JAX package's functions line for line, so a panel is the same
array in either package.

Files: ``save_image`` (``write_png``) writes a PNG with zlib and struct
alone (8-bit RGB or grey, filter type 0 on every row, a CRC on every
chunk), the pixels PIL's writer gives; ``write_video`` takes imageio,
else PIL's animated GIF, and raises an ``ImportError`` naming both where
neither is installed.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np


def project_points_full(
    points: np.ndarray,
    extrinsic: np.ndarray,
    intrinsic: np.ndarray,
    img_hw: Tuple[int, int],
):
    """points (N,3) -> (uv (N,2), z (N,), in_frustum (N,) bool).

    The single projection used by every panel renderer (one place to fix
    behind-camera handling etc.). z is guarded sign-preservingly so
    behind-camera points stay out of frustum rather than flipping uv.
    """
    cam = points @ extrinsic[:, :3].T + extrinsic[:, 3]
    uvw = cam @ intrinsic.T
    z = uvw[:, 2]
    safe_z = np.where(np.abs(z) > 1e-10, z, 1e-10)
    uv = uvw[:, :2] / safe_z[:, None]
    m = (
        (z > 0.1)
        & (uv[:, 0] >= 0) & (uv[:, 0] < img_hw[1])
        & (uv[:, 1] >= 0) & (uv[:, 1] < img_hw[0])
    )
    return uv, z, m


def project_points_to_image(
    points: np.ndarray,
    extrinsic: np.ndarray,
    intrinsic: np.ndarray,
    img_hw: Tuple[int, int],
):
    """points (N,3) -> (uv (M,2), depth (M,)) of in-frustum projections."""
    uv, z, m = project_points_full(points, extrinsic, intrinsic, img_hw)
    return uv[m], z[m]


def decalib_extrinsic(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """A decalibration correction (q (4,) [w, x, y, z], t (3,)) -> its (3, 4)
    f32 extrinsic, the rotation computed in q's own dtype (as the JAX
    evaluator and demo compute it: a point near a pixel edge lands in the
    same cell)."""
    from i2pnet_tpu_torch.metrics import quat_to_rotmat_batch

    R = quat_to_rotmat_batch(np.asarray(q)[None])[0]
    return np.concatenate([R, np.asarray(t).reshape(3, 1)], axis=1).astype(np.float32)


def _depth_colors(z: np.ndarray) -> np.ndarray:
    """Simple jet-like depth colormap -> uint8 (M, 3)."""
    t = np.clip((z - z.min()) / (np.ptp(z) + 1e-10), 0, 1)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def render_projection(
    rgb: np.ndarray,
    points: np.ndarray,
    extrinsic: np.ndarray,
    intrinsic: np.ndarray,
    radius: int = 1,
) -> np.ndarray:
    """Overlay depth-colored projected points on an image (HWC uint8)."""
    img = np.ascontiguousarray(rgb).astype(np.uint8).copy()
    H, W = img.shape[:2]
    uv, z = project_points_to_image(points, extrinsic, intrinsic, (H, W))
    if len(uv) == 0:
        return img
    colors = _depth_colors(z)
    u = uv[:, 0].astype(np.int64)
    v = uv[:, 1].astype(np.int64)
    for du in range(-radius, radius + 1):
        for dv in range(-radius, radius + 1):
            uu = np.clip(u + du, 0, W - 1)
            vv = np.clip(v + dv, 0, H - 1)
            img[vv, uu] = colors
    return img


def render_comparison(
    rgb: np.ndarray,
    points: np.ndarray,
    init_extrinsic: np.ndarray,
    pred_extrinsic: np.ndarray,
    gt_extrinsic: np.ndarray,
    intrinsic: np.ndarray,
) -> np.ndarray:
    """Vertical init/pred/gt panel (the reference's demo layout)."""
    panels = [
        render_projection(rgb, points, E, intrinsic)
        for E in (init_extrinsic, pred_extrinsic, gt_extrinsic)
    ]
    return np.concatenate(panels, axis=0)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) or (H, W) uint8 image -> a PNG file, with the standard
    library alone: 8-bit truecolour (or greyscale), no interlace, each row
    prefixed by filter type 0 (none), the rows deflated into one IDAT."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes (H, W, 3) or (H, W) uint8, not {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


# the JAX module's name for the PNG writer
save_image = write_png


def render_error_heat(
    rgb: np.ndarray,
    points: np.ndarray,
    pred_extrinsic: np.ndarray,
    gt_extrinsic: np.ndarray,
    intrinsic: np.ndarray,
    max_err_px: float = 20.0,
    radius: int = 1,
) -> np.ndarray:
    """Reprojection-error heat panel (ref evaluation_vis.py's error view).

    Colors each point at its GT pixel by |uv_pred - uv_gt| (green=0 ->
    red>=max_err_px); points in only one frustum are drawn blue.
    """
    img = np.ascontiguousarray(rgb).astype(np.uint8).copy()
    H, W = img.shape[:2]

    uv_p, _, ok_p = project_points_full(points, pred_extrinsic, intrinsic, (H, W))
    uv_g, _, ok_g = project_points_full(points, gt_extrinsic, intrinsic, (H, W))
    both = ok_p & ok_g
    only = ok_g & ~ok_p

    def splat(uv, colors):
        u = uv[:, 0].astype(np.int64)
        v = uv[:, 1].astype(np.int64)
        for du in range(-radius, radius + 1):
            for dv in range(-radius, radius + 1):
                img[np.clip(v + dv, 0, H - 1), np.clip(u + du, 0, W - 1)] = colors

    if only.any():
        splat(uv_g[only], np.array([40, 90, 255], np.uint8))
    if both.any():
        err = np.linalg.norm(uv_p[both] - uv_g[both], axis=-1)
        t = np.clip(err / max_err_px, 0, 1)[:, None]
        colors = ((1 - t) * np.array([[0, 220, 60]]) + t * np.array([[255, 40, 0]]))
        splat(uv_g[both], colors.astype(np.uint8))
    return img


def render_mask_overlay(
    rgb: np.ndarray,
    points: np.ndarray,
    pred_mask: np.ndarray,
    gt_extrinsic: np.ndarray,
    intrinsic: np.ndarray,
    radius: int = 1,
) -> tuple[np.ndarray, dict]:
    """Projection-mask panel + accuracy stats (ref evaluation_cmr_demo.py's
    mask view, :528-585: predicted in-frustum mask vs the geometric label).

    pred_mask: (N,) bool/0-1 prediction per point. GT label = point lands in
    the image through gt_extrinsic. Colors: green=true pos, red=false pos,
    yellow=false neg; true negatives are not drawn. Returns (panel, stats)
    with accuracy / precision / recall (the demo script's accuracy_score).
    """
    img = np.ascontiguousarray(rgb).astype(np.uint8).copy()
    H, W = img.shape[:2]
    uv, _, gt = project_points_full(points, gt_extrinsic, intrinsic, (H, W))
    pred = np.asarray(pred_mask).astype(bool).reshape(-1)

    u = np.clip(uv[:, 0], 0, W - 1).astype(np.int64)
    v = np.clip(uv[:, 1], 0, H - 1).astype(np.int64)

    def splat(sel, color):
        if not sel.any():
            return
        for du in range(-radius, radius + 1):
            for dv in range(-radius, radius + 1):
                img[
                    np.clip(v[sel] + dv, 0, H - 1), np.clip(u[sel] + du, 0, W - 1)
                ] = color

    splat(gt & pred, np.array([0, 220, 60], np.uint8))     # true positive
    splat(~gt & pred, np.array([255, 40, 0], np.uint8))    # false positive
    splat(gt & ~pred, np.array([255, 220, 0], np.uint8))   # false negative
    tp = float((gt & pred).sum())
    fp = float((~gt & pred).sum())
    fn = float((gt & ~pred).sum())
    stats = {
        "accuracy": float((gt == pred).mean()),
        "precision": tp / max(tp + fp, 1.0),
        "recall": tp / max(tp + fn, 1.0),
    }
    return img, stats


def write_video(path: str, frames, fps: int = 10) -> str:
    """Frames (iterable of HWC uint8) -> video file.

    mp4 via imageio-ffmpeg when available (the reference uses moviepy,
    src/visualize.py:7-9); falls back to animated GIF otherwise. Returns
    the path actually written.
    """
    frames = list(frames)
    if not frames:
        raise ValueError("no frames to write")
    try:
        import imageio

        if path.endswith(".gif"):
            imageio.mimsave(path, frames, fps=fps)
            return path
        with imageio.get_writer(path, fps=fps) as w:
            for f in frames:
                w.append_data(f)
        return path
    except Exception as e:
        try:
            from PIL import Image
        except ImportError:
            raise ImportError("write_video needs imageio (with imageio-ffmpeg for mp4) or PIL "
                              f"(an animated GIF); neither could write {path} ({e})") from None

        gif = os.path.splitext(path)[0] + ".gif"
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(
            gif, save_all=True, append_images=imgs[1:],
            duration=int(1000 / fps), loop=0,
        )
        return gif


def save_ply(
    path: str, points: np.ndarray, colors: Optional[np.ndarray] = None
) -> None:
    """ASCII PLY export of a point cloud, depth-colored by default — the
    offline-viewable stand-in for the reference's interactive 3D views
    (ref src/visualize.py:24-33 show_pcl, evaluation_vis_3d.py)."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if colors is None:
        colors = _depth_colors(np.linalg.norm(pts, axis=-1))
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(pts, colors):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")


def depth_image(
    points: np.ndarray,
    extrinsic: np.ndarray,
    intrinsic: np.ndarray,
    img_hw: Tuple[int, int],
) -> np.ndarray:
    """Z-buffered depth map (nearest-wins), the reference's depth-image
    view (ref src/dataset.py:214-256 get_depth_image). Returns (H, W) f32
    with 0 = empty."""
    H, W = img_hw
    uv, z = project_points_to_image(points, extrinsic, intrinsic, img_hw)
    depth = np.zeros((H, W), np.float32)
    if len(uv) == 0:
        return depth
    u = uv[:, 0].astype(np.int64)
    v = uv[:, 1].astype(np.int64)
    order = np.argsort(-z, kind="stable")  # far first, near overwrites
    depth[v[order], u[order]] = z[order]
    return depth
