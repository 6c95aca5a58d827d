"""Host-side (numpy) sample transforms shared by all datasets (port of
``i2pnet_tpu/data/transforms.py``: the same arithmetic, and a numpy
``resize_image``, bit-exact to OpenCV's ``INTER_LINEAR`` on uint8, so that
no image library is needed).

Pose-perturbation sampling, decalibration ground truth, point sampling /
padding, image crop/resize with intrinsic bookkeeping, augmentation.
References: src/kitti_odometry_cmr.py:305-389, 348-372 and
src/kitti_odometry_corr_lidarnone_proj.py:283-305; src/utils.py:316-322.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def generate_transformation(
    rx: float, ry: float, rz: float, tx: float, ty: float, tz: float
) -> np.ndarray:
    """4x4 perturbation from euler 'xzy' = [rx, rz, ry] + translation
    (ref kitti_odometry_cmr.py:348-353)."""
    P = np.identity(4, dtype=np.float32)
    P[0:3, 0:3] = Rotation.from_euler("xzy", [rx, rz, ry]).as_matrix()
    P[0:3, 3] = [tx, ty, tz]
    return P


def generate_random_transform(
    rng: np.random.Generator,
    tx_amp: float,
    ty_amp: float,
    tz_amp: float,
    rx_amp: float,
    ry_amp: float,
    rz_amp: float,
    clip_tz: bool = True,
) -> np.ndarray:
    """Uniform pose perturbation.

    clip_tz=True clips the tz upper bound to 1.0 m — ONLY the KITTI CMR
    sampler does this (ref kitti_odometry_cmr.py:355-372); the nuScenes CMR
    and both large-range samplers sample the full range (ref
    nuscenes_loader_cmr.py:232-234, kitti_odometry_corr_lidarnone_proj.py:
    394-396) and must pass clip_tz=False.
    """
    t = [
        rng.uniform(-tx_amp, tx_amp),
        rng.uniform(-ty_amp, ty_amp),
        rng.uniform(-tz_amp, min(tz_amp, 1.0) if clip_tz else tz_amp),
    ]
    angles = [
        rng.uniform(-rx_amp, rx_amp),
        rng.uniform(-ry_amp, ry_amp),
        rng.uniform(-rz_amp, rz_amp),
    ]
    return generate_transformation(*angles, *t)


def rotmat_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (w,x,y,z), w >= 0 (the reference's trace construction
    always yields w >= 0, ref src/utils.py rotmat_to_quat)."""
    q = Rotation.from_matrix(R).as_quat()  # x,y,z,w
    q = np.array([q[3], q[0], q[1], q[2]], np.float32)
    if q[0] < 0:
        q = -q
    return q


def decalib_ground_truth(extrinsic_3x4: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(q (4,), t (3,)) of the decalibration correction.

    The reference computes a dual quaternion then overwrites the dual part
    with the plain translation (ref kitti_odometry_cmr.py:489-491), so the
    effective ground truth is (unit quat, translation).
    """
    q = rotmat_to_quat_wxyz(extrinsic_3x4[:3, :3])
    t = extrinsic_3x4[:, 3].astype(np.float32)
    return q, t


def jitter_point_cloud(
    rng: np.random.Generator,
    pc: np.ndarray,
    sigma: float = 0.01,
    clip: float = 0.05,
) -> np.ndarray:
    """Per-point gaussian jitter, clipped (ref kitti_odometry_cmr.py:305-316).

    pc: (3, N) or (N, 3) — jitter shape follows the input.
    """
    noise = np.clip(sigma * rng.standard_normal(pc.shape), -clip, clip)
    return (pc + noise).astype(pc.dtype)


def sample_points_with_repetition(
    rng: np.random.Generator, n_available: int, n_sample: int
) -> np.ndarray:
    """Choice without replacement; pad by whole repetitions + random fill
    when short (ref kitti_odometry_cmr.py:527-536)."""
    if n_available >= n_sample:
        return rng.choice(n_available, n_sample, replace=False)
    fix_idx = np.arange(n_available)
    while fix_idx.shape[0] + n_available < n_sample:
        fix_idx = np.concatenate([fix_idx, np.arange(n_available)])
    random_idx = rng.choice(n_available, n_sample - fix_idx.shape[0], replace=False)
    return np.concatenate([fix_idx, random_idx])


def zero_pad_points(pc: np.ndarray, n_sample: int) -> np.ndarray:
    """Zero-pad (N, C) to (n_sample, C)
    (ref kitti_odometry_corr_lidarnone_proj.py:696-711)."""
    N, C = pc.shape
    if N >= n_sample:
        return pc[:n_sample]
    return np.concatenate(
        [pc, np.zeros((n_sample - N, C), dtype=pc.dtype)], axis=0
    )


def _linear_coeffs(n_in: int, n_out: int, clamp_weights: bool):
    """Per-axis source indices and 11-bit weights of OpenCV's INTER_LINEAR:
    the half-pixel centre in f32 (OpenCV's scale, 1 / (n_out / n_in), in
    f64), each weight rounded on its own. The two axes treat the border
    apart, as OpenCV does: along x (``clamp_weights``) a centre outside the
    first or last pixel takes that pixel with weight 1; along y it keeps
    its two weights and both source rows are clamped to the image, so a
    border row of an upscaled image is the same row weighted twice, and
    rounds as such."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    a = (f - np.floor(f)).astype(np.float32)
    if clamp_weights:
        low = i0 < 0
        a[low] = 0.0
        i0[low] = 0
        a[i0 >= n_in - 1] = 0.0
        i1 = np.minimum(i0 + 1, n_in - 1)
    else:
        i1 = np.clip(i0 + 1, 0, n_in - 1)
        i0 = np.clip(i0, 0, n_in - 1)
    c0 = np.rint((1.0 - a) * 2048).astype(np.int32)
    c1 = np.rint(a * 2048).astype(np.int32)
    return i0, i1, c0, c1


def resize_image(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Bilinear resize of a uint8 (H, W) or (H, W, C) image, bit-exact to
    ``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)``,
    down or up: fixed-point weights (11 bits an axis), a horizontal pass in
    integers, then the vertical pass with OpenCV's shifts and rounding.
    int32 holds every intermediate (at most 255 * 2048 before the shift by
    4, 2**26 after the vertical product)."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_image: expected uint8, got {img.dtype}")
    h_in, w_in = img.shape[:2]
    x0, x1, cx0, cx1 = _linear_coeffs(w_in, out_w, clamp_weights=True)
    y0, y1, cy0, cy1 = _linear_coeffs(h_in, out_h, clamp_weights=False)
    trail = (1,) * (img.ndim - 2)
    h = img[:, x0].astype(np.int32)
    h *= cx0.reshape((-1,) + trail)
    right = img[:, x1].astype(np.int32)
    right *= cx1.reshape((-1,) + trail)
    h += right
    h >>= 4
    out = h[y0]
    out *= cy0.reshape((-1, 1) + trail)
    out >>= 16
    below = h[y1]
    below *= cy1.reshape((-1, 1) + trail)
    below >>= 16
    out += below
    out += 2
    out >>= 2
    return np.clip(out, 0, 255).astype(np.uint8)


def color_jitter(
    rng: np.random.Generator,
    img: np.ndarray,
    brightness: Tuple[float, float] = (0.8, 1.2),
    contrast: Tuple[float, float] = (0.8, 1.2),
    saturation: Tuple[float, float] = (0.8, 1.2),
    hue: Tuple[float, float] = (-0.1, 0.1),
    enabled: bool = True,
) -> np.ndarray:
    """Brightness/contrast/saturation jitter on a uint8 HWC image.

    NOTE: the reference's augment_img (ref kitti_odometry_cmr.py:374-389)
    constructs `transforms.ColorJitter()` with NO ranges and discards
    `get_params`' return value, so the shipped augmentation is a no-op.
    We implement a real jitter; pass enabled=False for strict reference
    behavior.
    """
    if not enabled:
        return img
    x = img.astype(np.float32)
    b = rng.uniform(*brightness)
    c = rng.uniform(*contrast)
    s = rng.uniform(*saturation)
    x = x * b
    mean = x.mean()
    x = (x - mean) * c + mean
    gray = x.mean(axis=-1, keepdims=True)
    x = (x - gray) * s + gray
    del hue  # hue rotation omitted: marginal value for this workload
    return np.clip(x, 0, 255).astype(np.uint8)


def normalize_image(img: np.ndarray, imagenet: bool = False) -> np.ndarray:
    """uint8 HWC -> float32 HWC; optional ImageNet normalization
    (ref kitti_odometry_cmr.py:575-581; self.normal is False by default,
    so plain float conversion is the shipped behavior)."""
    x = img.astype(np.float32)
    if imagenet:
        x = (x / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    return x
