"""``camera``: ``real_points`` points of a KITTI drive in the camera
frame, after the loader's filter: ranges uniform in ``near_m`` (a
``1 - far_share`` of them) and in ``far_m``, azimuth within
``azimuth_deg`` of the optical axis, elevation in ``elevation_deg``,
depth over ``min_depth``. The model sees ``Pr^-1 X`` and takes it as its
features too; the raw cloud is X in the LiDAR frame."""

from __future__ import annotations

import math

import numpy as np

from ..gen import VELO_TO_CAM, ranges


def camera_scan(rng, count: int, spec: dict) -> np.ndarray:
    """(count, 3) camera-frame points of a drive (module docstring)."""
    m = 2 * count
    r = ranges(rng, m, spec)
    az = rng.uniform(-1, 1, m) * math.radians(spec["azimuth_deg"])
    el = rng.uniform(*np.radians(spec["elevation_deg"]), m)
    pts = np.stack([r * np.cos(el) * np.sin(az), -r * np.sin(el), r * np.cos(el) * np.cos(az)], -1)
    pts = pts[pts[:, 2] > spec["min_depth"]]
    if len(pts) < count:
        raise ValueError(f"camera_scan: {len(pts)} points ahead, {count} wanted")
    return pts[:count]


def points(rng, config: dict, scan: dict, Pr: np.ndarray):
    """(lidar, features, raw) of one pair."""
    cam = camera_scan(rng, config["real_points"], scan)
    raw = cam @ VELO_TO_CAM  # the inverse (transpose) mapping back to the LiDAR frame
    inv = np.linalg.inv(Pr)
    lidar = cam @ inv[:3, :3].T + inv[:3, 3]
    return lidar, lidar, raw
