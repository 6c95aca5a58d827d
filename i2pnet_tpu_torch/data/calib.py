"""KITTI calibration parsing (a copy of ``i2pnet_tpu/data/calib.py``).

read_calib mirrors ref src/kitti_odometry_cmr.py:181-205 (odometry calib.txt:
Tr and P2 lines; P2's translation folded into a 4x4 P). RawCalib mirrors
ref src/calib2.py:57-75 (raw-KITTI calib_cam_to_cam / calib_velo_to_cam).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def camera_matrix_cropping(K: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """Shift the principal point for a top-left crop (ref :208-213)."""
    K_crop = np.copy(K)
    K_crop[0, 2] -= dx
    K_crop[1, 2] -= dy
    return K_crop


def camera_matrix_scaling(K: np.ndarray, sx: float, sy: float) -> np.ndarray:
    K_s = np.copy(K)
    K_s[0, 0] *= sx
    K_s[0, 2] *= sx
    K_s[1, 1] *= sy
    K_s[1, 2] *= sy
    return K_s


def read_calib(calib_file_path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse odometry calib.txt -> (Tr (3,4), intrinsic (3,3), P (4,4)).

    P carries P2's translation re-expressed in metric camera coordinates
    (ref kitti_odometry_cmr.py:181-205 read_calib).
    """
    Tr = None
    intrinsic = None
    P = np.identity(4)
    with open(calib_file_path, "r") as f:
        for line in f.readlines():
            key = line[0:2]
            if ":" not in line:
                continue
            mat = np.fromstring(line.split(":", 1)[1], sep=" ")
            if key == "Tr":
                Tr = mat.reshape(3, 4).astype(np.float32)
            elif key == "P2":
                mat = mat.reshape(3, 4).astype(np.float32)
                K = mat[0:3, 0:3]
                fx, fy = K[0, 0], K[1, 1]
                cx, cy = K[0, 2], K[1, 2]
                intrinsic = np.asarray(
                    [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64
                )
                tz = mat[2, 3]
                tx = (mat[0, 3] - cx * tz) / fx
                ty = (mat[1, 3] - cy * tz) / fy
                P = np.identity(4)
                P[0:3, 3] = np.asarray([tx, ty, tz])
    return Tr, intrinsic, P


class RawCalib:
    """Raw-KITTI calib file parser (ref src/calib2.py:57-75 CALIB).

    Reads calib_cam_to_cam.txt / calib_velo_to_cam.txt from a date dir and
    exposes velo->cam2 extrinsic + rectified intrinsic.
    """

    def __init__(self, date_dir: str):
        cam2cam = self._read_kv(os.path.join(date_dir, "calib_cam_to_cam.txt"))
        velo2cam_kv = self._read_kv(os.path.join(date_dir, "calib_velo_to_cam.txt"))

        R = velo2cam_kv["R"].reshape(3, 3)
        t = velo2cam_kv["T"].reshape(3, 1)
        self.velo_to_cam = np.vstack(
            [np.hstack([R, t]), [0, 0, 0, 1]]
        )  # (4,4)

        self.R_rect_00 = np.identity(4)
        self.R_rect_00[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
        self.P_rect_20 = cam2cam["P_rect_02"].reshape(3, 4)

        K = self.P_rect_20[:, :3]
        self.intrinsic = K.copy()
        # fold P_rect's translation into the extrinsic chain, like read_calib
        fx, fy = K[0, 0], K[1, 1]
        cx, cy = K[0, 2], K[1, 2]
        tz = self.P_rect_20[2, 3]
        tx = (self.P_rect_20[0, 3] - cx * tz) / fx
        ty = (self.P_rect_20[1, 3] - cy * tz) / fy
        P = np.identity(4)
        P[0:3, 3] = [tx, ty, tz]
        # full velo -> rectified-cam2 extrinsic
        self.extrinsic = (P @ self.R_rect_00 @ self.velo_to_cam)[:3, :]

    @staticmethod
    def _read_kv(path: str) -> dict:
        out = {}
        with open(path, "r") as f:
            for line in f.readlines():
                if ":" not in line:
                    continue
                k, v = line.split(":", 1)
                try:
                    out[k.strip()] = np.fromstring(v, sep=" ")
                except ValueError:
                    continue
        return out
