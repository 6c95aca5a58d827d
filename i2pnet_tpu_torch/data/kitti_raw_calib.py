"""KITTI raw online-calibration datasets, a port of
``i2pnet_tpu/data/kitti_raw_calib.py`` (``KittiRawCalibDataset`` and the
RGGNet protocol's ``KittiRGGDataset``) on the port's transforms: the same
sample dict, the same RNG draws in the same order, so the two give equal
samples for one seed.

Raw-drive images (``image_02``) and velodyne scans; a decalibration per
item (+-d_rot deg as zyx euler angles, +-d_trans m; at the amplitude under
fixed_decalib). init_extrinsic = decalib @ velo_extrinsic, the regression
target the inverse of decalib. Images are resized to (resize_h, resize_w)
(``resize_image``, bit-exact to OpenCV's INTER_LINEAR) and
ImageNet-normalised. ``cv2`` reads the PNGs, imported when a sample is
read, as the JAX package does.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Optional

import numpy as np
from scipy.spatial.transform import Rotation

from i2pnet_tpu_torch.data import transforms as T
from i2pnet_tpu_torch.data.calib import RawCalib

# velo -> cam2 with R0_rect folded in, per recording date
CALIB_BY_DATE = {
    "2011_09_26": dict(
        fx=7.215377e02, fy=7.215377e02, cx=6.095593e02, cy=1.728540e02,
        rot=[
            [2.34773698e-04, -9.99944155e-01, -1.05634778e-02],
            [1.04494074e-02, 1.05653536e-02, -9.99889574e-01],
            [9.99945389e-01, 1.24365378e-04, 1.04513030e-02],
        ],
        trans=[[5.93721868e-02], [-7.48089053e-02], [-2.69386912e-01]],
    ),
    "2011_09_30": dict(
        fx=7.070912e02, fy=7.070912e02, cx=6.018873e02, cy=1.831104e02,
        rot=[
            [-0.00185774, -0.99996595, -0.00803998],
            [-0.00648147, 0.00805186, -0.99994661],
            [0.99997731, -0.00180553, -0.0064962],
        ],
        trans=[[0.06152684], [-0.07320761], [-0.32779358]],
    ),
}


def euler_to_rotmat(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """rot_z(yaw) @ rot_y(pitch) @ rot_x(roll)."""
    return Rotation.from_euler("zyx", [yaw, pitch, roll]).as_matrix()


class KittiRawCalibDataset:
    """Expected layout: ``<base_path>/<date>/<date>_drive_<drive:04d>_sync/``
    with ``image_02/data/*.png`` and ``velodyne_points/data/*.bin``, paired
    by sorted position. ``emit_calib`` adds a per-sample 'calib' (3, 4),
    the resized K @ [I|0], for the efgh model."""

    def __init__(
        self,
        base_path: str,
        date: str,
        drives,
        d_rot: float = 10.0,
        d_trans: float = 1.0,
        fixed_decalib: bool = False,
        resize_w: int = 1216,
        resize_h: int = 352,
        sample_point: int = 8192,
        seed: int = 0,
        pc_filter: bool = True,
        emit_calib: bool = False,
    ):
        self.d_rot, self.d_trans = d_rot, d_trans
        self.fixed_decalib = fixed_decalib
        self.resize_w, self.resize_h = resize_w, resize_h
        self.sample_point = sample_point
        self.pc_filter = pc_filter
        self.emit_calib = emit_calib
        self.rng = np.random.default_rng(seed)

        self.img_path, self.lidar_path = [], []
        for drive in drives:
            drive_dir = os.path.join(base_path, date, f"{date}_drive_{drive:04d}_sync")
            d_imgs = sorted(glob.glob(os.path.join(drive_dir, "image_02", "data", "*.png")))
            d_lidars = sorted(glob.glob(os.path.join(drive_dir, "velodyne_points", "data",
                                                     "*.bin")))
            # positional pairing: a dropped frame in either would misalign
            # every later pair
            if len(d_imgs) != len(d_lidars):
                raise ValueError(f"{drive_dir}: {len(d_imgs)} images vs {len(d_lidars)} scans "
                                 "— cannot pair positionally")
            self.img_path.extend(d_imgs)
            self.lidar_path.extend(d_lidars)

        params = CALIB_BY_DATE[date]
        self.cam_intrinsic = np.array(
            [[params["fx"], 0, params["cx"]], [0, params["fy"], params["cy"]], [0, 0, 1]])
        self.velo_extrinsic = np.hstack([np.asarray(params["rot"]), np.asarray(params["trans"])])

    def __len__(self) -> int:
        return len(self.img_path)

    def get_decalibration(self, index: Optional[int] = None) -> np.ndarray:
        """(3, 4) decalibration: three angles, then three offsets, each
        drawn uniform in +-amplitude in that order (or at the amplitude
        under fixed_decalib). index is unused."""
        if self.fixed_decalib:
            vals = [np.deg2rad(self.d_rot)] * 3 + [self.d_trans] * 3
        else:
            rot = np.deg2rad(self.d_rot)
            vals = [(self.rng.random() * 2 - 1) * amp
                    for amp in (rot, rot, rot, self.d_trans, self.d_trans, self.d_trans)]
        rot = euler_to_rotmat(vals[0], vals[1], vals[2])
        return np.hstack([rot, np.asarray(vals[3:]).reshape(3, 1)])

    def __getitem__(self, index: int) -> dict:
        import cv2

        rgb_img = np.ascontiguousarray(cv2.imread(self.img_path[index])[:, :, ::-1])  # BGR -> RGB

        decalib_extrinsic = self.get_decalibration(index)
        decalib_4 = np.vstack([decalib_extrinsic, [0, 0, 0, 1]])
        calib_extrinsic = np.linalg.pinv(decalib_4)[:3, :]
        decalib_q, decalib_t = T.decalib_ground_truth(calib_extrinsic)
        init_extrinsic = (decalib_4 @ np.vstack([self.velo_extrinsic, [0, 0, 0, 1]]))[:3, :]

        h, w = rgb_img.shape[:2]
        scale = np.array([self.resize_w / w, self.resize_h / h])
        intrinsic = self.cam_intrinsic.copy()
        intrinsic[0, 0] *= scale[0]
        intrinsic[0, 2] *= scale[0]
        intrinsic[1, 1] *= scale[1]
        intrinsic[1, 2] *= scale[1]

        # points: filter, transform, then sample without repetition
        pcl_xyz = np.fromfile(self.lidar_path[index], dtype=np.float32).reshape(-1, 4)[:, :3]
        if self.pc_filter:
            not_ground = pcl_xyz[:, 2] >= -15
            near = (pcl_xyz[:, 0] > 2) & (pcl_xyz[:, 0] < 1200) & (np.abs(pcl_xyz[:, 1]) < 1200)
            pcl_xyz = pcl_xyz[not_ground & near]
        pc_h = np.hstack([pcl_xyz, np.ones((pcl_xyz.shape[0], 1))]).T
        cam_pts = (init_extrinsic @ pc_h).T.astype(np.float32)
        sel = self.rng.permutation(cam_pts.shape[0])[: self.sample_point]
        if len(sel) < self.sample_point:
            sel = T.sample_points_with_repetition(self.rng, cam_pts.shape[0], self.sample_point)
        lidar_img = cam_pts[sel]

        rgb = T.normalize_image(T.resize_image(rgb_img, self.resize_w, self.resize_h),
                                imagenet=True)
        out = {
            "rgb": rgb,
            "decalib_real_gt": decalib_q,
            "decalib_dual_gt": decalib_t,
            "init_extrinsic": init_extrinsic.astype(np.float32),
            "init_intrinsic": intrinsic.astype(np.float32),
            "raw_intrinsic": self.cam_intrinsic.astype(np.float32),
            "lidar": lidar_img,
            "lidar_feats": lidar_img,
            "raw_point_xyz": lidar_img,
            "resize_img": scale.astype(np.float32),
            "index": index,
            "path_info": self.lidar_path[index],
        }
        if self.emit_calib:
            out["calib"] = np.hstack([intrinsic, np.zeros((3, 1))]).astype(np.float32)
        return out


def _reroot(path, base_path: Optional[str]) -> str:
    """A recorded raw-KITTI path moved under ``base_path``: everything
    before its date directory (``.../<date>/<date>_drive_xxxx_sync/...``)
    replaced; unchanged without ``base_path`` or a date directory."""
    if base_path is None:
        return str(path)
    parts = str(path).replace("\\", "/").split("/")
    for j, seg in enumerate(parts):
        if seg.count("_") == 2 and seg[:4].isdigit():
            return os.path.join(base_path, *parts[j:])
    return str(path)


class KittiRGGDataset(KittiRawCalibDataset):
    """The RGGNet protocol: raw-KITTI pairs with a FIXED decalibration per
    sample, from a ``rgg_data_*.pkl`` that ``data/preprocess.py``
    ``generate_rgg_splits`` writes (image and scan paths, (N, 3) euler
    degrees applied zyx as the online-calibration sampler does, (N, 3)
    meters). A pkl with a ``train_split`` serves mode 'train' (those
    indices) and 'val' (the rest); mode 'test' takes every sample, and
    'train' or 'val' on a test-only pkl raises. The calibration comes from
    the date directory's calib files where they exist, else from
    ``CALIB_BY_DATE``."""

    def __init__(
        self,
        pkl_path: str,
        mode: str = "test",
        base_path: Optional[str] = None,
        resize_w: int = 1216,
        resize_h: int = 352,
        sample_point: int = 8192,
        seed: int = 0,
        pc_filter: bool = True,
        emit_calib: bool = False,
    ):
        self.resize_w, self.resize_h = resize_w, resize_h
        self.sample_point = sample_point
        self.pc_filter = pc_filter
        self.fixed_decalib = False
        self.emit_calib = emit_calib
        self.rng = np.random.default_rng(seed)

        with open(pkl_path, "rb") as f:
            data = pickle.load(f)
        n = len(data["img"])
        if mode in ("train", "val"):
            if "train_split" not in data:
                raise ValueError(f"{pkl_path} has no train_split — it is a test-only RGG split; "
                                 f"mode={mode!r} would train on the evaluation set")
            train = np.asarray(data["train_split"], np.int64)
            idx = train if mode == "train" else np.setdiff1d(np.arange(n), train)
        else:
            idx = np.arange(n)

        self.img_path = [_reroot(p, base_path) for p in np.asarray(data["img"])[idx]]
        self.lidar_path = [_reroot(p, base_path) for p in np.asarray(data["lidar"])[idx]]
        self.rot_table = np.asarray(data["rot"], np.float64)[idx]
        self.trans_table = np.asarray(data["trans"], np.float64)[idx]

        # <base>/<date>/<date>_drive_xxxx_sync/image_02/data/<frame>.png
        date_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
            self.img_path[0]))))
        if os.path.exists(os.path.join(date_dir, "calib_cam_to_cam.txt")):
            rc = RawCalib(date_dir)
            self.cam_intrinsic, self.velo_extrinsic = rc.intrinsic, rc.extrinsic
        else:
            params = CALIB_BY_DATE[os.path.basename(date_dir)]
            self.cam_intrinsic = np.array(
                [[params["fx"], 0, params["cx"]], [0, params["fy"], params["cy"]], [0, 0, 1]])
            self.velo_extrinsic = np.hstack([np.asarray(params["rot"]),
                                             np.asarray(params["trans"])])

    def get_decalibration(self, index: Optional[int] = None) -> np.ndarray:
        """(3, 4) decalibration: sample ``index``'s row of the tables."""
        r = np.deg2rad(self.rot_table[index])
        return np.hstack([euler_to_rotmat(r[0], r[1], r[2]),
                          self.trans_table[index].reshape(3, 1)])
