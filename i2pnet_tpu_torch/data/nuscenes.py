"""nuScenes datasets, small-range (the CMR protocol) and large-range, a
port of ``i2pnet_tpu/data/nuscenes.py`` on the port's transforms: the same
sample dicts, the same RNG draws in the same order.

Small-range: h5 local maps, +-10 deg / +-2 m decalibrations, 8192 points
without replacement (zero-padded below), the top 100 image rows cropped,
the rest scaled by 0.8 and cropped to 640x1280, ImageNet normalisation.
Large-range: a 150,000-point budget (zero-padded), full-circle yaw and
+-10 m (tx, tz), the image scaled by (0.2, 0.32) and cropped to 160x512.

Split lists are pickled lists whose items are ((map_relpath, cam_path),
K (3, 3), velo2cam2 (4, 4), meta); a relative path is joined to the root.
The map goes through ``kitti_odometry_cmr.read_local_map`` (h5py) and the
camera frame through ``read_image`` (PIL), each imported when a sample is
read.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence

import numpy as np

from i2pnet_tpu_torch.data import kitti_odometry_cmr
from i2pnet_tpu_torch.data import transforms as T
from i2pnet_tpu_torch.data.calib import camera_matrix_cropping
from i2pnet_tpu_torch.data.preprocess import generate_test_rt


def read_image(path: str) -> np.ndarray:
    """A camera frame's file -> (H, W, 3) uint8, read by PIL."""
    from PIL import Image

    return np.array(Image.open(path), np.uint8)


def _load_splits(paths: Sequence[str]) -> list:
    dataset = []
    for p in paths:
        with open(p, "rb") as f:
            dataset.extend(pickle.load(f))
    return dataset


class _NuScenesBase:
    def __init__(self, root: str, split_paths, mode: str, seed: int):
        self.root = root
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.dataset = _load_splits(split_paths)

    def __len__(self):
        return len(self.dataset)

    def _resolve(self, path: str) -> str:
        # map paths are relative to the preprocessing output (the root);
        # camera paths may be absolute into the nuScenes dataroot
        return path if os.path.isabs(path) else os.path.join(self.root, path)

    def _load_pc(self, lidar_path: str):
        pc, intensity = kitti_odometry_cmr.read_local_map(self._resolve(lidar_path))
        idx = self.rng.permutation(pc.shape[1])
        return pc[:, idx], intensity[:, idx]

    def _load_image(self, cam_path: str) -> np.ndarray:
        return read_image(self._resolve(cam_path))

    def _image_pipeline(self, img, K, scale_h, scale_w, img_H, img_W, crop_top=100):
        img = img[crop_top:, :, :]
        K = camera_matrix_cropping(K, dx=0, dy=crop_top)
        img = T.resize_image(img, int(round(img.shape[1] * scale_w)),
                             int(round(img.shape[0] * scale_h)))
        K[0, 0] *= scale_w
        K[0, 2] *= scale_w
        K[1, 1] *= scale_h
        K[1, 2] *= scale_h
        if self.mode == "train":
            dx = int(self.rng.integers(0, img.shape[1] - img_W + 1))
            dy = int(self.rng.integers(0, img.shape[0] - img_H + 1))
        else:
            dx = (img.shape[1] - img_W) // 2
            dy = (img.shape[0] - img_H) // 2
        img = img[dy:dy + img_H, dx:dx + img_W, :]
        return img, camera_matrix_cropping(K, dx=dx, dy=dy)

    @staticmethod
    def _nus_raw_frame(pc_np):
        """The raw frame for the raw-feature grouping: (x, y, z) -> (y, -x,
        z), as (N, 3)."""
        origin = pc_np.copy().T.astype(np.float32)
        origin[:, 0] = pc_np[1, :]
        origin[:, 1] = -pc_np[0, :]
        return origin

    def _raw_points(self, pc_np):
        return self._nus_raw_frame(pc_np) if self.use_raw else pc_np.copy().T.astype(np.float32)


class NuScenesCMRDataset(_NuScenesBase):
    """Small-range (the CMR protocol). Outside training the decalibration
    comes from a fixed table (``test_rt``) keyed by the sample's index, or
    from ``generate_test_rt`` under ``seed``."""

    def __init__(
        self,
        root: str,
        split_paths,
        mode: str = "train",
        img_H: int = 640,
        img_W: int = 1280,
        sample_point: int = 8192,
        max_r: float = 10.0,
        max_t: float = 2.0,
        test_rt: Optional[np.ndarray] = None,
        seed: int = 0,
        use_raw: bool = True,
        augment: bool = True,
    ):
        super().__init__(root, split_paths, mode, seed)
        self.img_H, self.img_W = img_H, img_W
        self.sample_point = sample_point
        self.r_amp = max_r * np.pi / 180.0
        self.t_amp = max_t
        self.test_RT = test_rt
        if mode != "train" and self.test_RT is not None:
            assert len(self.test_RT) >= len(self.dataset), (
                f"test RT table too short: {len(self.test_RT)} rows for {len(self.dataset)} "
                "samples")
        if mode != "train" and self.test_RT is None:
            self.test_RT = generate_test_rt(len(self.dataset), max_r_deg=max_r, max_t=max_t,
                                            seed=seed)
        self.use_raw = use_raw
        self.augment = augment

    def __getitem__(self, index: int) -> dict:
        (lp, cp), K, velo2cam2, _ = self.dataset[index]
        cam_intrinsic = np.asarray(K, np.float64).copy()
        pc_np, _ = self._load_pc(lp)
        img, intrinsic = self._image_pipeline(self._load_image(cp), cam_intrinsic.copy(), 0.8,
                                              0.8, self.img_H, self.img_W)
        if self.mode == "train" and self.augment:
            img = T.color_jitter(self.rng, img)
            pc_np = T.jitter_point_cloud(self.rng, pc_np)

        if self.mode == "train":
            # no cap on tz, unlike the KITTI CMR sampler
            Pr = T.generate_random_transform(self.rng, self.t_amp, self.t_amp, self.t_amp,
                                             self.r_amp, self.r_amp, self.r_amp, clip_tz=False)
        else:
            rx, ry, rz, tx, ty, tz = self.test_RT[index]
            Pr = T.generate_transformation(rx, ry, rz, tx, ty, tz)
        decalib_q, decalib_t = T.decalib_ground_truth(Pr[:3, :])
        velo2cam2 = np.asarray(velo2cam2, np.float64)
        init_extrinsic = (np.linalg.inv(Pr) @ velo2cam2)[:3, :]

        origin_pc_np = self._raw_points(pc_np)
        pc_h = np.concatenate([pc_np, np.ones((1, pc_np.shape[1]))], axis=0)
        pc_cam = (velo2cam2[:3, :] @ pc_h).T.astype(np.float32)
        lidar = (init_extrinsic @ pc_h).T.astype(np.float32)

        N = lidar.shape[0]
        if N >= self.sample_point:
            sel = self.rng.choice(N, self.sample_point, replace=False)
            lidar, origin_pc_np, pc_cam = lidar[sel], origin_pc_np[sel], pc_cam[sel]
        else:
            lidar = T.zero_pad_points(lidar, self.sample_point)
            origin_pc_np = T.zero_pad_points(origin_pc_np, self.sample_point)
            pc_cam = T.zero_pad_points(pc_cam, self.sample_point)

        return {
            "rgb": T.normalize_image(img, imagenet=True),
            "decalib_real_gt": decalib_q,
            "decalib_dual_gt": decalib_t,
            "init_extrinsic": init_extrinsic.astype(np.float32),
            "init_intrinsic": intrinsic.astype(np.float32),
            "raw_intrinsic": cam_intrinsic.astype(np.float32),
            "lidar": lidar,
            "lidar_feats": lidar,
            "raw_point_xyz": origin_pc_np,
            "pc_cam": pc_cam,
            "resize_img": np.array([0.8, 0.8], np.float32),
            "index": index,
            "path_info": "%d" % index,
        }


class NuScenesLargeRangeDataset(_NuScenesBase):
    """Large-range. Every mode draws its decalibration (full-circle yaw,
    +-10 m in tx and tz). Unlike the CMR loaders, the ground truth is the
    inverse of the drawn transform and the initial extrinsic is the drawn
    transform times velo2cam2."""

    def __init__(
        self,
        root: str,
        split_paths,
        mode: str = "train",
        img_H: int = 160,
        img_W: int = 512,
        sample_point: int = 150000,
        seed: int = 0,
        use_raw: bool = True,
        augment: bool = True,
    ):
        super().__init__(root, split_paths, mode, seed)
        self.img_H, self.img_W = img_H, img_W
        self.sample_point = sample_point
        self.use_raw = use_raw
        self.augment = augment

    def __getitem__(self, index: int) -> dict:
        (lp, cp), K, velo2cam2, _ = self.dataset[index]
        cam_intrinsic = np.asarray(K, np.float64).copy()
        pc_np, intensity_np = self._load_pc(lp)
        img, intrinsic = self._image_pipeline(self._load_image(cp), cam_intrinsic.copy(), 0.2,
                                              0.32, self.img_H, self.img_W)
        if self.mode == "train" and self.augment:
            img = T.color_jitter(self.rng, img)
            pc_np = T.jitter_point_cloud(self.rng, pc_np)

        Pr = T.generate_random_transform(self.rng, 10.0, 0.0, 10.0, 0.0, 2 * np.pi, 0.0,
                                         clip_tz=False)
        decalib_q, decalib_t = T.decalib_ground_truth(np.linalg.inv(Pr)[:3, :])
        velo2cam2 = np.asarray(velo2cam2, np.float64)
        init_extrinsic = (Pr @ velo2cam2)[:3, :]

        origin_pc_np = self._raw_points(pc_np)
        pc_h = np.concatenate([pc_np, np.ones((1, pc_np.shape[1]))], axis=0)
        lidar = (init_extrinsic @ pc_h).T.astype(np.float32)

        return {
            "rgb": T.normalize_image(img, imagenet=True),
            "decalib_real_gt": decalib_q,
            "decalib_dual_gt": decalib_t,
            "init_extrinsic": init_extrinsic.astype(np.float32),
            "init_intrinsic": intrinsic.astype(np.float32),
            "raw_intrinsic": cam_intrinsic.astype(np.float32),
            "lidar": T.zero_pad_points(lidar, self.sample_point),
            "lidar_feats": T.zero_pad_points(intensity_np.astype(np.float32).T, self.sample_point),
            "raw_point_xyz": T.zero_pad_points(origin_pc_np, self.sample_point),
            "resize_img": np.array([0.2, 0.32], np.float32),
            "index": index,
            "path_info": "%d" % index,
        }
