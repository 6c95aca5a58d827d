"""KITTI odometry small-range dataset (the CMRNet protocol), a port of
``i2pnet_tpu/data/kitti_odometry_cmr.py`` on the port's transforms: the
same sample dict, the same RNG draws in the same order, so the two give
equal samples for one seed.

Per-frame local maps (h5), +-10 deg / +-2 m decalibrations (random in
training, a fixed table at test), the top 50 image rows cropped and the
rest resized to (img_H, img_W) (an upscale of the rows: 326 -> 384 on a
376-row frame; ``resize_image`` equals OpenCV's INTER_LINEAR there too),
8192 points sampled with repetition. The decalibrated cloud satisfies
warp(lidar, q_gt, t_gt) == Pc @ p.

``read_local_map`` is the one function that reads a map, and the only
place that imports h5py (when a sample is read).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from i2pnet_tpu_torch.data import transforms as T
from i2pnet_tpu_torch.data.calib import camera_matrix_cropping, read_calib
from i2pnet_tpu_torch.data.preprocess import generate_test_rt

TRAIN_SEQS = (3, 5, 6, 7, 8, 9)
TEST_SEQS = (0,)
CROP_TOP = 50


def read_local_map(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A local map's h5 file -> (xyz (3, N) f32, intensity (1, N) f32): the
    first three rows of its 'PC' dataset and its 'intensity'."""
    import h5py

    with h5py.File(path, "r") as hf:
        pc = np.asarray(hf["PC"], np.float32)[:3]
        intensity = np.asarray(hf["intensity"], np.float32)
    return pc, intensity


class KittiOdometryCMRDataset:
    """Index over (sequence, frame). Layout under root_path:
    ``kitti_processed_CMRNet/sequences/%02d/`` with ``local_maps/%06d.h5``
    ('PC' (4, N), 'intensity' (1, N)), ``image_2_npy/%06d.npy`` and
    ``calib.txt``. Outside training the decalibration comes from a fixed
    table (``test_rt``, rows [rx, ry, rz, tx, ty, tz]) keyed by the frame's
    id within its sequence, or from ``generate_test_rt`` under ``seed``."""

    def __init__(
        self,
        root_path: str,
        mode: str = "train",
        img_H: int = 384,
        img_W: int = 1280,
        sample_point: int = 8192,
        max_r: float = 10.0,
        max_t: float = 2.0,
        seqs: Optional[Sequence[int]] = None,
        test_rt: Optional[np.ndarray] = None,
        seed: int = 0,
        use_raw: bool = True,
        augment: bool = True,
        color_augment: bool = False,
    ):
        self.root_path = root_path
        self.mode = mode
        self.img_H, self.img_W = img_H, img_W
        self.sample_point = sample_point
        self.rx = self.ry = self.rz = max_r * np.pi / 180.0
        self.tx = self.ty = self.tz = max_t
        self.use_raw = use_raw
        # augment: the point jitter of training; color_augment: an opt-in
        # image jitter (the reference's own is a no-op)
        self.augment = augment
        self.color_augment = color_augment
        self.rng = np.random.default_rng(seed)

        if seqs is None:
            seqs = TRAIN_SEQS if mode == "train" else TEST_SEQS
        self.dataset: List[Tuple] = []
        for seq in seqs:
            seq_dir = os.path.join(root_path, "kitti_processed_CMRNet", "sequences", "%02d" % seq)
            pc_folder = os.path.join(seq_dir, "local_maps")
            if not os.path.isdir(pc_folder):
                continue
            frames = sorted(int(f.split(".")[0]) for f in os.listdir(pc_folder)
                            if f.endswith(".h5"))
            for fi in frames:
                self.dataset.append((pc_folder, os.path.join(seq_dir, "image_2_npy"),
                                     os.path.join(seq_dir, "calib.txt"), seq, fi))

        self.test_RT = test_rt
        if mode != "train":
            max_fi = max((fi for *_, fi in self.dataset), default=-1)
            if self.test_RT is None:
                self.test_RT = generate_test_rt(max_fi + 1 if self.dataset else 0,
                                                max_r_deg=max_r, max_t=max_t, seed=seed)
            assert len(self.test_RT) > max_fi, (
                f"test RT table too short: {len(self.test_RT)} rows, need frame id up to "
                f"{max_fi} (the table is keyed by the frame id within its sequence)")

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int) -> dict:
        pc_folder, img_folder, calib_path, seq, seq_i = self.dataset[index]
        Tr, cam_intrinsic, P2 = read_calib(calib_path)
        Pc = P2 @ np.vstack((Tr, [0, 0, 0, 1]))

        pc_np, intensity_np = read_local_map(os.path.join(pc_folder, "%06d.h5" % seq_i))
        origin_pc_np = pc_np.copy().T.astype(np.float32)

        if self.mode == "train":
            Pr = T.generate_random_transform(self.rng, self.tx, self.ty, self.tz, self.rx,
                                             self.ry, self.rz)
        else:
            # keyed by the frame id within the sequence, not the dataset index
            rx, ry, rz, tx, ty, tz = self.test_RT[seq_i]
            Pr = T.generate_transformation(rx, ry, rz, tx, ty, tz)
        decalib_q, decalib_t = T.decalib_ground_truth(Pr[:3, :])
        init_extrinsic = (np.linalg.inv(Pr) @ Pc)[:3, :]

        rgb_img = np.load(os.path.join(img_folder, "%06d.npy" % seq_i))[CROP_TOP:, :, :]
        intrinsic = camera_matrix_cropping(cam_intrinsic, dx=0, dy=CROP_TOP)
        h, w = rgb_img.shape[:2]
        rgb_img = T.resize_image(rgb_img, self.img_W, self.img_H)
        intrinsic[0, 0] *= self.img_W / w
        intrinsic[0, 2] *= self.img_W / w
        intrinsic[1, 1] *= self.img_H / h
        intrinsic[1, 2] *= self.img_H / h

        if self.mode == "train" and self.augment:
            pc_np = T.jitter_point_cloud(self.rng, pc_np)
        if self.mode == "train" and self.color_augment:
            rgb_img = T.color_jitter(self.rng, rgb_img)

        sel = T.sample_points_with_repetition(self.rng, pc_np.shape[1], self.sample_point)
        pc_np = pc_np[:, sel]
        origin_pc_np = origin_pc_np[sel, :]

        pc_h = np.concatenate([pc_np, np.ones((1, pc_np.shape[1]))], axis=0)
        pc_cam = (Pc[:3, :] @ pc_h).T.astype(np.float32)
        lidar_img = (init_extrinsic @ pc_h).T.astype(np.float32)

        return {
            "rgb": T.normalize_image(rgb_img),  # 0-255 floats: no normalisation
            "decalib_real_gt": decalib_q,
            "decalib_dual_gt": decalib_t,
            "init_extrinsic": init_extrinsic.astype(np.float32),
            "init_intrinsic": intrinsic.astype(np.float32),
            "raw_intrinsic": cam_intrinsic.astype(np.float32),
            "lidar": lidar_img,
            "resize_img": np.array([self.img_H, self.img_W], np.float32),
            "index": index,
            "path_info": "%02d %06d %06d" % (seq, seq_i, seq_i),
            "lidar_feats": lidar_img,
            "raw_point_xyz": origin_pc_np if self.use_raw else np.zeros_like(lidar_img),
            "pc_cam": pc_cam,
        }
