"""KITTI large-range dataset (DeepI2P split), a port of
``i2pnet_tpu/data/kitti_large_range.py`` on the port's transforms and
native IO: the same sample dict, the same RNG draws in the same order.

Mirrors ref src/kitti_odometry_corr_lidarnone_proj.py Kitti_Odometry_Dataset:
raw velodyne bins (+ precomputed surface normals), full-circle yaw + +-10 m
(tx, tz) decalibrations, zero-padding to a fixed point budget, image x0.5
then random/center crop to (img_H, img_W).

Split (ref :38-46): train seqs 0-8, val [9, 10], test [7, 8].
init_extrinsic = Pr @ Pc and decalib gt = Pr^-1 (ref :628-643).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from i2pnet_tpu_torch.data import transforms as T
from i2pnet_tpu_torch.data.calib import camera_matrix_cropping, read_calib

TRAIN_SEQS = tuple(range(9))
VAL_SEQS = (9, 10)
TEST_SEQS = (7, 8)


class KittiLargeRangeDataset:
    """Expected layout under root_path (ref :519-543):
    kitti_processed_DeepI2P/data_odometry_velodyne/sequences/%02d/voxel0.1-SNr0.6/%06d.npy
      with rows [x, y, z, intensity, nx, ny, nz] (7, N), or raw .bin files in
      .../velodyne/ plus normals npy when raw=True;
    .../sequences/%02d/image_2_npy/%06d.npy and .../calib.txt.
    """

    def __init__(
        self,
        root_path: str,
        mode: str = "train",
        img_H: int = 160,
        img_W: int = 512,
        img_scale: float = 0.5,
        sample_point: int = 150000,
        seqs: Optional[Sequence[int]] = None,
        seed: int = 0,
        raw: bool = False,
        y_aug: bool = False,
        augment: bool = True,
        color_augment: bool = False,
    ):
        self.root_path = root_path
        self.mode = mode
        self.img_H, self.img_W = img_H, img_W
        self.img_scale = img_scale
        self.sample_point = sample_point
        self.raw = raw
        self.augment = augment
        # reference parity: pc+normal jitter is real (ref :622-623), the
        # color jitter is a no-op (ColorJitter() without ranges, ref :510)
        self.color_augment = color_augment
        self.rng = np.random.default_rng(seed)

        # perturbation amplitudes (ref :292-305)
        self.rx, self.ry, self.rz = 0.0, 2 * math.pi, 0.0
        self.tx = 10.0
        self.ty = 0.5 if (mode == "train" and y_aug) else 0.0
        self.tz = 10.0

        if seqs is None:
            seqs = {"train": TRAIN_SEQS, "val": VAL_SEQS, "test": TEST_SEQS}[mode]
        self.dataset: List[Tuple] = []
        for seq in seqs:
            seq_dir = os.path.join(
                root_path,
                "kitti_processed_DeepI2P",
                "data_odometry_velodyne",
                "sequences",
                "%02d" % seq,
            )
            # raw mode reads FULL-RESOLUTION per-point normals (aligned
            # with the .bin scans, ref :52-54 'snr0.6'); the voxel-
            # downsampled folder only serves the non-raw path (ref :56-62)
            snr_folder = os.path.join(
                seq_dir, "snr0.6" if raw else "voxel0.1-SNr0.6"
            )
            pc_folder = os.path.join(seq_dir, "velodyne")
            img_folder = os.path.join(seq_dir, "image_2_npy")
            calib_path = os.path.join(seq_dir, "calib.txt")
            src = pc_folder if self.raw else snr_folder
            if not os.path.isdir(src):
                continue
            ext = ".bin" if self.raw else ".npy"
            frames = sorted(
                int(f.split(".")[0]) for f in os.listdir(src) if f.endswith(ext)
            )
            for fi in frames:
                self.dataset.append(
                    (pc_folder, snr_folder, img_folder, calib_path, seq, fi)
                )

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int) -> dict:
        pc_folder, snr_folder, img_folder, calib_path, seq, seq_i = self.dataset[index]
        Tr, cam_intrinsic, P2 = read_calib(calib_path)
        Tr = np.vstack((Tr, [0, 0, 0, 1]))
        Pc = P2 @ Tr

        # points (ref :526-543); shuffle deferred into the assembly pass
        from i2pnet_tpu_torch.data import native_io as NIO

        if self.raw:
            xyz_n3, intensity_1d = NIO.read_velodyne_bin(
                os.path.join(pc_folder, "%06d.bin" % seq_i)
            )
            sn_n3 = np.ascontiguousarray(
                np.load(os.path.join(snr_folder, "%06d.npy" % seq_i))
                .astype(np.float32)[-3:]
                .T
            )
            if sn_n3.shape[0] != xyz_n3.shape[0]:
                raise ValueError(
                    f"seq {seq} frame {seq_i}: {sn_n3.shape[0]} normals vs "
                    f"{xyz_n3.shape[0]} raw points — snr0.6 normals must be "
                    "full-resolution (per raw point)"
                )
        else:
            npy_data = np.load(os.path.join(snr_folder, "%06d.npy" % seq_i)).astype(
                np.float32
            )
            xyz_n3 = np.ascontiguousarray(npy_data[0:3].T)
            intensity_1d = np.ascontiguousarray(npy_data[3])
            sn_n3 = np.ascontiguousarray(npy_data[4:7].T)
        perm = self.rng.permutation(xyz_n3.shape[0])

        # decalibration (ref :628-643): gt = Pr^-1, init = Pr @ Pc
        Pr = T.generate_random_transform(
            self.rng, self.tx, self.ty, self.tz, self.rx, self.ry, self.rz,
            clip_tz=False,  # full +-10 m (ref :394-396, no clip)
        )
        Pr_inv = np.linalg.inv(Pr)
        decalib_q, decalib_t = T.decalib_ground_truth(Pr_inv[:3, :])
        init_extrinsic = (Pr @ Pc)[:3, :]

        rgb_img = np.load(os.path.join(img_folder, "%06d.npy" % seq_i))

        if self.mode == "train" and self.augment:
            xyz_n3 = T.jitter_point_cloud(self.rng, xyz_n3)
            sn_n3 = T.jitter_point_cloud(self.rng, sn_n3)

        # fused permute + transform + zero-pad (native when available)
        lidar_img, lidar_feats, origin_pc_np, _ = NIO.assemble_large_range_sample(
            xyz_n3, intensity_1d, sn_n3, perm, init_extrinsic, self.sample_point
        )

        # image: crop 50 top rows, scale, random/center crop (ref :714-746)
        crop_top = 50
        rgb_img = rgb_img[crop_top:, :, :]
        intrinsic = camera_matrix_cropping(cam_intrinsic, dx=0, dy=crop_top)
        h, w = rgb_img.shape[:2]
        rgb_img = T.resize_image(
            rgb_img, int(round(w * self.img_scale)), int(round(h * self.img_scale))
        )
        for i, j in ((0, 0), (0, 2), (1, 1), (1, 2)):
            intrinsic[i, j] *= self.img_scale
        h, w = rgb_img.shape[:2]
        if self.mode == "train":
            dx = int(self.rng.integers(0, w - self.img_W + 1))
            dy = int(self.rng.integers(0, h - self.img_H + 1))
        else:
            dx = (w - self.img_W) // 2
            dy = (h - self.img_H) // 2
        rgb_img = rgb_img[dy : dy + self.img_H, dx : dx + self.img_W, :]
        intrinsic = camera_matrix_cropping(intrinsic, dx=dx, dy=dy)

        if self.mode == "train" and self.color_augment:
            rgb_img = T.color_jitter(self.rng, rgb_img)
        rgb = T.normalize_image(rgb_img)

        return {
            "rgb": rgb,
            "decalib_real_gt": decalib_q,
            "decalib_dual_gt": decalib_t,
            "init_extrinsic": init_extrinsic.astype(np.float32),
            "init_intrinsic": intrinsic.astype(np.float32),
            "raw_intrinsic": cam_intrinsic.astype(np.float32),
            "lidar": lidar_img,
            "resize_img": np.array([self.img_scale, self.img_scale], np.float32),
            "index": index,
            "path_info": "%02d %06d %06d" % (seq, seq_i, seq_i),
            "lidar_feats": lidar_feats,
            "raw_point_xyz": origin_pc_np,
        }
