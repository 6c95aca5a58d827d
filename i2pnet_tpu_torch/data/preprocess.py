"""Offline preprocessing and the protocols' fixed-decalibration tables: the
port of ``i2pnet_tpu/data/preprocess.py``.

The offline builders (ref data_preprocess/), numpy and scipy only:
  * ``bin_to_npy_with_normals``: kitti_pc_bin_to_npy_with_downsample_sn.py
    (a voxel downsample and PCA surface normals over a hybrid KD-tree search,
    r=0.6, nn=30: scipy's cKDTree for Open3D's);
  * ``images_to_npy``: kitti_png_to_npy.py (PIL, imported inside);
  * ``poses_to_npz``: kitti_pose.py;
  * ``build_local_maps``: CMRNet_script/kitti_maps_cmr.py (a voxelised
    accumulated map and one local crop a frame; the h5 files through
    ``write_local_map``, the one function that imports h5py);
  * ``accumulate_point_cloud`` / ``process_sequence_accumulation``:
    kitti_pc_acc.py (neighbour sweeps accumulated into each frame).

The tables: the test tables of the KITTI odometry and nuScenes small-range
protocols (``generate_test_rt``, ``load_test_rt``, the 10-seed protocol's
``cmr_seed_value`` and ``cmr_test_rt_path``) and the RGGNet protocol's
splits (``RGG_SPLITS``, ``generate_rgg_splits``). ``load_test_rt`` reads
CSV tables with the ``csv`` module, so ``--test_rt`` runs where pandas is
not installed."""

from __future__ import annotations

import csv
import os
import pickle
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

# id, tx..tz, rx..rz (the reference CSV's column order) -> rx..rz, tx..tz
_ID_FIRST = [4, 5, 6, 1, 2, 3]
_NAMES = ["rx", "ry", "rz", "tx", "ty", "tz"]
_DECIMAL = re.compile(r"([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?")
_POW10 = [float(f"1e{k}") for k in range(309)]

# the RGGNet protocol's splits: raw-KITTI drives, sample counts and
# decalibration amplitudes (euler degrees, meters)
_RGG_DRIVES_0926 = (1, 2, 9, 11, 13, 14, 15, 17, 18, 19, 20, 22, 23, 27, 28, 29, 32, 35, 36,
                    39, 46, 48, 51, 52, 56, 57, 59, 60, 61, 64, 79, 84, 86, 87, 91, 93, 95, 96,
                    101, 104, 106, 113, 117)
RGG_SPLITS = {
    "train1_val": dict(date="2011_09_26", num=24000, drives=_RGG_DRIVES_0926, rot=15.0,
                       trans=0.2, train_split=22000),
    "train2": dict(date="2011_09_26", num=4000, drives=_RGG_DRIVES_0926, rot=0.0, trans=0.3),
    "train3": dict(date="2011_09_26", num=4000, drives=_RGG_DRIVES_0926, rot=20.0, trans=0.0),
    "train_val_ex": dict(date="2011_10_03", num=2000, drives=(27,), rot=2.0, trans=0.3,
                         train_split=1800),
    "T1": dict(date="2011_09_26", num=2000, drives=(5, 70), rot=15.0, trans=0.2),
    "T2a": dict(date="2011_09_26", num=2000, drives=_RGG_DRIVES_0926, rot=10.0, trans=0.2),
    "T2b": dict(date="2011_09_26", num=2000, drives=(5, 70), rot=10.0, trans=0.2),
    "T3": dict(date="2011_10_03", num=2000, drives=(27,), rot=2.0, trans=0.3),
}


def generate_rgg_splits(base_path: str, save_dir: str, seed: int = 0,
                        splits: Optional[Sequence[str]] = None) -> list:
    """The RGGNet protocol's fixed-decalibration sets: per split, ``num``
    (image, scan) pairs drawn from the drives (whole permutations tiled,
    then topped up, where the drives hold fewer) and a per-sample table of
    euler-degree rotations and meter translations, uniform in
    +-amplitude; pickled as ``rgg_data_<key>.pkl``. Splits with a
    ``train_split`` count also carry the training indices. Returns the
    written paths."""
    os.makedirs(save_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    written = []
    for key, p in RGG_SPLITS.items():
        if splits is not None and key not in splits:
            continue
        imgs, lidars = [], []
        for drive in p["drives"]:
            drive_dir = os.path.join(base_path, p["date"], f"{p['date']}_drive_{drive:04d}_sync")
            img_dir = os.path.join(drive_dir, "image_02", "data")
            lid_dir = os.path.join(drive_dir, "velodyne_points", "data")
            if not os.path.isdir(img_dir) or not os.path.isdir(lid_dir):
                continue
            d_imgs = [os.path.join(img_dir, f) for f in sorted(os.listdir(img_dir))
                      if f.endswith(".png")]
            d_lidars = [os.path.join(lid_dir, f) for f in sorted(os.listdir(lid_dir))
                        if f.endswith(".bin")]
            # positional pairing: a dropped frame would shift every later pair
            if len(d_imgs) != len(d_lidars):
                raise ValueError(f"{drive_dir}: {len(d_imgs)} images vs {len(d_lidars)} scans "
                                 "— cannot pair positionally")
            imgs.extend(d_imgs)
            lidars.extend(d_lidars)
        M, N = len(imgs), p["num"]
        if M == 0:
            continue
        if M >= N:
            choice = rng.choice(M, N, replace=False)
        else:
            choice = np.concatenate([rng.permutation(M) for _ in range(N // M)]
                                    + [rng.choice(M, N % M, replace=False)])[:N]
        data = {
            "img": np.array(imgs)[choice],
            "lidar": np.array(lidars)[choice],
            "rot": rng.random((N, 3)) * (2 * p["rot"]) - p["rot"],
            "trans": rng.random((N, 3)) * (2 * p["trans"]) - p["trans"],
        }
        if "train_split" in p:
            data["train_split"] = rng.choice(N, min(p["train_split"], N), replace=False)
        out = os.path.join(save_dir, f"rgg_data_{key}.pkl")
        with open(out, "wb") as f:
            pickle.dump(data, f)
        written.append(out)
    return written


def generate_test_rt(n: int, max_r_deg: float = 10.0, max_t: float = 2.0, seed: int = 0,
                     clip_tz: bool = False) -> np.ndarray:
    """A fixed test decalibration table, (n, 6) f64 rows [rx, ry, rz, tx,
    ty, tz] in rad and m, each uniform in +-amplitude; ``clip_tz`` caps tz
    at 1 m as the KITTI CMR train sampler does (tables default to the full
    range)."""
    rng = np.random.default_rng(seed)
    r = np.deg2rad(max_r_deg)
    rt = np.stack([
        rng.uniform(-r, r, n),
        rng.uniform(-r, r, n),
        rng.uniform(-r, r, n),
        rng.uniform(-max_t, max_t, n),
        rng.uniform(-max_t, max_t, n),
        rng.uniform(-max_t, min(max_t, 1.0) if clip_tz else max_t, n),
    ], axis=1)
    return rt.astype(np.float64)


def _cells(row: List[str]) -> List[str]:
    return [c.strip() for c in row if c.strip()]


def _numeric_row(cells: List[str]) -> bool:
    if not cells:
        return False
    try:
        [float(c) for c in cells]
    except ValueError:
        return False
    return True


def _csv_float(text: str) -> float:
    """A CSV cell as the JAX package's reader (pandas' C parser) rounds it:
    up to 17 significant digits gathered into a double one digit at a time,
    then one multiplication or division by a power of ten. A 17-digit value
    can land 1 ulp from Python's correctly rounded ``float``; this keeps
    the two packages' tables equal bit for bit. Cells that are no plain
    decimal (nan, inf) go to ``float``."""
    m = _DECIMAL.fullmatch(text.strip())
    if m is None or not (m.group(2) or m.group(3)):
        return float(text)
    sign, whole, frac, exp = m.groups()
    number, exponent, digits = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + int(ch)
            digits += 1
        else:
            exponent += 1
    for ch in (frac or "")[:max(0, 17 - digits)]:
        number = number * 10.0 + int(ch)
        exponent -= 1
    if sign == "-":
        number = -number
    exponent += int(exp) if exp else 0
    if exponent > 308:
        return float("inf") if number > 0 else float("-inf") if number < 0 else 0.0
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _floats(rows: List[List[str]]) -> np.ndarray:
    return np.array([[_csv_float(c) for c in row] for row in rows], np.float64)


def load_test_rt(path: str) -> np.ndarray:
    """A fixed test-decalibration table in either protocol's format, as
    (N, 6) f64 rows [rx, ry, rz, tx, ty, tz]:

    - a CSV with a header: named ``rx..tz`` columns are taken in that order
      whatever their position (the reference's ``id,tx,ty,tz,rx,ry,rz``
      puts translation first); another 7-column header is read as that
      layout;
    - a headerless CSV (its first row all numbers, so it is not taken for
      a header and sample 0 is kept): 6 columns as they are, 7 as ``id``
      then translation then rotation;
    - a per-seed pickle of the 10-seed protocol: a list of 6-element rows
      in rx-first order (or 7, reordered as above).

    Raises ``ValueError`` on any other width."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            rows = pickle.load(f)
        rt = np.asarray(rows, np.float64)
        if rt.shape[1] == 7:
            rt = rt[:, _ID_FIRST]
    else:
        with open(path, newline="") as f:
            rows = [row for row in csv.reader(f) if any(c.strip() for c in row)]
        if _numeric_row(_cells(rows[0])):
            rt = _floats([_cells(row) for row in rows])
            if rt.shape[1] == 7:
                rt = rt[:, _ID_FIRST]
        else:
            header = [c.strip().lower() for c in rows[0]]
            body = [[c.strip() for c in row] for row in rows[1:]]
            if all(w in header for w in _NAMES):
                rt = _floats([[row[header.index(w)] for w in _NAMES] for row in body])
            else:
                rt = _floats(body)
                if rt.shape[1] == 7:
                    rt = rt[:, _ID_FIRST]
    if rt.ndim != 2 or rt.shape[1] != 6:
        raise ValueError(f"{path}: expected 6 (or id+6) columns, got {rt.shape[-1]}")
    return rt


def cmr_seed_value(cmr_seed: int) -> int:
    """The 10-seed protocol's seed -> file-name tag: ((seed % 2) * 5) *
    10 ** (seed // 2), so seeds 0-9 give 0, 5, 0, 50, 0, 500, 0, 5000, 0,
    50000."""
    return ((cmr_seed % 2) * 5) * 10 ** (cmr_seed // 2)


def cmr_test_rt_path(dir_path: str, seq: str, max_r: float, max_t: float,
                     cmr_seed: int) -> str:
    """The per-seed pickle of the 10-seed protocol under ``dir_path``:
    ``test_RT_seq<seq>_<max_r>_<max_t>_<tag>.pkl``."""
    return os.path.join(
        dir_path, f"test_RT_seq{seq}_{max_r:.2f}_{max_t:.2f}_{cmr_seed_value(cmr_seed):d}.pkl")


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Average points per voxel. points: (N, C) with xyz first."""
    coords = np.floor_divide(points[:, :3] - points[:, :3].min(0), voxel).astype(np.int64)
    _, inverse, counts = np.unique(coords, axis=0, return_inverse=True, return_counts=True)
    out = np.zeros((counts.shape[0], points.shape[1]), np.float64)
    np.add.at(out, inverse, points)
    return (out / counts[:, None]).astype(np.float32)


def estimate_normals(points: np.ndarray, radius: float = 0.6, max_nn: int = 30) -> np.ndarray:
    """PCA surface normals over a hybrid KD-tree search (the reference's
    Open3D KDTreeSearchParamHybrid(radius=0.6, max_nn=30)); a point with
    fewer than 3 neighbours gets (0, 0, 1)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    dists, idx = tree.query(points, k=max_nn, distance_upper_bound=radius)
    normals = np.zeros_like(points)
    valid = dists < np.inf
    for i in range(points.shape[0]):
        nbrs = idx[i][valid[i]]
        if len(nbrs) < 3:
            normals[i] = [0, 0, 1]
            continue
        p = points[nbrs] - points[nbrs].mean(0)
        cov = p.T @ p
        w, v = np.linalg.eigh(cov)
        normals[i] = v[:, 0]
    return normals.astype(np.float32)


def bin_to_npy_with_normals(bin_path: str, out_path: str, voxel: float = 0.1,
                            sn_radius: float = 0.6, sn_max_nn: int = 30) -> np.ndarray:
    """A velodyne .bin -> a (7, N) npy of rows [x, y, z, intensity, nx, ny, nz]."""
    pts = np.fromfile(bin_path, np.float32).reshape(-1, 4)
    if voxel > 0:
        pts = voxel_downsample(pts, voxel)
    normals = estimate_normals(pts[:, :3], sn_radius, sn_max_nn)
    out = np.concatenate([pts, normals], axis=1).T.astype(np.float32)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.save(out_path, out)
    return out


def images_to_npy(img_dir: str, out_dir: str) -> int:
    """The PNG images of a directory -> uint8 npy arrays (ref
    kitti_png_to_npy.py:20-33); PIL decodes them."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for fname in sorted(os.listdir(img_dir)):
        if not fname.endswith(".png"):
            continue
        arr = np.array(Image.open(os.path.join(img_dir, fname)), np.uint8)
        np.save(os.path.join(out_dir, fname.replace(".png", ".npy")), arr)
        n += 1
    return n


def poses_to_npz(pose_txt: str, out_dir: str) -> int:
    """An odometry pose txt (12 floats a row) -> one 4x4 npz a frame
    (ref kitti_pose.py:26-44)."""
    os.makedirs(out_dir, exist_ok=True)
    poses = np.loadtxt(pose_txt).reshape(-1, 3, 4)
    for i, p in enumerate(poses):
        T = np.vstack([p, [0, 0, 0, 1]])
        np.savez(os.path.join(out_dir, "%06d.npz" % i), pose=T)
    return len(poses)


def write_local_map(path: str, pc: np.ndarray, intensity: np.ndarray) -> None:
    """One local map as h5: datasets 'PC' (4, N) and 'intensity' (1, N),
    uncompressed, as the JAX package writes them."""
    import h5py

    with h5py.File(path, "w") as hf:
        hf["PC"] = pc
        hf["intensity"] = intensity


def build_local_maps(scans: Sequence[np.ndarray], poses: Sequence[np.ndarray], out_dir: str,
                     voxel: float = 0.1, x_range: Tuple[float, float] = (-10.0, 100.0),
                     y_range: Tuple[float, float] = (-25.0, 25.0)) -> int:
    """Accumulate scans into a voxelised global map, then crop one local map
    a pose into ``out_dir/%06d.h5`` (ref CMRNet_script/kitti_maps_cmr.py:43-120).

    scans: (N_i, >=4) arrays [xyz, intensity] in the sensor frame; poses:
    4x4 sensor-to-world transforms."""
    world = []
    for scan, T in zip(scans, poses):
        xyz1 = np.concatenate([scan[:, :3], np.ones((scan.shape[0], 1))], axis=1)
        w = (T @ xyz1.T).T[:, :3]
        world.append(np.concatenate([w, scan[:, 3:4]], axis=1))
    gmap = voxel_downsample(np.concatenate(world, 0), voxel)

    os.makedirs(out_dir, exist_ok=True)
    for i, T in enumerate(poses):
        Tinv = np.linalg.inv(T)
        local = (Tinv @ np.concatenate([gmap[:, :3], np.ones((gmap.shape[0], 1))], axis=1).T
                 ).T[:, :3]
        m = ((local[:, 0] > x_range[0]) & (local[:, 0] < x_range[1])
             & (local[:, 1] > y_range[0]) & (local[:, 1] < y_range[1]))
        write_local_map(
            os.path.join(out_dir, "%06d.h5" % i),
            np.concatenate([local[m].T, np.ones((1, int(m.sum())))], axis=0).astype(np.float32),
            gmap[m, 3:4].T.astype(np.float32))
    return len(poses)


def _load_pose(path: str) -> np.ndarray:
    """A frame's 4x4 pose npz: this package's 'pose' key or the reference's
    positional 'arr_0' (ref kitti_pc_acc.py:47,81)."""
    d = np.load(path)
    return (d["pose"] if "pose" in d else d["arr_0"]).astype(np.float32)


def accumulate_point_cloud(pc_folder: str, pose_folder: str, seq_i: int, seq_sample_num: int,
                           Pc: np.ndarray, accumulation_frame_num: int = 3,
                           accumulation_frame_skip: int = 6,
                           rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Neighbour sweeps accumulated into frame i's cloud (ref
    data_preprocess/kitti_pc_acc.py:25-112 get_accumulated_pc).

    pc_folder holds (7, N) npys [xyz, intensity, normals]; pose_folder one
    4x4 npz a frame. Up to accumulation_frame_num frames are taken every
    accumulation_frame_skip steps in each direction; each is warped into
    frame i's camera-conditioned frame by Pc^-1 @ P_i^-1 P_j @ Pc, its
    normals by the rotation alone. Frame i's own points are shuffled first
    (downstream loaders truncate, so the order must not encode the scan
    pattern). Returns (7, M) [xyz, intensity, normals]."""
    rng = rng or np.random.default_rng(0)
    data = np.load(os.path.join(pc_folder, "%06d.npy" % seq_i)).astype(np.float32)
    data = data[:, rng.permutation(data.shape[1])]
    parts = [data]
    P_oi = _load_pose(os.path.join(pose_folder, "%06d.npz" % seq_i))
    P_io = np.linalg.inv(P_oi)
    Pc_inv = np.linalg.inv(Pc)
    for stride in (-accumulation_frame_skip, accumulation_frame_skip):
        counter = 0
        found = 0
        while found < accumulation_frame_num:
            counter += 1
            seq_j = seq_i + stride * counter
            if seq_j < 0 or seq_j >= seq_sample_num:
                break
            nb = np.load(os.path.join(pc_folder, "%06d.npy" % seq_j)).astype(np.float32)
            P_oj = _load_pose(os.path.join(pose_folder, "%06d.npz" % seq_j))
            P = Pc_inv @ (P_io @ P_oj) @ Pc
            xyz = P[:3, :3] @ nb[0:3] + P[:3, 3:4]
            sn = P[:3, :3] @ nb[4:7]
            parts.append(np.concatenate([xyz, nb[3:4], sn], axis=0))
            found += 1
    return np.concatenate(parts, axis=1)


def process_sequence_accumulation(pc_folder: str, pose_folder: str, calib_path: str,
                                  out_folder_snr: str, out_folder_pc: str,
                                  downsample_voxel: float = 0.3, max_points: int = 2 * 20480,
                                  seed: int = 0) -> int:
    """kitti_pc_acc.py's per-sequence driver (ref :163-202): accumulate every
    frame, voxel-downsample where the cloud exceeds max_points, and write the
    full (7, N) '*_snr_acc' npy and the bare-xyz '*_acc' npy."""
    from i2pnet_tpu_torch.data.calib import read_calib

    Tr, _, P = read_calib(calib_path)
    Pc = P @ np.vstack([Tr, [0, 0, 0, 1]])
    os.makedirs(out_folder_snr, exist_ok=True)
    os.makedirs(out_folder_pc, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = len([f for f in os.listdir(pc_folder) if f.endswith(".npy")])
    for i in range(n):
        acc = accumulate_point_cloud(pc_folder, pose_folder, i, n, Pc, rng=rng)
        if acc.shape[1] > max_points:
            acc = voxel_downsample(acc.T, downsample_voxel).T
        np.save(os.path.join(out_folder_snr, "%06d.npy" % i), acc.astype(np.float32))
        np.save(os.path.join(out_folder_pc, "%06d.npy" % i), acc[0:3].astype(np.float32))
    return n
