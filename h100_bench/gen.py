"""The one traffic generator: batches of (image, scan, decalibration,
ground truth) drawn from ``--seed``, as the loaders emit them, from a
configuration file (the sensor, the image, the point count) and a traffic
file (the loop, the batch, the scan's geometry, the decalibration's
amplitudes). Everything is numpy on the host; the harness holds the pool
in pinned memory, from which the eval loop's prefetch and the train loop
copy each batch to the card.

A scan's ``kind`` names the file ``scans/<kind>.py`` that draws it:
``points(rng, config, scan, Pr)`` gives the cloud the model sees, its
features and the raw cloud, as the loader emits them (``camera``: a KITTI
drive's points in the camera frame; ``sweep``: one spinning-LiDAR sweep,
padded). A new kind is a new file.

The decalibration Pr is drawn as the loaders draw it: euler ``xzy`` angles
uniform within ``rot_deg`` (rx, ry, rz) and a translation uniform within
``trans_m``, tz capped at ``tz_max`` where given (the CMR train sampler).
Camera-frame protocols (``target: "pr"``) see the cloud ``Pr^-1 X`` and
learn Pr; the large-range one (``target: "pr_inv"``) sees ``Pr Tr X`` and
learns Pr^-1.
"""

from __future__ import annotations

import importlib
import math
import re
from typing import Dict, List

import numpy as np

# the LiDAR frame (x ahead, y left, z up) to the camera frame (x right,
# y down, z ahead): KITTI's Tr_velo_to_cam without its small offsets
VELO_TO_CAM = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])

MODEL_RENAMES = {"init_intrinsic": "intrinsic", "decalib_real_gt": "decalib_q_gt",
                 "decalib_dual_gt": "decalib_t_gt", "raw_point_xyz": "raw_xyz"}


def rng_for(seed: int, *stream) -> np.random.Generator:
    """An independent generator per (seed, stream), for any seed up to 2**64."""
    words = [int(seed) % (1 << 64)] + [int(s) for s in stream]
    return np.random.default_rng(np.random.SeedSequence(words))


def euler_xzy(rx: float, ry: float, rz: float) -> np.ndarray:
    """Rotation.from_euler("xzy", [rx, rz, ry]): extrinsic x, then z, then y."""
    cx, sx, cy, sy, cz, sz = (math.cos(rx), math.sin(rx), math.cos(ry), math.sin(ry),
                              math.cos(rz), math.sin(rz))
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Ry @ Rz @ Rx


def quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0."""
    m = R
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.asarray(q) / np.linalg.norm(q)
    return (q if q[0] >= 0 else -q).astype(np.float32)


def decalibration(rng, spec: dict) -> np.ndarray:
    """The 4x4 perturbation Pr of one pair."""
    rot = np.radians(spec["rot_deg"])
    trans = spec["trans_m"]
    tz_hi = trans[2] if spec.get("tz_max") is None else min(trans[2], spec["tz_max"])
    t = [rng.uniform(-trans[0], trans[0]), rng.uniform(-trans[1], trans[1]),
         rng.uniform(-trans[2], tz_hi)]
    a = [rng.uniform(-rot[0], rot[0]), rng.uniform(-rot[1], rot[1]), rng.uniform(-rot[2], rot[2])]
    P = np.eye(4)
    P[:3, :3] = euler_xzy(*a)
    P[:3, 3] = t
    return P


def ranges(rng, n: int, spec: dict) -> np.ndarray:
    """Ranges uniform in ``near_m`` (a ``1 - far_share`` of them) and in
    ``far_m``."""
    near, far = spec["near_m"], spec["far_m"]
    return np.where(rng.uniform(size=n) < 1.0 - spec["far_share"],
                    rng.uniform(near[0], near[1], n), rng.uniform(far[0], far[1], n))


def scan_kind(kind: str):
    """The module ``scans/<kind>.py``."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", kind):
        raise ValueError(f"gen: scan kind {kind!r} is no module name")
    return importlib.import_module(f"{__package__}.scans.{kind}")


def intrinsic(config: dict) -> np.ndarray:
    k = config["intrinsic"]
    return np.array([[k["fx"], 0, k["cx"]], [0, k["fy"], k["cy"]], [0, 0, 1]], np.float32)


def make_pair(rng, config: dict, traffic: dict) -> Dict[str, np.ndarray]:
    """One sample with the loader's keys."""
    H, W = config["image_hw"]
    scan, dec = traffic["scan"], traffic["decalibration"]
    Pr = decalibration(rng, dec)
    lidar, feats, raw = scan_kind(scan["kind"]).points(rng, config, scan, Pr)
    gt = Pr if dec["target"] == "pr" else np.linalg.inv(Pr)
    return {
        "rgb": rng.uniform(0, 255, (H, W, 3)).astype(np.float32),
        "lidar": lidar.astype(np.float32),
        "lidar_feats": feats.astype(np.float32),
        "raw_point_xyz": raw.astype(np.float32),
        "init_intrinsic": intrinsic(config),
        "decalib_real_gt": quat_wxyz(gt[:3, :3]),
        "decalib_dual_gt": gt[:3, 3].astype(np.float32),
    }


def make_batch(seed: int, index: int, config: dict, traffic: dict) -> Dict[str, np.ndarray]:
    """Batch ``index`` of the seed's traffic: the loader's keys, stacked."""
    rng = rng_for(seed, 1, index)
    pairs = [make_pair(rng, config, traffic) for _ in range(traffic["batch"])]
    return {k: np.stack([p[k] for p in pairs]) for k in pairs[0]}


def make_pool(seed: int, config: dict, traffic: dict) -> List[Dict[str, np.ndarray]]:
    """The ``pool`` distinct batches a run cycles through."""
    return [make_batch(seed, i, config, traffic) for i in range(traffic["pool"])]


def calibration_batch(seed: int, config: dict, traffic: dict) -> Dict[str, np.ndarray]:
    """A batch outside the pool, from which the weights' running statistics
    are set."""
    return make_batch(seed, -1 % (1 << 32), config, traffic)


def model_keys(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The train step's names for the loader's keys."""
    return {MODEL_RENAMES.get(k, k): v for k, v in batch.items()}
