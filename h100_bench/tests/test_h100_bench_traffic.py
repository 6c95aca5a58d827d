"""The traffic generator: deterministic by seed, different across seeds,
decalibrations within the protocols' amplitudes, and the large-range
sweeps filling the 64x1800 range image as a sweep fills it."""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from h100_bench import gen, harness
from h100_bench.reference import nets

SEED = 2**31 + 12345


def _load(kind, name):
    with open(os.path.join(harness.BENCH, kind, f"{name}.json")) as f:
        return json.load(f)


FREE = _load("configs", "i2pnet-free-kitti-cmr")
PROJ = _load("configs", "i2pnet-proj-kitti-lr")


def _small(traffic, batch=2):
    return dict(_load("traffic", traffic), batch=batch)


@pytest.mark.parametrize("config,traffic", [(FREE, "cmr-eval"), (PROJ, "lr-train")])
def test_batches_repeat_by_seed_and_differ_across_seeds(config, traffic):
    t = _small(traffic)
    a, b = gen.make_batch(SEED, 3, config, t), gen.make_batch(SEED, 3, config, t)
    c, d = gen.make_batch(SEED + 1, 3, config, t), gen.make_batch(SEED, 4, config, t)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    for other in (c, d):
        assert not np.array_equal(a["lidar"], other["lidar"])
        assert not np.array_equal(a["rgb"], other["rgb"])
    assert a["rgb"].shape == (2, *config["image_hw"], 3) and a["rgb"].dtype == np.float32
    assert 0 <= a["rgb"].min() and a["rgb"].max() <= 255
    assert a["lidar"].shape == (2, config["points"], 3)


def test_euler_and_quaternion_follow_scipy():
    rng = np.random.default_rng(0)
    for _ in range(20):
        rx, ry, rz = rng.uniform(-3, 3, 3)
        R = gen.euler_xzy(rx, ry, rz)
        assert np.allclose(R, Rotation.from_euler("xzy", [rx, rz, ry]).as_matrix(), atol=1e-12)
        q = gen.quat_wxyz(R)
        x, y, z, w = Rotation.from_matrix(R).as_quat()
        want = np.array([w, x, y, z]) * (1 if w >= 0 else -1)
        assert np.allclose(q, want, atol=1e-6)


@pytest.mark.parametrize("traffic", ["cmr-eval", "cmr-train"])
def test_cmr_decalibrations_within_10_deg_and_2_m(traffic):
    t = _small(traffic, batch=64)
    b = gen.make_batch(SEED, 0, FREE, t)
    q = b["decalib_real_gt"]
    angles = Rotation.from_quat(q[:, [1, 2, 3, 0]]).as_euler("xzy")  # [rx, rz, ry]
    assert np.abs(angles).max() <= math.radians(10) + 1e-5
    tr = b["decalib_dual_gt"]
    assert np.abs(tr).max() <= 2 + 1e-5
    if traffic == "cmr-train":
        assert tr[:, 2].max() <= 1 + 1e-6  # the CMR train sampler caps tz at 1 m
    # the cloud is the camera-frame scan moved by Pr^-1: Pr takes it back
    R = Rotation.from_quat(q[:, [1, 2, 3, 0]]).as_matrix()
    cam = np.einsum("bij,bnj->bni", R, b["lidar"]) + tr[:, None]
    assert cam[..., 2].min() > 2 - 1e-3
    assert np.allclose(cam, b["raw_point_xyz"] @ gen.VELO_TO_CAM.T, atol=1e-3)


def test_large_range_decalibrations_yaw_and_10_m():
    t = _small("lr-eval", batch=64)
    b = gen.make_batch(SEED, 0, PROJ, t)
    R_inv = Rotation.from_quat(b["decalib_real_gt"][:, [1, 2, 3, 0]]).as_matrix()
    Pr_R = np.transpose(R_inv, (0, 2, 1))
    Pr_t = -np.einsum("bij,bj->bi", Pr_R, b["decalib_dual_gt"])
    angles = Rotation.from_matrix(Pr_R).as_euler("xzy")
    assert np.abs(angles[:, :2]).max() < 1e-4  # rx and rz are 0: a yaw alone
    assert np.abs(Pr_t[:, [0, 2]]).max() <= 10 + 1e-4
    assert np.abs(Pr_t[:, 1]).max() < 1e-4
    yaws = np.degrees(angles[:, 2])
    assert yaws.min() < -90 and yaws.max() > 90  # the full circle is drawn


def test_sweeps_fill_the_range_image_as_a_sweep_does():
    # 64 beams spread evenly over fdown..fup (-24.8..2.0 deg) land on rows
    # H - floor((k + 0.5) * 63 / 64) clamped to 63: rows 2..63 (beams 0 and
    # 1 share row 63), rows 0 and 1 stay empty; 1875 firings a beam at
    # 360/1875 = 0.192 deg, finer than a 0.2 deg column, hit every column:
    # 62 x 1800 = 111600 of 115200 cells, 96.875%
    t = _small("lr-eval")
    b = gen.make_batch(SEED, 0, PROJ, t)
    mc = PROJ["model"]
    raw = torch.from_numpy(b["raw_point_xyz"])
    assert int((raw.abs().sum(-1) > 0).sum(1).min()) == PROJ["real_points"]
    grid, _ = nets.family("proj").spherical_project(raw, [], mc["init_H"], mc["init_W"],
                                                    mc["fup"], mc["fdown"])
    occupied = (grid.abs().sum(-1) > 0)
    assert occupied.sum((1, 2)).tolist() == [62 * 1800] * 2
    assert occupied[:, :2].sum() == 0 and bool(occupied[:, 2:].all())
