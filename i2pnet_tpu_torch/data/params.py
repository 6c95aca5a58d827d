"""Dataset parameters of the protocols: the port's own copy of
``i2pnet_tpu/data/params.py`` (``KITTI_ONLINE_CALIB`` and the raw-drive
lists, ``KITTI_ODOMETRY``, ``NUSCENES`` and ``REAL_DATA``;
``tests/test_torch_kitti_raw.py`` holds the two equal). Paths default to
the reference's layout; the CLIs replace them by ``--root_path``."""

from __future__ import annotations

RAW_TRAIN_DRIVES_2011_09_26 = (
    1, 2, 9, 11, 13, 14, 15, 17, 18, 19, 20, 22, 23, 27, 28, 29, 32, 35, 36,
    39, 46, 48, 51, 52, 56, 57, 59, 60, 61, 64, 79, 84, 86, 87, 91, 93, 95,
    96, 101, 104, 106, 113, 117,
)
RAW_VALID_DRIVES_2011_09_26 = (5, 70)
RAW_TEST_DRIVES_2011_09_30 = (28,)


def _split(date, drives, d_rot, d_trans, fixed_decalib):
    return dict(base_path="/dataset/kitti/raw/", date=date, drives=drives, d_rot=d_rot,
                d_trans=d_trans, fixed_decalib=fixed_decalib, resize_w=1216, resize_h=352)


# training draws a decalibration per sample (+-10 deg, +-1 m); the
# validation and test splits fix it at the amplitude
KITTI_ONLINE_CALIB = {
    "train": _split("2011_09_26", RAW_TRAIN_DRIVES_2011_09_26, 10, 1.0, False),
    "valid1": _split("2011_09_26", RAW_VALID_DRIVES_2011_09_26, 10, 1.0, True),
    "valid2": _split("2011_09_26", RAW_VALID_DRIVES_2011_09_26, 2, 0.2, True),
    "valid3": _split("2011_09_26", RAW_VALID_DRIVES_2011_09_26, 5, 0.5, True),
    "test": _split("2011_09_30", RAW_TEST_DRIVES_2011_09_30, 10, 1.0, True),
}

# the KITTI odometry small-range protocol (CMRNet's): +-10 deg, +-2 m
KITTI_ODOMETRY = {
    "train": dict(root_path="/dataset", mode="train", max_r=10.0, max_t=2.0),
    "valid": dict(root_path="/dataset", mode="test", max_r=10.0, max_t=2.0),
    "test": dict(root_path="/dataset", mode="val", max_r=10.0, max_t=2.0),
}

NUSCENES = {
    "train": dict(root_path="/dataset/nuScenes", mode="train"),
    "valid": dict(root_path="/dataset/nuScenes", mode="val"),
    "test": dict(root_path="/dataset/nuScenes", mode="test"),
}


def _real(mode, d_rot, d_trans):
    return dict(root_path="/dataset/real_localize", mode=mode, d_rot=d_rot, d_trans=d_trans,
                fixed_decalib=False, resize_w=1216, resize_h=352)


# the real-rig localisation protocol; its test split draws no decalibration
REAL_DATA = {
    "train": _real("train", 10, 1.0),
    "valid3": _real("test", 10, 1.0),
    "test": _real("val", -1, -1),
}
