"""The online-calibration data path of the port on the CPU: its copy of
the protocols' parameters, ``KittiRawCalibDataset`` against the JAX
package's sample for sample, the RGGNet protocol's splits
(``generate_rgg_splits``: the same pickles) and ``KittiRGGDataset`` (the
same samples in every mode), and ``train_torch.py --dataset kitti --efgh``
then ``evaluate_torch.py --dataset kitti --efgh`` on a synthetic raw tree
(the CPU rehearsal of tests/test_cli_smoke.py's efgh run).

The loaders read PNGs with ``cv2``, imported when a sample is read; here
both packages get a stand-in module (``sys.modules``): ``imread`` reads
the PNG with PIL and returns its channels reversed, as OpenCV's BGR, and
``resize`` is the port's ``resize_image`` (bit-exact to OpenCV's
INTER_LINEAR on these shapes, tests/test_torch_data.py), so both packages
see identical arrays.
"""

import json
import os
import pickle
import sys
import types

import numpy as np
import pytest
from PIL import Image

import evaluate_torch
import train_torch
from i2pnet_tpu.data import params as jparams
from i2pnet_tpu.data.kitti_raw_calib import KittiRawCalibDataset as JaxKittiRawCalibDataset
from i2pnet_tpu.data.kitti_raw_calib import KittiRGGDataset as JaxKittiRGGDataset
from i2pnet_tpu.data.preprocess import RGG_SPLITS as JAX_RGG_SPLITS
from i2pnet_tpu.data.preprocess import generate_rgg_splits as jax_generate_rgg_splits
from i2pnet_tpu_torch.data import KittiRawCalibDataset, KittiRGGDataset, params
from i2pnet_tpu_torch.data.preprocess import RGG_SPLITS, generate_rgg_splits
from i2pnet_tpu_torch.data import transforms as T
from i2pnet_tpu_torch.eval import analysis

DRIVES = (("2011_09_26", 1), ("2011_09_30", 28))  # a training drive, the test drive
FRAMES = 2


def _imread(path):
    return np.asarray(Image.open(path).convert("RGB"))[:, :, ::-1].copy()


def _resize(img, size, interpolation=None):
    return T.resize_image(img, *size)


CV2 = types.SimpleNamespace(imread=_imread, resize=_resize, INTER_LINEAR=1)


@pytest.fixture
def cv2_stand_in(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", CV2)


@pytest.fixture(scope="module")
def raw_root(tmp_path_factory):
    """Two frames of each drive: (375, 1242, 3) PNGs and 9000-point scans
    2-50 m out (the layout of the KITTI raw drives)."""
    root = tmp_path_factory.mktemp("kitti_raw")
    rng = np.random.default_rng(4)
    for date, drive in DRIVES:
        drive_dir = root / date / f"{date}_drive_{drive:04d}_sync"
        (drive_dir / "image_02" / "data").mkdir(parents=True)
        (drive_dir / "velodyne_points" / "data").mkdir(parents=True)
        for i in range(FRAMES):
            img = rng.integers(0, 255, size=(375, 1242, 3), dtype=np.uint8)
            Image.fromarray(img).save(drive_dir / "image_02" / "data" / f"{i:010d}.png")
            pts = rng.uniform(2, 50, size=(9000, 4)).astype(np.float32)
            pts.tofile(drive_dir / "velodyne_points" / "data" / f"{i:010d}.bin")
    return str(root)


def test_params_match_jax():
    assert params.KITTI_ONLINE_CALIB == jparams.KITTI_ONLINE_CALIB
    for name in ("KITTI_ODOMETRY", "NUSCENES", "REAL_DATA"):
        assert getattr(params, name) == getattr(jparams, name), name
    assert RGG_SPLITS == JAX_RGG_SPLITS
    for name in ("RAW_TRAIN_DRIVES_2011_09_26", "RAW_VALID_DRIVES_2011_09_26",
                 "RAW_TEST_DRIVES_2011_09_30"):
        assert getattr(params, name) == getattr(jparams, name)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("emit_calib", [False, True])
def test_kitti_raw_dataset_matches_jax(raw_root, cv2_stand_in, split, emit_calib):
    """Every key of every sample equal (random decalibrations on 'train',
    fixed ones on 'test'; the points' permutation from the same seed), two
    passes, the second continuing both generators; the tiny and the
    protocol's image sizes."""
    pp = dict(params.KITTI_ONLINE_CALIB[split])
    pp.pop("base_path")
    for size, points in (((1216, 352), 8192), ((128, 64), 512)):
        pp.update(resize_w=size[0], resize_h=size[1])
        ours = KittiRawCalibDataset(raw_root, **pp, sample_point=points, seed=3,
                                    emit_calib=emit_calib)
        ref = JaxKittiRawCalibDataset(raw_root, **pp, sample_point=points, seed=3,
                                      emit_calib=emit_calib)
        assert len(ours) == len(ref) == FRAMES
        for i in list(range(FRAMES)) * 2:
            a, b = ours[i], ref[i]
            assert set(a) == set(b) and ("calib" in a) == emit_calib
            for key, value in b.items():
                if isinstance(value, np.ndarray):
                    assert a[key].dtype == value.dtype, key
                    np.testing.assert_array_equal(a[key], value, err_msg=key)
                else:
                    assert a[key] == value, key
        assert a["rgb"].shape == (size[1], size[0], 3) and a["lidar"].shape == (points, 3)


def test_efgh_train_then_evaluate_through_the_clis(raw_root, cv2_stand_in, tmp_path):
    """train_torch.py --dataset kitti --efgh --tiny --accum_steps 2 for one
    epoch, then evaluate_torch.py --dataset kitti --efgh on the run: the
    files train.py and evaluate.py write (config.json recording efgh, the
    epoch checkpoint, prediction.txt with a section a test pair, the
    metrics npz, log_test.txt)."""
    log = str(tmp_path / "log")
    common = ["--dataset", "kitti", "--network", "i2pnet", "--efgh", "--tiny", "--device", "cpu",
              "--root_path", raw_root]
    trainer = train_torch.main(common + ["--log_dir", log, "--max_epoch", "1", "--batch_size",
                                         "2", "--save_rate", "1", "--accum_steps", "2"])
    assert trainer.cfg.efgh and trainer.state.step == 1 and trainer.valid_loader is None
    with open(os.path.join(log, "config.json")) as f:
        cfg = json.load(f)
    assert str(cfg["config"]["efgh"]).lower() == "true" and cfg["accum_steps"] == 2
    assert {"config.json", "metrics.jsonl", "log.txt"} <= set(os.listdir(log))
    assert trainer.ckpt.all_steps() == [0]

    info = str(tmp_path / "info_test")
    with pytest.warns(UserWarning, match="best snapshot"):  # no validation split: latest
        summary = evaluate_torch.main(common + ["--model_dir", log, "--log_dir", info,
                                                "--batch_size", "1"])
    assert summary["count"] == FRAMES and np.isfinite(summary["rre_mean"])
    mats = analysis.parse_prediction_file(os.path.join(info, "prediction.txt"))
    assert mats["pred"].shape == (FRAMES, 3, 4)
    names = os.listdir(info)
    assert "log_test.txt" in names and any(f.endswith(".npz") for f in names)


def test_efgh_needs_the_kitti_dataset(tmp_path):
    """As train.py: --efgh with another dataset or the proj network exits."""
    for extra in (["--dataset", "kd_corr_nolidar"], ["--network", "i2pnet_proj"]):
        with pytest.raises(SystemExit, match="--efgh needs"):
            train_torch.main(["--efgh", "--device", "cpu", "--log_dir", str(tmp_path)]
                             + (["--dataset", "kitti"] if "--network" in extra else []) + extra)


@pytest.fixture(scope="module")
def rgg_root(raw_root, tmp_path_factory):
    """The RGG protocol's inputs: raw_root (drive 1 of 2011_09_26, one of
    T2a's drives) and a 2011_10_03 drive 27 with the date's own calib files
    (train_val_ex, the split with a train_split)."""
    root = tmp_path_factory.mktemp("rgg_raw")
    date_dir = root / "2011_10_03"
    drive_dir = date_dir / "2011_10_03_drive_0027_sync"
    (drive_dir / "image_02" / "data").mkdir(parents=True)
    (drive_dir / "velodyne_points" / "data").mkdir(parents=True)
    rng = np.random.default_rng(7)
    for i in range(FRAMES):
        img = rng.integers(0, 255, size=(376, 1241, 3), dtype=np.uint8)
        Image.fromarray(img).save(drive_dir / "image_02" / "data" / f"{i:010d}.png")
        rng.uniform(2, 50, size=(5000, 4)).astype(np.float32).tofile(
            drive_dir / "velodyne_points" / "data" / f"{i:010d}.bin")
    (date_dir / "calib_cam_to_cam.txt").write_text(
        "R_rect_00: 1 0 0 0 1 0 0 0 1\n"
        "P_rect_02: 700.0 0.0 600.0 40.0 0.0 700.0 180.0 1.0 0.0 0.0 1.0 0.005\n")
    (date_dir / "calib_velo_to_cam.txt").write_text("R: 0 -1 0 0 0 -1 1 0 0\nT: 0.05 -0.07 -0.27\n")
    out = {}
    for key, base in (("T2a", raw_root), ("train_val_ex", str(root))):
        paths = []
        for gen, sub in ((generate_rgg_splits, "port"), (jax_generate_rgg_splits, "jax")):
            (written,) = gen(base, str(root / sub), seed=3, splits=[key])
            paths.append(written)
        out[key] = paths
    return out


def test_generate_rgg_splits_matches_jax(rgg_root):
    """The same pickle from both: paths, tables and training indices."""
    for key, (ours, ref) in rgg_root.items():
        with open(ours, "rb") as f, open(ref, "rb") as g:
            a, b = pickle.load(f), pickle.load(g)
        assert set(a) == set(b) and ("train_split" in a) == (key == "train_val_ex")
        for name in b:
            np.testing.assert_array_equal(a[name], b[name], err_msg=f"{key} {name}")
        assert len(a["img"]) == RGG_SPLITS[key]["num"]


@pytest.mark.parametrize("key,mode", [("T2a", "test"), ("train_val_ex", "train"),
                                      ("train_val_ex", "val"), ("train_val_ex", "test")])
def test_rgg_dataset_matches_jax(rgg_root, cv2_stand_in, key, mode):
    """Every key of the first samples equal (each sample's fixed
    decalibration, the points' draws from the seed), the split's size,
    the calibration (the date's calib files for 2011_10_03, the built-in
    table for 2011_09_26); a test-only split refuses 'train' and 'val'."""
    path = rgg_root[key][0]
    ours = KittiRGGDataset(path, mode=mode, sample_point=1024, seed=2, resize_w=128,
                           resize_h=64, emit_calib=True)
    ref = JaxKittiRGGDataset(path, mode=mode, sample_point=1024, seed=2, resize_w=128,
                             resize_h=64, emit_calib=True)
    want = {"test": 2000, "train": 1800, "val": 200}[mode]
    assert len(ours) == len(ref) == want
    np.testing.assert_array_equal(ours.cam_intrinsic, ref.cam_intrinsic)
    np.testing.assert_array_equal(ours.velo_extrinsic, ref.velo_extrinsic)
    for i in (0, 1, want - 1, 0):
        a, b = ours[i], ref[i]
        assert set(a) == set(b)
        for name, value in b.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(a[name], value, err_msg=name)
            else:
                assert a[name] == value, name
    if key == "T2a":
        for cls in (KittiRGGDataset, JaxKittiRGGDataset):
            for bad in ("train", "val"):
                with pytest.raises(ValueError, match="test-only"):
                    cls(path, mode=bad)
