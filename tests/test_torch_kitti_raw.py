"""The online-calibration data path of the port on the CPU: its copy of
the protocol's parameters, ``KittiRawCalibDataset`` against the JAX
package's sample for sample, and ``train_torch.py --dataset kitti --efgh``
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
import sys
import types

import numpy as np
import pytest
from PIL import Image

import evaluate_torch
import train_torch
from i2pnet_tpu.data import params as jparams
from i2pnet_tpu.data.kitti_raw_calib import KittiRawCalibDataset as JaxKittiRawCalibDataset
from i2pnet_tpu_torch.data import KittiRawCalibDataset, params
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
