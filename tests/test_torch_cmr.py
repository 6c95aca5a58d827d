"""The KITTI odometry small-range protocol (the CMR protocol) of the port on
the CPU, against the JAX package's on the same on-disk tree (h5 local maps,
376x1241 ``.npy`` frames; tests/test_data.py's ``cmr_root``).

- ``KittiOdometryCMRDataset``: every key of every sample equal to JAX's
  (``assert_array_equal``) in training (point jitter, random
  decalibrations, sampling with repetition) and at test (the generated
  table; a ``test_rt`` table keyed by frame id on a tree whose frames are
  not contiguous), at ``--tiny``'s 64x128 and at the loader's 384x1280,
  where the 326 cropped rows are upscaled to 384 (``resize_image`` equals
  cv2 there, rows 0 and 383 included); both raise on a table too short.
- The tiny free model's forward on a CMR batch against JAX's, within 2e-4
  (tests/test_torch_model.py's f32 bar).
- ``train_torch.py`` with its defaults (``kd_cmr_snr``, ``i2pnet``).
- ``evaluate_torch.py --dataset kd_cmr_snr --test_rt <pkl>`` against
  ``evaluate.py`` with the same flags on a JAX checkpoint converted by
  ``tools/jax_ckpt_to_torch.py``: the same pairs (init and gt rows of
  prediction.txt equal), out3 within 2e-4 (tests/test_torch_evaluate_cli.py's
  bar), and the metrics npz within what that bar allows.
- ``aggregate_seeds`` over the port's per-seed prediction files, and
  ``scripts/cmr_test_torch.sh``'s shell and table path.
"""

import functools
import importlib.util
import os
import pickle
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

import evaluate
import evaluate_torch
import train_torch
from i2pnet_tpu import metrics as JM
from i2pnet_tpu.config import I2PNetConfig as JaxConfig
from i2pnet_tpu.data.kitti_odometry_cmr import KittiOdometryCMRDataset as JaxCMR
from i2pnet_tpu.data.pipeline import collate as jax_collate
from i2pnet_tpu.eval.analysis import aggregate_seeds as jax_aggregate_seeds
from i2pnet_tpu.models import I2PNet as JaxI2PNet
from i2pnet_tpu.train import create_train_state
from i2pnet_tpu.train.checkpoint import CheckpointManager as JaxManager
from i2pnet_tpu_torch import metrics as M
from i2pnet_tpu_torch.config import I2PNetConfig
from i2pnet_tpu_torch.data import KittiOdometryCMRDataset, collate
from i2pnet_tpu_torch.data import transforms as T
from i2pnet_tpu_torch.data.preprocess import cmr_test_rt_path, generate_test_rt
from i2pnet_tpu_torch.eval import analysis
from i2pnet_tpu_torch.models import I2PNet
from i2pnet_tpu_torch.ops import fps_cuda
from _torch_util import n, port, randomize_stats, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALIB_TXT = """P0: 700.0 0.0 600.0 0.0 0.0 700.0 180.0 0.0 0.0 0.0 1.0 0.0
P2: 700.0 0.0 600.0 44.8 0.0 700.0 180.0 0.2 0.0 0.0 1.0 0.003
Tr: 0.0 -1.0 0.0 0.01 0.0 0.0 -1.0 -0.05 1.0 0.0 0.0 -0.3
"""
TINY = dict(img_H=64, img_W=128, sample_point=512)


def write_cmr_tree(root, frames=None, points=500, seed=0):
    """The CMR loader's layout (tests/test_data.py's ``cmr_root``):
    ``frames`` {sequence: frame ids}, sequences 0 and 3 with frames 0-2
    unless given; h5 maps of ``points`` points 20 m around, 376x1241 uint8
    frames as ``.npy``."""
    rng = np.random.default_rng(seed)
    for seq, ids in (frames or {0: range(3), 3: range(3)}).items():
        seq_dir = os.path.join(root, "kitti_processed_CMRNet", "sequences", "%02d" % seq)
        os.makedirs(os.path.join(seq_dir, "local_maps"))
        os.makedirs(os.path.join(seq_dir, "image_2_npy"))
        with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
            f.write(CALIB_TXT)
        for fi in ids:
            pc = rng.uniform(-20, 20, size=(3, points)).astype(np.float32)
            inten = rng.uniform(0, 1, size=(1, points)).astype(np.float32)
            with h5py.File(os.path.join(seq_dir, "local_maps", "%06d.h5" % fi), "w") as hf:
                hf["PC"] = np.vstack([pc, np.ones((1, points), np.float32)])
                hf["intensity"] = inten
            img = rng.integers(0, 255, size=(376, 1241, 3), dtype=np.uint8)
            np.save(os.path.join(seq_dir, "image_2_npy", "%06d.npy" % fi), img)
    return root


@pytest.fixture(scope="module")
def cmr_root(tmp_path_factory):
    return write_cmr_tree(str(tmp_path_factory.mktemp("kitti_cmr")))


@pytest.fixture(scope="module")
def gappy_root(tmp_path_factory):
    """Sequence 00 with frames 1, 4 and 6 only: the frame id and the
    dataset index differ."""
    return write_cmr_tree(str(tmp_path_factory.mktemp("kitti_cmr_gaps")), {0: (1, 4, 6)}, seed=2)


def assert_samples_equal(a, b):
    assert set(a) == set(b)
    for key, value in b.items():
        if isinstance(value, np.ndarray):
            assert a[key].dtype == value.dtype, key
            np.testing.assert_array_equal(a[key], value, err_msg=key)
        else:
            assert a[key] == value, key


def _both(root, **kw):
    return KittiOdometryCMRDataset(root, **kw), JaxCMR(root, **kw)


@pytest.mark.parametrize("mode,size", [("train", "tiny"), ("train", "default"),
                                       ("test", "tiny"), ("test", "default")])
def test_cmr_dataset_matches_jax(cmr_root, mode, size):
    """Two passes over the split, the second continuing both generators."""
    ours, ref = _both(cmr_root, mode=mode, seed=3, color_augment=mode == "train",
                      **(TINY if size == "tiny" else {}))
    assert len(ours) == len(ref) == 3
    if mode == "test":
        np.testing.assert_array_equal(ours.test_RT, ref.test_RT)
    for i in list(range(len(ref))) * 2:
        assert_samples_equal(ours[i], ref[i])
    want = (64, 128) if size == "tiny" else (384, 1280)
    assert ours[0]["rgb"].shape == (*want, 3)
    assert ours[0]["lidar"].shape == (512 if size == "tiny" else 8192, 3)


def test_cmr_test_table_is_keyed_by_frame_id(gappy_root):
    """A table row per frame id (here 7 rows for frames 1, 4 and 6): sample
    i takes the row of its frame, not row i."""
    table = generate_test_rt(7, seed=5)
    ours, ref = _both(gappy_root, mode="test", test_rt=table, **TINY)
    for i, fi in enumerate((1, 4, 6)):
        a = ours[i]
        assert_samples_equal(a, ref[i])
        assert a["path_info"] == "00 %06d %06d" % (fi, fi)
        # the decalibrated cloud is the camera-frame one moved by row fi's inverse
        inv = np.linalg.inv(T.generate_transformation(*table[fi]))
        np.testing.assert_allclose(a["pc_cam"] @ inv[:3, :3].T + inv[:3, 3], a["lidar"],
                                   atol=1e-3)


def test_cmr_too_short_table_raises(gappy_root):
    for cls in (KittiOdometryCMRDataset, JaxCMR):
        with pytest.raises(AssertionError, match="too short"):
            cls(gappy_root, mode="test", test_rt=np.zeros((6, 6)))
        cls(gappy_root, mode="test", test_rt=np.zeros((7, 6)))


def test_tiny_model_on_a_cmr_batch_matches_jax(cmr_root):
    """The tiny free model's f32 eval forward on a collated CMR test batch
    (the loader's keys: rgb, lidar, init_intrinsic, lidar_feats,
    raw_point_xyz) within 2e-4 of JAX's, every kernel wrapper on its plain
    version."""
    cfg = JaxConfig.tiny()
    ds = KittiOdometryCMRDataset(cmr_root, mode="test", **TINY)
    batch = collate([ds[0], ds[1]])
    jds = JaxCMR(cmr_root, mode="test", **TINY)
    jbatch = jax_collate([jds[0], jds[1]])
    names = ("rgb", "lidar", "init_intrinsic", "lidar_feats", "raw_point_xyz")
    for key in names:
        np.testing.assert_array_equal(np.asarray(batch[key]), np.asarray(jbatch[key]))
    args = [np.asarray(jbatch[k]) for k in names[:3]]
    kw = dict(lidar_feature=np.asarray(jbatch["lidar_feats"]),
              raw_xyz=np.asarray(jbatch["raw_point_xyz"]))
    jm = JaxI2PNet(cfg)
    v = randomize_stats(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.key(0), *args), np.random.default_rng(1))
    ref = jax.jit(functools.partial(jm.apply, train=False))(v, *args, **kw)
    model = port(I2PNet(I2PNetConfig.tiny(), device="cpu"), v)
    launches = fps_cuda.launches
    with torch.no_grad():
        out = model(*map(t, args), **{k: t(a) for k, a in kw.items()})
    assert fps_cuda.launches == launches
    for key in ("out3", "out4"):
        assert float(np.abs(n(out[key]) - n(ref[key])).max()) <= 2e-4, key


def test_train_torch_runs_with_its_defaults(cmr_root, tmp_path):
    """--dataset kd_cmr_snr --network i2pnet by default: the CMR training
    sequences (03 here), no validation split."""
    log = str(tmp_path / "log")
    trainer = train_torch.main(["--tiny", "--device", "cpu", "--max_epoch", "1", "--root_path",
                                cmr_root, "--log_dir", log, "--batch_size", "2"])
    args = train_torch.parse_args([])
    assert (args.dataset, args.network) == ("kd_cmr_snr", "i2pnet")
    train_ds = trainer.train_loader.dataset
    assert isinstance(train_ds, KittiOdometryCMRDataset) and trainer.valid_loader is None
    assert len(train_ds) == 3 and train_ds.sample_point == I2PNetConfig.tiny().lidar_in_points
    assert trainer.state.step >= 1 and trainer.ckpt.all_steps() == [0]
    with open(os.path.join(log, "log.txt")) as f:
        assert f.readline().split()[:4] == ["epoch", "0", "iter", "1"]


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(ROOT, "tools", "jax_ckpt_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _record(monkeypatch, module, log):
    real = module.get_extrinsic

    def recording(out3, *a, **k):
        log.append(np.array(out3))
        return real(out3, *a, **k)

    monkeypatch.setattr(module, "get_extrinsic", recording)


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    """A tiny free model's JAX checkpoint (epoch 3, a rotation-best
    snapshot), converted for the port; the jitted init for evaluate.py."""
    model = JaxI2PNet(JaxConfig.tiny())
    rng = np.random.default_rng(0)
    shapes = [(1, 64, 128, 3), (1, 512, 3)]
    args = [rng.normal(size=s).astype(np.float32) for s in shapes]
    args.append(np.array([[[64.0, 0, 64], [0, 64.0, 32], [0, 0, 1]]], np.float32))
    init = jax.jit(functools.partial(model.init, train=False))
    log_dir = str(tmp_path_factory.mktemp("stage"))
    v = randomize_stats(init(jax.random.key(0), *args), np.random.default_rng(2))
    mgr = JaxManager(log_dir)
    mgr.save(3, create_train_state(model, v), meta={"epoch": 3})
    mgr.wait()
    mgr.save_best("model_rotation_best", {"params": v["params"],
                                          "batch_stats": v.get("batch_stats", {})})
    mgr.close()
    assert _converter().convert(log_dir) == {"steps": [3], "best": ["model_rotation_best"]}
    return log_dir, init


def test_evaluate_torch_cmr_with_test_rt_matches_evaluate_py(cmr_root, stage, tmp_path,
                                                             monkeypatch):
    log_dir, init = stage
    rt_dir = str(tmp_path / "rt")
    os.makedirs(rt_dir)
    rt = cmr_test_rt_path(rt_dir, "00", 10.0, 2.0, 1)
    with open(rt, "wb") as f:
        pickle.dump(generate_test_rt(3, seed=11).tolist(), f)
    common = ["--dataset", "kd_cmr_snr", "--network", "i2pnet", "--tiny", "--root_path",
              cmr_root, "--model_dir", log_dir, "--batch_size", "2", "--test_rt", rt,
              "--seed", "1", "--tag", "_seed1"]
    monkeypatch.setenv("I2PNET_KNN_MODE", "exact")  # evaluate.py sets it; restored after
    monkeypatch.setattr(JaxI2PNet, "init", lambda self, key, *a, train, **k: init(key, *a))
    jlog, plog = [], []
    _record(monkeypatch, JM, jlog)
    _record(monkeypatch, M, plog)
    jdir, pdir = str(tmp_path / "jax_eval"), str(tmp_path / "port_eval")
    evaluate.main(common + ["--log_dir", jdir])
    summary = evaluate_torch.main(common + ["--log_dir", pdir, "--device", "cpu"])

    assert summary["count"] == 3 and np.isfinite(summary["rre_mean"])
    assert [a.shape for a in plog] == [a.shape for a in jlog] == [(2, 7), (1, 7)]
    assert float(np.abs(np.concatenate(plog) - np.concatenate(jlog)).max()) <= 2e-4
    ours = analysis.parse_prediction_file(os.path.join(pdir, "prediction_seed1.txt"))
    ref = analysis.parse_prediction_file(os.path.join(jdir, "prediction_seed1.txt"))
    assert ours["pred"].shape == ref["pred"].shape == (3, 3, 4)
    np.testing.assert_array_equal(ours["init"], ref["init"])
    np.testing.assert_array_equal(ours["gt"], ref["gt"])
    # out3 within 2e-4 moves a rotation by at most 4 * 2e-4 rad (0.05 deg)
    # and a translation by 2e-4 m plus that rotation on a 20 m point
    (pnpz,), (jnpz,) = ([os.path.join(d, f) for f in os.listdir(d) if f.endswith(".npz")]
                        for d in (pdir, jdir))
    with np.load(pnpz) as a, np.load(jnpz) as b:
        assert set(a.files) == set(b.files) == {"RRE", "RTE"}
        assert a["RRE"].shape == b["RRE"].shape == (3,)
        np.testing.assert_allclose(a["RRE"], b["RRE"], rtol=0, atol=0.05)
        np.testing.assert_allclose(a["RTE"], b["RTE"], rtol=0, atol=0.02)


def test_aggregate_seeds_over_the_ports_files(cmr_root, stage, tmp_path):
    """Two seeds of the 10-seed protocol through evaluate_torch.py (each its
    generated table); the port's aggregate equals JAX's on the same files."""
    log_dir, _ = stage
    out = str(tmp_path / "seeds")
    for seed in (0, 1):
        evaluate_torch.main(["--dataset", "kd_cmr_snr", "--network", "i2pnet", "--tiny",
                             "--root_path", cmr_root, "--model_dir", log_dir, "--device", "cpu",
                             "--batch_size", "2", "--log_dir", out, "--seed", str(seed),
                             "--tag", f"_seed{seed}"])
    pattern = os.path.join(out, "prediction_seed*.txt")
    agg = analysis.aggregate_seeds(pattern)
    assert agg == jax_aggregate_seeds(pattern) and agg["seeds"] == 2
    inits = [analysis.parse_prediction_file(os.path.join(out, f"prediction_seed{s}.txt"))["init"]
             for s in (0, 1)]
    assert not np.array_equal(*inits)  # each seed its own decalibrations


def test_cmr_test_torch_script(tmp_path):
    """The shell parses; its per-seed table path is cmr_test_rt_path's, and
    its python uses the port only."""
    script = os.path.join(ROOT, "scripts", "cmr_test_torch.sh")
    subprocess.run(["bash", "-n", script], check=True, timeout=60)
    text = open(script).read()
    assert "i2pnet_tpu." not in text and "evaluate_torch.py" in text
    assert "--device" in text and "aggregate_seeds" in text
    env = dict(os.environ, PYTHONPATH=ROOT)
    got = subprocess.run(
        [sys.executable, "-c", "from i2pnet_tpu_torch.data.preprocess import cmr_test_rt_path; "
         f"print(cmr_test_rt_path('{tmp_path}', '00', 10.0, 2.0, 5))"],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True, timeout=120).stdout
    assert got.strip() == str(tmp_path / "test_RT_seq00_10.00_2.00_500.pkl")
