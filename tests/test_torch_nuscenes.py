"""The nuScenes protocols of the port on the CPU, against the JAX package's
on the same on-disk tree (tests/test_data.py's ``nus_root``: h5 maps of
400 points, 900x1600 JPEG frames, pickled split lists).

- ``NuScenesCMRDataset`` and ``NuScenesLargeRangeDataset``: every key of
  every sample equal to JAX's, in training and at test, two passes: the
  raw-frame axis swap, the zero padding (budgets above the map's 400
  points) and the sampling without replacement (below it).
- The projection model on ``I2PNetProjConfig.tiny()`` carrying
  ``nuscenes()``'s own fields (the range grid's rows halved as ``tiny()``
  halves the rest, its fup, fdown and row strides) against JAX's on a
  large-range batch: out3/out4 within 2e-4 (the f32 proj bar,
  tests/test_torch_proj_model.py).
- The kernels' gates at the new shapes, in both packages: the encoder
  stages of a 640x1280 image (the free model on the small-range loader)
  and of the nuScenes proj config's 160x512; cv1 at K = 20x40 = 800; every
  window select of the shipped ``nuscenes()`` config on its 32-row grid.
- ``cli.build_datasets`` against ``train.py``'s for both datasets,
  ``train_torch.py --batch_size 2`` on both, and ``evaluate_torch.py
  --dataset nus_cmr_snr --test_rt`` (a CSV with the reference's
  ``id,tx,ty,tz,rx,ry,rz`` header) and ``--dataset nus_corr_nolidar``.
"""

import argparse
import dataclasses
import functools
import os
import pickle

import h5py
import jax
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation

import evaluate_torch
import train
import train_torch
from i2pnet_tpu.config import I2PNetProjConfig as JaxProjConfig
from i2pnet_tpu.data.nuscenes import NuScenesCMRDataset as JaxNusCMR
from i2pnet_tpu.data.nuscenes import NuScenesLargeRangeDataset as JaxNusLarge
from i2pnet_tpu.data.pipeline import collate as jax_collate
from i2pnet_tpu.data.preprocess import load_test_rt as jax_load_test_rt
from i2pnet_tpu.models import I2PNetProj as JaxI2PNetProj
from i2pnet_tpu.ops import conv_pallas, conv_pallas_train, cv_pallas
from i2pnet_tpu_torch import cli
from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
from i2pnet_tpu_torch.data import NuScenesCMRDataset, NuScenesLargeRangeDataset, collate
from i2pnet_tpu_torch.eval import analysis
from i2pnet_tpu_torch.models import I2PNet, I2PNetProj
from i2pnet_tpu_torch.ops import conv_cuda, conv_train_cuda, cv_cuda, dense_window, select_cuda
from i2pnet_tpu_torch.train.checkpoint import CheckpointManager
from _torch_util import n, port, t

POINTS = 400


@pytest.fixture(scope="module")
def nus_root(tmp_path_factory):
    """tests/test_data.py's nuScenes tree, the list written as both the
    training and the test split (``train_dataset0.list``,
    ``test_dataset0.list``, the names the CLIs glob)."""
    root = tmp_path_factory.mktemp("nus")
    rng = np.random.default_rng(3)
    entries = []
    (root / "maps").mkdir()
    (root / "imgs").mkdir()
    K = np.array([[800.0, 0, 800], [0, 800.0, 450], [0, 0, 1]])
    velo2cam2 = np.eye(4)
    velo2cam2[:3, :3] = Rotation.from_euler("x", -np.pi / 2).as_matrix()
    velo2cam2[:3, 3] = [0.0, -0.3, 0.5]
    for i in range(3):
        with h5py.File(root / "maps" / f"{i}.h5", "w") as hf:
            hf["PC"] = rng.uniform(-20, 20, size=(3, POINTS)).astype(np.float32)
            hf["intensity"] = rng.uniform(0, 1, size=(1, POINTS)).astype(np.float32)
        Image.fromarray(rng.integers(0, 255, size=(900, 1600, 3), dtype=np.uint8)).save(
            root / "imgs" / f"{i}.jpg")
        entries.append(((f"maps/{i}.h5", f"imgs/{i}.jpg"), K, velo2cam2, None))
    for split in ("train", "test"):
        with open(root / f"{split}_dataset0.list", "wb") as f:
            pickle.dump(entries, f)
    return str(root)


def _splits(root, split="train"):
    return [os.path.join(root, f"{split}_dataset0.list")]


def assert_samples_equal(a, b):
    assert set(a) == set(b)
    for key, value in b.items():
        if isinstance(value, np.ndarray):
            assert a[key].dtype == value.dtype, key
            np.testing.assert_array_equal(a[key], value, err_msg=key)
        else:
            assert a[key] == value, key


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("kind,points", [("cmr", 512), ("cmr", 256), ("large", 1000)])
def test_nuscenes_datasets_match_jax(nus_root, kind, points, mode):
    ours_cls, ref_cls = ((NuScenesCMRDataset, JaxNusCMR) if kind == "cmr"
                         else (NuScenesLargeRangeDataset, JaxNusLarge))
    ours = ours_cls(nus_root, _splits(nus_root), mode=mode, sample_point=points, seed=4)
    ref = ref_cls(nus_root, _splits(nus_root), mode=mode, sample_point=points, seed=4)
    assert len(ours) == len(ref) == 3
    for i in [0, 1, 2] * 2:
        a = ours[i]
        assert_samples_equal(a, ref[i])
    assert a["rgb"].shape == ((640, 1280, 3) if kind == "cmr" else (160, 512, 3))
    assert a["lidar"].shape == (points, 3)
    if points > POINTS:  # zero-padded past the map's points
        assert not a["lidar"][POINTS:].any() and a["lidar"][:POINTS].any()
    if kind == "large":
        # the raw frame's axis swap: (x, y, z) -> (y, -x, z) of the map
        with h5py.File(os.path.join(nus_root, "maps", "2.h5"), "r") as hf:
            pc = np.asarray(hf["PC"], np.float32)
        got = {tuple(p) for p in a["raw_point_xyz"][:POINTS]}
        swap = np.stack([pc[1], -pc[0], pc[2]], 1)
        if mode == "test":  # no jitter at test: the swapped map, permuted
            assert got == {tuple(p) for p in swap}
        assert a["lidar_feats"].shape == (points, 1)


def test_nuscenes_cmr_test_rt_keyed_by_index(nus_root, tmp_path):
    """--test_rt's CSV (the reference's id,tx,ty,tz,rx,ry,rz header), read by
    the port's load_test_rt: sample i takes row i, as in JAX; a table
    shorter than the split raises in both."""
    from i2pnet_tpu_torch.data.preprocess import generate_test_rt, load_test_rt

    rt = generate_test_rt(3, seed=8)
    path = str(tmp_path / "rt.csv")
    with open(path, "w") as f:
        f.write("id,tx,ty,tz,rx,ry,rz\n")
        for i, row in enumerate(rt):
            f.write(",".join([str(i)] + [repr(float(v)) for v in (*row[3:], *row[:3])]) + "\n")
    table = load_test_rt(path)
    np.testing.assert_array_equal(table, jax_load_test_rt(path))
    ours = NuScenesCMRDataset(nus_root, _splits(nus_root, "test"), mode="test", test_rt=table)
    ref = JaxNusCMR(nus_root, _splits(nus_root, "test"), mode="test", test_rt=table)
    for i in range(3):
        assert_samples_equal(ours[i], ref[i])
    for cls in (NuScenesCMRDataset, JaxNusCMR):
        with pytest.raises(AssertionError, match="too short"):
            cls(nus_root, _splits(nus_root, "test"), mode="test", test_rt=table[:2])


NUS_TINY = dict(init_H=8, fup=10.0, fdown=-30.0, stride_Hs=(2, 2, 2, 1))


def test_tiny_nuscenes_proj_model_matches_jax(nus_root):
    """``nuscenes()``'s fields on the tiny config (init_H 32 -> 8, as
    tiny() takes 64 -> 16), f32, on a large-range batch of 2 from the
    port's loader (1000-point budget); the JAX model on JAX's batch."""
    jcfg = dataclasses.replace(JaxProjConfig.tiny(), **NUS_TINY)
    assert {k: getattr(JaxProjConfig.nuscenes(), k) for k in ("fup", "fdown", "stride_Hs")} == \
        {k: NUS_TINY[k] for k in ("fup", "fdown", "stride_Hs")}
    kw = dict(mode="test", sample_point=1000, seed=2)
    ds = NuScenesLargeRangeDataset(nus_root, _splits(nus_root, "test"), **kw)
    jds = JaxNusLarge(nus_root, _splits(nus_root, "test"), **kw)
    batch, jbatch = collate([ds[0], ds[1]]), jax_collate([jds[0], jds[1]])
    names = ("rgb", "lidar", "raw_point_xyz", "init_intrinsic", "lidar_feats")
    for key in names:
        np.testing.assert_array_equal(np.asarray(batch[key]), np.asarray(jbatch[key]))
    args = [np.asarray(jbatch[k]) for k in names[:4]]
    feats = np.asarray(jbatch["lidar_feats"])
    jm = JaxI2PNetProj(jcfg)
    v = jax.jit(functools.partial(jm.init, train=False))(jax.random.key(0), *args,
                                                          lidar_feature=feats)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    ref = jax.jit(functools.partial(jm.apply, train=False))(v, *args, lidar_feature=feats)
    cfg = dataclasses.replace(I2PNetProjConfig.tiny(), **NUS_TINY)
    assert cfg.lidar_Hs == jcfg.lidar_Hs == (4, 2, 1, 1)
    model = port(I2PNetProj(cfg, device="cpu"), v)
    counts = (select_cuda.launches, conv_cuda.launches)
    with torch.no_grad():
        out = model(*map(t, args), lidar_feature=t(feats))
    assert (select_cuda.launches, conv_cuda.launches) == counts
    for key in ("out3", "out4"):
        got = n(out[key])
        assert np.isfinite(got).all()
        assert float(np.abs(got - n(ref[key])).max()) <= 2e-4, key


def _stages(cfg, H, W):
    out = []
    for cin, channels, strides in cfg.rgb_encoder_channels:
        out.append((H, W, cin, channels, strides))
        for s in strides:
            H, W = (H - 1) // s + 1, (W - 1) // s + 1
    return out, (H, W)


def test_gates_admit_the_nuscenes_shapes():
    """Both packages' encoder gates (eval, and train with the input's
    gradient after the first stage) take every stage at 640x1280 (the free
    model, small-range) and at 160x512 (the nuScenes proj config); the
    free feature grid is 20x40, so cv1 runs at K = 800, and both packages'
    cv1 gates (shape-only: the MLP depths) hold."""
    for cfg, H, W in ((I2PNetConfig(), 640, 1280), (I2PNetProjConfig.nuscenes(), 160, 512)):
        stages, grid = _stages(cfg, H, W)
        for i, stage in enumerate(stages):
            assert conv_cuda.stage_supported(*stage), stage
            assert conv_train_cuda.stage_supported_train(*stage, input_grad=i > 0), stage
            assert conv_pallas.stage_supported(*stage), stage
            assert conv_pallas_train.stage_supported_train(*stage), stage
    assert _stages(I2PNetConfig(), 640, 1280)[1] == (20, 40)
    free = I2PNetConfig()
    mlp1, mlp2 = free.cost_volume_mlps
    assert cv_pallas.fused_cv1_eval_supported(mlp1, mlp2, free.rgb_encoder_channels[-1][1][-1])
    model = I2PNet(dataclasses.replace(free, compute_dtype="bfloat16"), device="cpu").eval()
    assert model.cost_volume1.fuses_cv1()


def test_select_fits_the_nuscenes_grid(monkeypatch):
    """The shipped nuScenes proj config's eval forward (f32, B=1, 6000
    points, 160x512) on the CPU: its five window selects, recorded, on
    the 32-row grid's levels (16x225, 8x113, 4x57, 4x29), each within the
    select kernel's limits (the window's slots, the query strides inside
    the grid) that its wrapper checks before a launch."""
    calls = []
    real = dense_window.window_multiplicity

    def recording(xyz, **kw):
        calls.append((tuple(xyz.shape), kw))
        return real(xyz, **kw)

    monkeypatch.setattr(dense_window, "window_multiplicity", recording)
    cfg = I2PNetProjConfig.nuscenes()
    assert (cfg.init_H, cfg.lidar_Hs, cfg.lidar_Ws) == (32, (16, 8, 4, 4), (225, 113, 57, 29))
    rng = np.random.default_rng(0)
    raw = np.zeros((1, 6000, 3), np.float32)
    raw[0, :5000] = rng.normal(size=(5000, 3)) * 15
    k = np.array([[[350.0, 0, 256], [0, 350.0, 80], [0, 0, 1]]], np.float32)
    model = I2PNetProj(cfg, device="cpu").eval()
    with torch.no_grad():
        out = model(torch.from_numpy(rng.normal(size=(1, 160, 512, 3)).astype(np.float32)),
                    t(raw), t(raw), t(k))
    assert np.isfinite(n(out["out3"])).all()
    assert len(calls) == 5
    for (B, h2, w2, _), kw in calls:
        (qh, qw), (kh, kw_) = kw["qstride"], kw["kernel_size"]
        assert h2 <= 32 and kh * kw_ <= select_cuda.MAX_SLOTS
        assert (kw["out_h"] - 1) * qh < h2 and (kw["out_w"] - 1) * qw < w2
    assert max(h2 for (_, h2, _, _), _ in calls) == 32


def _ns(args):
    return argparse.Namespace(**{k: v for k, v in vars(args).items() if k != "device"})


@pytest.mark.parametrize("dataset,network", [("nus_cmr_snr", "i2pnet"),
                                             ("nus_corr_nolidar", "i2pnet_proj")])
def test_build_datasets_matches_train_py(nus_root, dataset, network):
    """train.py's classes over train_dataset*.list, at full size under
    --tiny too; no validation split; the first sample equal."""
    args = train_torch.parse_args(["--dataset", dataset, "--network", network, "--tiny",
                                   "--root_path", nus_root])
    ours = cli.build_datasets(args, None)
    ref = train.build(_ns(args))[3:]
    assert ours[1] is None and ref[1] is None
    assert type(ours[0]).__name__ == type(ref[0]).__name__ and len(ours[0]) == len(ref[0]) == 3
    assert (ours[0].img_H, ours[0].sample_point) == (ref[0].img_H, ref[0].sample_point)
    assert_samples_equal(ours[0][0], ref[0][0])


@pytest.mark.parametrize("dataset,network", [("nus_cmr_snr", "i2pnet"),
                                             ("nus_corr_nolidar", "i2pnet_proj")])
def test_train_torch_on_nuscenes(nus_root, tmp_path, dataset, network):
    trainer = train_torch.main(["--dataset", dataset, "--network", network, "--tiny",
                                "--device", "cpu", "--max_epoch", "1", "--batch_size", "2",
                                "--root_path", nus_root, "--log_dir", str(tmp_path)])
    assert trainer.state.step == 1 and trainer.valid_loader is None
    assert trainer.ckpt.all_steps() == [0]


def test_evaluate_torch_on_nuscenes(nus_root, tmp_path):
    """nus_cmr_snr with a --test_rt CSV: the prediction file's init rows are
    the table's decalibrations as JAX's loader applies them; then
    nus_corr_nolidar on the proj tiny model."""
    from i2pnet_tpu_torch.data.preprocess import generate_test_rt

    rt = generate_test_rt(3, seed=9)
    csv = str(tmp_path / "rt.csv")
    with open(csv, "w") as f:
        f.write("id,tx,ty,tz,rx,ry,rz\n")
        for i, row in enumerate(rt):
            f.write(",".join([str(i)] + [repr(float(v)) for v in (*row[3:], *row[:3])]) + "\n")
    for dataset, model, extra in (
            ("nus_cmr_snr", I2PNet(I2PNetConfig.tiny(), device="cpu"), ["--test_rt", csv]),
            ("nus_corr_nolidar", I2PNetProj(I2PNetProjConfig.tiny(), device="cpu"), [])):
        run, out = str(tmp_path / f"run_{dataset}"), str(tmp_path / f"eval_{dataset}")
        CheckpointManager(run).save_best("model_rotation_best", {"model": model.state_dict()})
        network = "i2pnet" if dataset == "nus_cmr_snr" else "i2pnet_proj"
        summary = evaluate_torch.main(["--dataset", dataset, "--network", network, "--tiny",
                                       "--device", "cpu", "--root_path", nus_root,
                                       "--model_dir", run, "--batch_size", "2",
                                       "--log_dir", out] + extra)
        assert summary["count"] == 3 and np.isfinite(summary["rre_mean"])
        init = analysis.parse_prediction_file(os.path.join(out, "prediction.txt"))["init"]
        if dataset == "nus_cmr_snr":
            ref = JaxNusCMR(nus_root, _splits(nus_root, "test"), mode="test",
                            test_rt=jax_load_test_rt(csv))
            want = np.stack([ref[i]["init_extrinsic"] for i in range(3)])
            np.testing.assert_allclose(init, want, rtol=0, atol=1e-6)
