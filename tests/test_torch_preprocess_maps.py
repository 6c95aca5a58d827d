"""The offline KITTI builders of the port (``i2pnet_tpu_torch/data/
preprocess.py``: voxel downsample, normals, scans and images to npy, poses
to npz, local maps, the accumulation) against the JAX package's on the same
inputs, on the CPU: arrays bit for bit, the .npy and h5 files byte for
byte, the .npz files entry for entry (a zip member carries its
write time). The fixtures are those of tests/test_preprocess.py, copied
here, plus a raw sequence (velodyne .bin, poses.txt, calib.txt)."""

import os

import h5py
import numpy as np
import pytest

from i2pnet_tpu.data import preprocess as JP
from i2pnet_tpu_torch.data import KittiOdometryCMRDataset
from i2pnet_tpu_torch.data import preprocess as PP

CALIB_TXT = """\
P0: 700.0 0.0 600.0 0.0 0.0 700.0 180.0 0.0 0.0 0.0 1.0 0.0
P2: 700.0 0.0 600.0 44.8 0.0 700.0 180.0 0.2 0.0 0.0 1.0 0.003
Tr: 0.0 -1.0 0.0 0.01 0.0 0.0 -1.0 -0.05 1.0 0.0 0.0 -0.3
"""


def _same_files(a: str, b: str) -> None:
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def _same_h5(a: str, b: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:  # h5py writes no time stamps
        assert fa.read() == fb.read()
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert sorted(fa) == sorted(fb)
        for key in fa:
            assert fa[key].dtype == fb[key].dtype and fa[key].compression == fb[key].compression
            np.testing.assert_array_equal(np.asarray(fa[key]), np.asarray(fb[key]))


VOXEL_INPUTS = {
    "merge": (np.array([[0.01, 0.01, 0.01, 1.0], [0.02, 0.02, 0.02, 3.0], [5.0, 5.0, 5.0, 2.0]],
                       np.float32), 0.1),
    "cloud7": (np.random.default_rng(4).uniform(-20, 20, size=(5000, 7)).astype(np.float32), 0.5),
    "dense": (np.random.default_rng(5).normal(size=(3000, 4)).astype(np.float32), 0.05),
}


@pytest.mark.parametrize("name", sorted(VOXEL_INPUTS))
def test_voxel_downsample_equals_jax(name):
    pts, voxel = VOXEL_INPUTS[name]
    out = PP.voxel_downsample(pts, voxel)
    ref = JP.voxel_downsample(pts, voxel)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    if name == "merge":  # the JAX test's values
        assert out.shape == (2, 4)
        np.testing.assert_allclose(out[np.argmin(out[:, 0])], [0.015, 0.015, 0.015, 2.0],
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["plane", "cloud", "sparse"])
def test_estimate_normals_equals_jax(kind):
    rng = np.random.default_rng(0)
    if kind == "plane":
        pts = np.zeros((200, 3), np.float32)
        pts[:, :2] = rng.uniform(-1, 1, size=(200, 2))
        args = (0.6, 20)
    elif kind == "cloud":
        pts = rng.uniform(-2, 2, size=(800, 3)).astype(np.float32)
        args = (0.6, 30)
    else:  # most points have fewer than 3 neighbours: the (0, 0, 1) fallback
        pts = rng.uniform(-50, 50, size=(300, 3)).astype(np.float32)
        args = (0.6, 30)
    out = PP.estimate_normals(pts, *args)
    np.testing.assert_array_equal(out, JP.estimate_normals(pts, *args))
    if kind == "plane":
        assert np.abs(out[:, 2]).mean() > 0.99


def test_bin_to_npy_with_normals_equals_jax(tmp_path):
    pts = np.random.default_rng(1).uniform(-5, 5, size=(500, 4)).astype(np.float32)
    bin_path = str(tmp_path / "000000.bin")
    pts.tofile(bin_path)
    for voxel in (0.2, 0.0):
        out = PP.bin_to_npy_with_normals(bin_path, str(tmp_path / "port" / f"{voxel}.npy"),
                                         voxel=voxel)
        ref = JP.bin_to_npy_with_normals(bin_path, str(tmp_path / "jax" / f"{voxel}.npy"),
                                         voxel=voxel)
        np.testing.assert_array_equal(out, ref)
        assert out.shape[0] == 7
        np.testing.assert_allclose(np.linalg.norm(out[4:7], axis=0), 1.0, atol=1e-4)
    _same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_images_to_npy_equals_jax(tmp_path):
    from PIL import Image

    src = tmp_path / "image_2"
    src.mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, size=(20, 30, 3), dtype=np.uint8)).save(
            src / f"{i:06d}.png")
    (src / "notes.txt").write_text("skipped")
    assert PP.images_to_npy(str(src), str(tmp_path / "port")) == 3
    assert JP.images_to_npy(str(src), str(tmp_path / "jax")) == 3
    _same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


def _pose_rows(n: int, seed: int = 0) -> np.ndarray:
    """n KITTI pose rows (12 floats): yaw turning, moving ahead."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        a = 0.02 * i + rng.normal(0, 0.001)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        t = np.array([0.1 * i, rng.normal(0, 0.01), 1.5 * i])
        rows.append(np.hstack([R, t[:, None]]).reshape(-1))
    return np.array(rows)


def _same_npz(a: str, b: str) -> None:
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        za, zb = np.load(os.path.join(a, name)), np.load(os.path.join(b, name))
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            assert za[key].dtype == zb[key].dtype
            np.testing.assert_array_equal(za[key], zb[key])


def test_poses_to_npz_and_load_pose_equal_jax(tmp_path):
    txt = str(tmp_path / "00.txt")
    np.savetxt(txt, _pose_rows(4))
    assert PP.poses_to_npz(txt, str(tmp_path / "port")) == 4
    assert JP.poses_to_npz(txt, str(tmp_path / "jax")) == 4
    _same_npz(str(tmp_path / "port"), str(tmp_path / "jax"))
    path = str(tmp_path / "port" / "000001.npz")
    np.testing.assert_array_equal(PP._load_pose(path), JP._load_pose(path))
    # the reference's positional key
    np.savez(str(tmp_path / "ref.npz"), np.eye(4) * 2)
    np.testing.assert_array_equal(PP._load_pose(str(tmp_path / "ref.npz")), np.eye(4) * 2)


@pytest.mark.parametrize("voxel", [0.5, 0.1])
def test_build_local_maps_equals_jax(voxel, tmp_path):
    rng = np.random.default_rng(2)
    scans = [rng.uniform(-20, 20, size=(300, 4)).astype(np.float32) for _ in range(2)]
    poses = [np.eye(4), np.eye(4)]
    poses[1] = poses[1].copy()
    poses[1][0, 3] = 3.0
    assert PP.build_local_maps(scans, poses, str(tmp_path / "port"), voxel=voxel) == 2
    assert JP.build_local_maps(scans, poses, str(tmp_path / "jax"), voxel=voxel) == 2
    for name in ("000000.h5", "000001.h5"):
        _same_h5(str(tmp_path / "port" / name), str(tmp_path / "jax" / name))
    with h5py.File(str(tmp_path / "port" / "000000.h5"), "r") as hf:
        pc = np.asarray(hf["PC"])
        assert pc.shape[0] == 4 and pc.shape[1] > 100
        assert pc[0].min() > -10.0 - 1e-5 and pc[0].max() < 100.0


def test_build_local_maps_writes_through_one_function(tmp_path, monkeypatch):
    """Every map goes through write_local_map, the one h5py call (a machine
    without h5py stands in for it alone)."""
    rng = np.random.default_rng(3)
    scans = [rng.uniform(-20, 20, size=(300, 4)).astype(np.float32) for _ in range(3)]
    poses = [np.eye(4) for _ in range(3)]
    written = {}
    monkeypatch.setattr(PP, "write_local_map", lambda p, pc, i: written.__setitem__(
        os.path.basename(p), (pc, i)))
    PP.build_local_maps(scans, poses, str(tmp_path / "maps"), voxel=0.5)
    assert sorted(written) == ["000000.h5", "000001.h5", "000002.h5"]
    pc, inten = written["000000.h5"]
    assert pc.dtype == inten.dtype == np.float32 and inten.shape == (1, pc.shape[1])
    assert not os.listdir(str(tmp_path / "maps"))


def write_raw_sequence(root: str, frames: int = 9, points: int = 1500, seed: int = 0) -> dict:
    """A raw KITTI odometry sequence as numpy writes it: velodyne .bin scans
    (x ahead; a road and two facades), poses.txt and calib.txt; then the
    builders' first steps (scans with normals, the pose npz). Returns the
    folders."""
    rng = np.random.default_rng(seed)
    velo = os.path.join(root, "velodyne")
    os.makedirs(velo)
    for i in range(frames):
        x = rng.uniform(-30, 30, points)
        y = np.where(rng.random(points) < 0.5, rng.uniform(-8, 8, points),
                     np.sign(rng.normal(size=points)) * rng.uniform(6, 9, points))
        z = np.where(np.abs(y) < 6, -1.73 + rng.normal(0, 0.02, points),
                     rng.uniform(-1.7, 5, points))
        np.stack([x, y, z, rng.uniform(0, 1, points)], 1).astype(np.float32).tofile(
            os.path.join(velo, "%06d.bin" % i))
    np.savetxt(os.path.join(root, "poses.txt"), _pose_rows(frames, seed))
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(CALIB_TXT)
    snr = os.path.join(root, "voxel0.1-SNr0.6")
    for i in range(frames):
        PP.bin_to_npy_with_normals(os.path.join(velo, "%06d.bin" % i),
                                   os.path.join(snr, "%06d.npy" % i), voxel=0.3)
    PP.poses_to_npz(os.path.join(root, "poses.txt"), os.path.join(root, "poses"))
    return {"pc": snr, "poses": os.path.join(root, "poses"),
            "calib": os.path.join(root, "calib.txt"), "velo": velo}


@pytest.fixture(scope="module")
def raw_seq(tmp_path_factory):
    return write_raw_sequence(str(tmp_path_factory.mktemp("kitti_raw_seq")))


@pytest.mark.parametrize("frame", [0, 4, 8])
def test_accumulate_point_cloud_equals_jax(raw_seq, frame):
    from i2pnet_tpu.data.calib import read_calib as jax_read_calib

    Tr, _, P = jax_read_calib(raw_seq["calib"])
    Pc = P @ np.vstack([Tr, [0, 0, 0, 1]])
    got = PP.accumulate_point_cloud(raw_seq["pc"], raw_seq["poses"], frame, 9, Pc,
                                    accumulation_frame_num=2, accumulation_frame_skip=2,
                                    rng=np.random.default_rng(7))
    want = JP.accumulate_point_cloud(raw_seq["pc"], raw_seq["poses"], frame, 9, Pc,
                                     accumulation_frame_num=2, accumulation_frame_skip=2,
                                     rng=np.random.default_rng(7))
    assert got.shape[0] == 7 and got.shape[1] > np.load(
        os.path.join(raw_seq["pc"], "%06d.npy" % frame)).shape[1]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_points", [2 * 20480, 3000], ids=["kept", "downsampled"])
def test_process_sequence_accumulation_equals_jax(raw_seq, max_points, tmp_path):
    outs = {}
    for name, mod in (("port", PP), ("jax", JP)):
        snr, pc = str(tmp_path / name / "snr"), str(tmp_path / name / "pc")
        assert mod.process_sequence_accumulation(raw_seq["pc"], raw_seq["poses"],
                                                 raw_seq["calib"], snr, pc,
                                                 max_points=max_points, seed=3) == 9
        outs[name] = (snr, pc)
    for a, b in zip(outs["port"], outs["jax"]):
        _same_files(a, b)
    first = np.load(os.path.join(outs["port"][0], "000000.npy"))
    assert first.shape[0] == 7 and (first.shape[1] <= max_points or max_points > 20000)


def test_raw_sequence_to_the_cmr_loader(raw_seq, tmp_path):
    """From the raw layout to the files the KITTI odometry CMR loader reads:
    the local maps built from the scans and poses, equal to JAX's, then read
    by the port's KittiOdometryCMRDataset."""
    scans = [np.fromfile(os.path.join(raw_seq["velo"], "%06d.bin" % i), np.float32)
             .reshape(-1, 4) for i in range(9)]
    poses = [PP._load_pose(os.path.join(raw_seq["poses"], "%06d.npz" % i)) for i in range(9)]
    seq = tmp_path / "kitti_processed_CMRNet" / "sequences" / "00"
    assert PP.build_local_maps(scans, poses, str(seq / "local_maps"), voxel=0.2) == 9
    JP.build_local_maps(scans, poses, str(tmp_path / "jax_maps"), voxel=0.2)
    for i in range(9):
        _same_h5(str(seq / "local_maps" / ("%06d.h5" % i)), str(tmp_path / "jax_maps" /
                                                              ("%06d.h5" % i)))
    os.makedirs(seq / "image_2_npy")
    rng = np.random.default_rng(9)
    for i in range(9):
        np.save(seq / "image_2_npy" / ("%06d.npy" % i),
                rng.integers(0, 256, size=(376, 1241, 3), dtype=np.uint8))
    (seq / "calib.txt").write_text(CALIB_TXT)
    ds = KittiOdometryCMRDataset(str(tmp_path), mode="test", seed=0, img_H=64, img_W=128,
                                 sample_point=512)
    assert len(ds) == 9
    s = ds[4]
    assert s["rgb"].shape == (64, 128, 3) and s["lidar"].shape == (512, 3)
    assert np.isfinite(s["lidar"]).all()
