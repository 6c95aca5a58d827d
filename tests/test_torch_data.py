"""The port's data layer against the JAX package's, on the CPU.

- ``resize_image`` (numpy) equals ``cv2.resize(..., INTER_LINEAR)`` on
  uint8 exactly at every loader's shapes, down and up (the CMR loader
  upscales rows), and at three others.
- ``KittiLargeRangeDataset``: every key of every sample equal to the JAX
  package's (rgb included) on a synthetic on-disk tree built like
  tests/test_data.py's, in test and train mode.
- ``collate``, ``to_model_batch`` and ``BatchLoader`` (order, reseeding
  per task) equal to JAX's with 0 and 2 workers; ``prefetch_to_device``.
- ``native_io``: the native library against the numpy versions, and
  against the JAX package's library.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from i2pnet_tpu.data import native_io as JNIO
from i2pnet_tpu.data import transforms as JT
from i2pnet_tpu.data.calib import read_calib as jax_read_calib
from i2pnet_tpu.data.kitti_large_range import KittiLargeRangeDataset as JaxLargeRange
from i2pnet_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from i2pnet_tpu.data.pipeline import collate as jax_collate
from i2pnet_tpu.data.pipeline import to_model_batch as jax_to_model_batch
from i2pnet_tpu.data.preprocess import voxel_downsample as jax_voxel_downsample
from i2pnet_tpu_torch.data import native_io as NIO
from i2pnet_tpu_torch.data import transforms as T
from i2pnet_tpu_torch.data.calib import read_calib
from i2pnet_tpu_torch.data.kitti_large_range import KittiLargeRangeDataset
from i2pnet_tpu_torch.data.pipeline import (
    BatchLoader,
    collate,
    prefetch_to_device,
    to_model_batch,
)

CALIB_TXT = """P0: 700.0 0.0 600.0 0.0 0.0 700.0 180.0 0.0 0.0 0.0 1.0 0.0
P2: 700.0 0.0 600.0 44.8 0.0 700.0 180.0 0.2 0.0 0.0 1.0 0.003
Tr: 0.0 -1.0 0.0 0.01 0.0 0.0 -1.0 -0.05 1.0 0.0 0.0 -0.3
"""


def write_large_range_tree(root, seqs, frames, points, seed=1):
    """The large-range loader's layout: (7, n) voxel scans (xyz, intensity,
    normals), (376, 1241, 3) uint8 images and calib.txt a sequence."""
    rng = np.random.default_rng(seed)
    for seq in seqs:
        seq_dir = os.path.join(root, "kitti_processed_DeepI2P", "data_odometry_velodyne",
                               "sequences", "%02d" % seq)
        os.makedirs(os.path.join(seq_dir, "voxel0.1-SNr0.6"))
        os.makedirs(os.path.join(seq_dir, "image_2_npy"))
        with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
            f.write(CALIB_TXT)
        for fi in range(frames):
            data = np.zeros((7, points), np.float32)
            data[0:3] = rng.uniform(-40, 40, size=(3, points))
            data[3] = rng.uniform(0, 1, size=points)
            data[4:7] = rng.normal(size=(3, points))
            np.save(os.path.join(seq_dir, "voxel0.1-SNr0.6", "%06d.npy" % fi), data)
            img = rng.integers(0, 255, size=(376, 1241, 3), dtype=np.uint8)
            np.save(os.path.join(seq_dir, "image_2_npy", "%06d.npy" % fi), img)
    return root


@pytest.fixture(scope="module")
def large_root(tmp_path_factory):
    return write_large_range_tree(str(tmp_path_factory.mktemp("kitti_large")), (0, 7, 8, 9), 2, 800)


def _uint8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


# (in_h, in_w, out_h, out_w): the large-range loader's crops of the KITTI
# image at scale 0.5 (rows 376 and 326 after the 50-row crop), the raw
# online-calibration loader's resizes of a raw frame (the protocol's and the
# tiny size), the KITTI odometry CMR loader's upscales of a frame 376, 375
# or 370 rows high, less its 50-row crop, to 384x1280, the nuScenes loaders'
# scaled frames (900 rows less the 100-row crop, at 0.8 and at 0.2 x 0.32),
# and two others
@pytest.mark.parametrize("h,w,oh,ow", [(326, 1241, 163, 620), (376, 1241, 188, 620),
                                       (375, 1242, 352, 1216), (375, 1242, 64, 128),
                                       (326, 1241, 384, 1280), (325, 1242, 384, 1280),
                                       (320, 1226, 384, 1280), (800, 1600, 640, 1280),
                                       (800, 1600, 160, 512),
                                       (64, 128, 32, 64), (37, 91, 13, 200)])
def test_resize_image_equals_cv2(h, w, oh, ow):
    img = _uint8((h, w, 3), h + w)
    ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(T.resize_image(img, ow, oh), ref)
    np.testing.assert_array_equal(T.resize_image(img[..., 0], ow, oh), ref[..., 0])


def test_resize_image_upscaled_rows_against_cv2():
    """More output rows than input rows, and more columns: OpenCV keeps a
    border row's two weights and clamps both source rows (the same row
    weighted twice), where a border column takes its pixel at weight 1;
    the port follows both rules and equals cv2 on every row, the first
    and last included."""
    img = _uint8((160, 512, 3), 5)
    ref = cv2.resize(img, (1024, 320), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(T.resize_image(img, 1024, 320), ref)


def test_transforms_match_jax():
    for seed in range(3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        P = T.generate_random_transform(a, 10, 0.5, 10, 0.1, 6.28, 0.2, clip_tz=seed == 0)
        np.testing.assert_array_equal(
            P, JT.generate_random_transform(b, 10, 0.5, 10, 0.1, 6.28, 0.2, clip_tz=seed == 0))
        for x, y in zip(T.decalib_ground_truth(np.linalg.inv(P)[:3]),
                        JT.decalib_ground_truth(np.linalg.inv(P)[:3])):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(T.sample_points_with_repetition(a, 50, 120),
                                      JT.sample_points_with_repetition(b, 50, 120))
        pc = a.normal(size=(3, 40)).astype(np.float32)
        b.normal(size=(3, 40))
        np.testing.assert_array_equal(T.jitter_point_cloud(a, pc), JT.jitter_point_cloud(b, pc))


def test_read_calib_matches_jax(tmp_path):
    path = tmp_path / "calib.txt"
    path.write_text(CALIB_TXT)
    for x, y in zip(read_calib(str(path)), jax_read_calib(str(path))):
        np.testing.assert_array_equal(x, y)


def _assert_samples_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode", ["test", "train"])
def test_large_range_dataset_matches_jax(large_root, mode):
    kw = dict(mode=mode, seed=3, sample_point=1000)
    ours, ref = KittiLargeRangeDataset(large_root, **kw), JaxLargeRange(large_root, **kw)
    # test: sequences 7 and 8; train: 0-8
    assert len(ours) == len(ref) == (4 if mode == "test" else 6)
    for i in range(len(ref)):
        _assert_samples_equal(ours[i], ref[i])
    s = ours[0]
    assert s["rgb"].shape == (160, 512, 3) and s["lidar"].shape == (1000, 3)
    assert np.all(s["lidar"][800:] == 0)  # zero-padded past the scan's 800 points


@pytest.mark.parametrize("workers", [0, 2])
def test_batch_loader_matches_jax(large_root, workers):
    """Shuffled batches in the same order, and the per-task reseeding of a
    dataset with an rng (the train-mode jitter draws) the same."""
    kw = dict(mode="train", seed=0, sample_point=900)
    ours = BatchLoader(KittiLargeRangeDataset(large_root, **kw), 2, seed=4, num_workers=workers,
                       transform=to_model_batch)
    ref = JaxBatchLoader(JaxLargeRange(large_root, **kw), 2, seed=4, num_workers=workers,
                         transform=jax_to_model_batch)
    try:
        for _ in range(2):  # two epochs: the reseeding moves with the epoch
            got, want = list(ours), list(ref)
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                _assert_samples_equal(a, b)
                assert "intrinsic" in a and "decalib_q_gt" in a
    finally:
        ours.close()
        ref.close()


def test_collate_and_prefetch(large_root):
    ds = KittiLargeRangeDataset(large_root, mode="test", sample_point=850)
    samples = [ds[0], ds[1]]
    for device_only in (False, True):
        _assert_samples_equal(collate(samples, device_only), jax_collate(samples, device_only))
    batch = collate(samples)
    moved = list(prefetch_to_device([batch, batch], "cpu", keys=("rgb", "lidar")))
    assert len(moved) == 2
    for k, v in moved[0].items():
        if k in ("rgb", "lidar"):
            assert isinstance(v, torch.Tensor) and np.array_equal(v.numpy(), batch[k])
        else:
            assert v is batch[k]
    assert all(isinstance(v, torch.Tensor) or not isinstance(v, np.ndarray)
               for v in next(prefetch_to_device([batch], "cpu")).values())


def test_native_io_builds_beside_the_package():
    assert NIO.available()
    path = NIO._lib_path()
    assert path.parent.parts[-2:] == ("build", "i2pnet_tpu_torch") and path.exists()


def test_native_io_against_numpy_and_jax(tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(1000, 4)).astype(np.float32)
    pts.tofile(tmp_path / "scan.bin")
    xyz, inten = NIO.read_velodyne_bin(str(tmp_path / "scan.bin"))
    np.testing.assert_array_equal(xyz, pts[:, :3])
    np.testing.assert_array_equal(inten, pts[:, 3])

    n = 800
    xyz = (rng.normal(size=(n, 3)) * 20).astype(np.float32)
    inten = rng.normal(size=(n,)).astype(np.float32)
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    perm = rng.permutation(n).astype(np.int64)
    E = rng.normal(size=(3, 4)).astype(np.float32)
    native = NIO.assemble_large_range_sample(xyz, inten, normals, perm, E, 1000)
    padded = NIO.transform_pad_points(xyz, E, 900)
    vox = NIO.voxel_downsample(pts, 0.5)
    # the JAX package's library: the same source and flags, bit for bit
    for a, b in zip(native, JNIO.assemble_large_range_sample(xyz, inten, normals, perm, E, 1000)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(padded, JNIO.transform_pad_points(xyz, E, 900))

    # the numpy versions: fused multiply-adds round otherwise (1e-6 relative)
    saved = NIO._lib, NIO._tried
    NIO._lib, NIO._tried = None, True
    try:
        plain = NIO.assemble_large_range_sample(xyz, inten, normals, perm, E, 1000)
        plain_padded = NIO.transform_pad_points(xyz, E, 900)
        plain_vox = NIO.voxel_downsample(pts, 0.5)
    finally:
        NIO._lib, NIO._tried = saved
    for a, b in zip(native, plain):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(padded, plain_padded, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(plain_vox, jax_voxel_downsample(pts, 0.5))
    assert vox.shape == plain_vox.shape  # voxel sets are order-free: sort the rows
    np.testing.assert_allclose(vox[np.lexsort(vox.T[::-1])],
                               plain_vox[np.lexsort(plain_vox.T[::-1])], atol=1e-4)
