"""ctypes bindings for the native host-IO library (port of
``i2pnet_tpu/data/native_io.py``, on the same C++ source,
``native/i2pnet_io.cpp``).

The library is built at first use with ``native/Makefile``'s flags
(``g++ -O3 -march=native -shared -fPIC -std=c++17``: the JAX package's
arithmetic, fused multiply-adds included, so both packages assemble the
same samples bit for bit) into ``build/i2pnet_tpu_torch/`` beside the
package, keyed by a hash of the source, the flags and the host CPU's
features, under a file lock (forked loader workers and parallel jobs may
touch it first at once). The tracked ``native/libi2pnet_io.so`` is never
rebuilt or written. Every entry point keeps its numpy version: it runs
where no compiler is found, and the tests hold the native path to it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
_SOURCE = _ROOT / "native" / "i2pnet_io.cpp"
_BUILD_DIR = _ROOT / "build" / "i2pnet_tpu_torch"
_CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_lib = None
_tried = False


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: ``-march=native`` builds for them, so a
    library built on another host (a copied build directory) is not reused."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return platform.machine().encode()


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    h.update(_cpu_flags())
    return _BUILD_DIR / f"libi2pnet_io_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile the source into ``path`` under an exclusive lock; a process
    that waited on the lock finds the library built and loads it."""
    import fcntl

    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / ".i2pnet_io.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                return
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            subprocess.run(
                [os.environ.get("CXX", "g++"), *_CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, path)  # readers never see a half-written library
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _lib_path()
    try:
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError):
        # no compiler here: the numpy versions run
        return None

    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.read_velodyne_bin.restype = ctypes.c_int64
    lib.read_velodyne_bin.argtypes = [ctypes.c_char_p, f32p, f32p, ctypes.c_int64]
    lib.transform_pad_points.restype = None
    lib.transform_pad_points.argtypes = [f32p, ctypes.c_int64, f32p, f32p, ctypes.c_int64]
    lib.voxel_downsample.restype = ctypes.c_int64
    lib.voxel_downsample.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_float, f32p]
    lib.assemble_large_range_sample.restype = None
    lib.assemble_large_range_sample.argtypes = [
        f32p, f32p, f32p, i64p, ctypes.c_int64, f32p, ctypes.c_int64,
        f32p, f32p, f32p, f32p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_velodyne_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (xyz (n,3) f32, intensity (n,) f32).

    The buffer is sized from the file (16 bytes per record), so no scan is
    silently truncated; a trailing partial record is dropped on both the
    native and fallback paths (identical outputs by toolchain)."""
    n_rec = os.path.getsize(path) // 16
    lib = _load()
    if lib is None:
        raw = np.fromfile(path, np.float32, count=n_rec * 4).reshape(-1, 4)
        return np.ascontiguousarray(raw[:, :3]), np.ascontiguousarray(raw[:, 3])
    xyz = np.empty((n_rec, 3), np.float32)
    inten = np.empty((n_rec,), np.float32)
    n = lib.read_velodyne_bin(path.encode(), _fp(xyz), _fp(inten), n_rec)
    if n < 0:
        raise FileNotFoundError(path)
    return xyz[:n], inten[:n]


def transform_pad_points(xyz: np.ndarray, E: np.ndarray, total: int) -> np.ndarray:
    """out[i] = E[:, :3] @ xyz[i] + E[:, 3], zero-padded to (total, 3)."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    E = np.ascontiguousarray(E, np.float32).reshape(3, 4)
    lib = _load()
    if lib is None:
        out = np.zeros((total, 3), np.float32)
        n = min(len(xyz), total)
        out[:n] = xyz[:n] @ E[:, :3].T + E[:, 3]
        return out
    out = np.empty((total, 3), np.float32)
    # clamp like the numpy fallback: the C kernel writes n points into the
    # (total, 3) buffer with no bound check of its own
    lib.transform_pad_points(
        _fp(xyz), min(len(xyz), total), _fp(E), _fp(out), total
    )
    return out


def voxel_downsample_numpy(points: np.ndarray, voxel: float) -> np.ndarray:
    """Average points per voxel, in numpy (``i2pnet_tpu/data/preprocess.py``
    ``voxel_downsample``); the output's order is np.unique's, the native
    one's is first appearance."""
    coords = np.floor_divide(points[:, :3] - points[:, :3].min(0), voxel).astype(np.int64)
    _, inverse, counts = np.unique(coords, axis=0, return_inverse=True, return_counts=True)
    out = np.zeros((counts.shape[0], points.shape[1]), np.float64)
    np.add.at(out, inverse.reshape(-1), points)
    return (out / counts[:, None]).astype(np.float32)


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Average points per voxel; points (n, c) with xyz first."""
    points = np.ascontiguousarray(points, np.float32)
    lib = _load()
    if lib is None:
        return voxel_downsample_numpy(points, voxel)
    out = np.empty_like(points)
    n_out = lib.voxel_downsample(
        _fp(points), len(points), points.shape[1], ctypes.c_float(voxel), _fp(out)
    )
    return out[:n_out].copy()


def assemble_large_range_sample(
    xyz: np.ndarray,
    intensity: np.ndarray,
    normals: Optional[np.ndarray],
    perm: np.ndarray,
    E: np.ndarray,
    total: int,
):
    """Fused permute + transform + pad (the KittiLargeRangeDataset hot loop).

    Returns (lidar (total,3), feats (total,1), raw (total,3),
    sn (total,3) or None).
    """
    xyz = np.ascontiguousarray(xyz, np.float32)
    intensity = np.ascontiguousarray(intensity, np.float32).reshape(-1)
    E = np.ascontiguousarray(E, np.float32).reshape(3, 4)
    perm = np.ascontiguousarray(perm, np.int64)
    n = min(len(perm), total)
    lib = _load()
    if lib is None:
        sel = perm[:n]
        raw = np.zeros((total, 3), np.float32)
        raw[:n] = xyz[sel]
        lidar = np.zeros((total, 3), np.float32)
        lidar[:n] = raw[:n] @ E[:, :3].T + E[:, 3]
        feats = np.zeros((total, 1), np.float32)
        feats[:n, 0] = intensity[sel]
        sn = None
        if normals is not None:
            sn = np.zeros((total, 3), np.float32)
            sn[:n] = normals[sel] @ E[:, :3].T
        return lidar, feats, raw, sn

    lidar = np.empty((total, 3), np.float32)
    feats = np.empty((total, 1), np.float32)
    raw = np.empty((total, 3), np.float32)
    sn = np.empty((total, 3), np.float32) if normals is not None else None
    nrm = np.ascontiguousarray(normals, np.float32) if normals is not None else None
    lib.assemble_large_range_sample(
        _fp(xyz),
        _fp(intensity),
        _fp(nrm) if nrm is not None else ctypes.cast(None, ctypes.POINTER(ctypes.c_float)),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        _fp(E),
        total,
        _fp(lidar),
        _fp(feats),
        _fp(raw),
        _fp(sn) if sn is not None else ctypes.cast(None, ctypes.POINTER(ctypes.c_float)),
    )
    return lidar, feats, raw, sn
