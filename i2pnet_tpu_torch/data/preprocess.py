"""The fixed-decalibration tables of the evaluation protocols, the port's
copy of the table helpers of ``i2pnet_tpu/data/preprocess.py``: the test
tables of the KITTI odometry and nuScenes small-range protocols
(``generate_test_rt``, ``load_test_rt``, the 10-seed protocol's
``cmr_seed_value`` and ``cmr_test_rt_path``) and the RGGNet protocol's
splits (``RGG_SPLITS``, ``generate_rgg_splits``). numpy and the standard
library only: ``load_test_rt`` reads CSV tables with the ``csv`` module, so
``--test_rt`` runs where pandas is not installed. The offline map builders
of that module (h5py, PIL) are not ported."""

from __future__ import annotations

import csv
import os
import pickle
import re
from typing import List, Optional, Sequence

import numpy as np

# id, tx..tz, rx..rz (the reference CSV's column order) -> rx..rz, tx..tz
_ID_FIRST = [4, 5, 6, 1, 2, 3]
_NAMES = ["rx", "ry", "rz", "tx", "ty", "tz"]
_DECIMAL = re.compile(r"([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?")
_POW10 = [float(f"1e{k}") for k in range(309)]

# the RGGNet protocol's splits: raw-KITTI drives, sample counts and
# decalibration amplitudes (euler degrees, meters)
_RGG_DRIVES_0926 = (1, 2, 9, 11, 13, 14, 15, 17, 18, 19, 20, 22, 23, 27, 28, 29, 32, 35, 36,
                    39, 46, 48, 51, 52, 56, 57, 59, 60, 61, 64, 79, 84, 86, 87, 91, 93, 95, 96,
                    101, 104, 106, 113, 117)
RGG_SPLITS = {
    "train1_val": dict(date="2011_09_26", num=24000, drives=_RGG_DRIVES_0926, rot=15.0,
                       trans=0.2, train_split=22000),
    "train2": dict(date="2011_09_26", num=4000, drives=_RGG_DRIVES_0926, rot=0.0, trans=0.3),
    "train3": dict(date="2011_09_26", num=4000, drives=_RGG_DRIVES_0926, rot=20.0, trans=0.0),
    "train_val_ex": dict(date="2011_10_03", num=2000, drives=(27,), rot=2.0, trans=0.3,
                         train_split=1800),
    "T1": dict(date="2011_09_26", num=2000, drives=(5, 70), rot=15.0, trans=0.2),
    "T2a": dict(date="2011_09_26", num=2000, drives=_RGG_DRIVES_0926, rot=10.0, trans=0.2),
    "T2b": dict(date="2011_09_26", num=2000, drives=(5, 70), rot=10.0, trans=0.2),
    "T3": dict(date="2011_10_03", num=2000, drives=(27,), rot=2.0, trans=0.3),
}


def generate_rgg_splits(base_path: str, save_dir: str, seed: int = 0,
                        splits: Optional[Sequence[str]] = None) -> list:
    """The RGGNet protocol's fixed-decalibration sets: per split, ``num``
    (image, scan) pairs drawn from the drives (whole permutations tiled,
    then topped up, where the drives hold fewer) and a per-sample table of
    euler-degree rotations and meter translations, uniform in
    +-amplitude; pickled as ``rgg_data_<key>.pkl``. Splits with a
    ``train_split`` count also carry the training indices. Returns the
    written paths."""
    os.makedirs(save_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    written = []
    for key, p in RGG_SPLITS.items():
        if splits is not None and key not in splits:
            continue
        imgs, lidars = [], []
        for drive in p["drives"]:
            drive_dir = os.path.join(base_path, p["date"], f"{p['date']}_drive_{drive:04d}_sync")
            img_dir = os.path.join(drive_dir, "image_02", "data")
            lid_dir = os.path.join(drive_dir, "velodyne_points", "data")
            if not os.path.isdir(img_dir) or not os.path.isdir(lid_dir):
                continue
            d_imgs = [os.path.join(img_dir, f) for f in sorted(os.listdir(img_dir))
                      if f.endswith(".png")]
            d_lidars = [os.path.join(lid_dir, f) for f in sorted(os.listdir(lid_dir))
                        if f.endswith(".bin")]
            # positional pairing: a dropped frame would shift every later pair
            if len(d_imgs) != len(d_lidars):
                raise ValueError(f"{drive_dir}: {len(d_imgs)} images vs {len(d_lidars)} scans "
                                 "— cannot pair positionally")
            imgs.extend(d_imgs)
            lidars.extend(d_lidars)
        M, N = len(imgs), p["num"]
        if M == 0:
            continue
        if M >= N:
            choice = rng.choice(M, N, replace=False)
        else:
            choice = np.concatenate([rng.permutation(M) for _ in range(N // M)]
                                    + [rng.choice(M, N % M, replace=False)])[:N]
        data = {
            "img": np.array(imgs)[choice],
            "lidar": np.array(lidars)[choice],
            "rot": rng.random((N, 3)) * (2 * p["rot"]) - p["rot"],
            "trans": rng.random((N, 3)) * (2 * p["trans"]) - p["trans"],
        }
        if "train_split" in p:
            data["train_split"] = rng.choice(N, min(p["train_split"], N), replace=False)
        out = os.path.join(save_dir, f"rgg_data_{key}.pkl")
        with open(out, "wb") as f:
            pickle.dump(data, f)
        written.append(out)
    return written


def generate_test_rt(n: int, max_r_deg: float = 10.0, max_t: float = 2.0, seed: int = 0,
                     clip_tz: bool = False) -> np.ndarray:
    """A fixed test decalibration table, (n, 6) f64 rows [rx, ry, rz, tx,
    ty, tz] in rad and m, each uniform in +-amplitude; ``clip_tz`` caps tz
    at 1 m as the KITTI CMR train sampler does (tables default to the full
    range)."""
    rng = np.random.default_rng(seed)
    r = np.deg2rad(max_r_deg)
    rt = np.stack([
        rng.uniform(-r, r, n),
        rng.uniform(-r, r, n),
        rng.uniform(-r, r, n),
        rng.uniform(-max_t, max_t, n),
        rng.uniform(-max_t, max_t, n),
        rng.uniform(-max_t, min(max_t, 1.0) if clip_tz else max_t, n),
    ], axis=1)
    return rt.astype(np.float64)


def _cells(row: List[str]) -> List[str]:
    return [c.strip() for c in row if c.strip()]


def _numeric_row(cells: List[str]) -> bool:
    if not cells:
        return False
    try:
        [float(c) for c in cells]
    except ValueError:
        return False
    return True


def _csv_float(text: str) -> float:
    """A CSV cell as the JAX package's reader (pandas' C parser) rounds it:
    up to 17 significant digits gathered into a double one digit at a time,
    then one multiplication or division by a power of ten. A 17-digit value
    can land 1 ulp from Python's correctly rounded ``float``; this keeps
    the two packages' tables equal bit for bit. Cells that are no plain
    decimal (nan, inf) go to ``float``."""
    m = _DECIMAL.fullmatch(text.strip())
    if m is None or not (m.group(2) or m.group(3)):
        return float(text)
    sign, whole, frac, exp = m.groups()
    number, exponent, digits = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + int(ch)
            digits += 1
        else:
            exponent += 1
    for ch in (frac or "")[:max(0, 17 - digits)]:
        number = number * 10.0 + int(ch)
        exponent -= 1
    if sign == "-":
        number = -number
    exponent += int(exp) if exp else 0
    if exponent > 308:
        return float("inf") if number > 0 else float("-inf") if number < 0 else 0.0
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _floats(rows: List[List[str]]) -> np.ndarray:
    return np.array([[_csv_float(c) for c in row] for row in rows], np.float64)


def load_test_rt(path: str) -> np.ndarray:
    """A fixed test-decalibration table in either protocol's format, as
    (N, 6) f64 rows [rx, ry, rz, tx, ty, tz]:

    - a CSV with a header: named ``rx..tz`` columns are taken in that order
      whatever their position (the reference's ``id,tx,ty,tz,rx,ry,rz``
      puts translation first); another 7-column header is read as that
      layout;
    - a headerless CSV (its first row all numbers, so it is not taken for
      a header and sample 0 is kept): 6 columns as they are, 7 as ``id``
      then translation then rotation;
    - a per-seed pickle of the 10-seed protocol: a list of 6-element rows
      in rx-first order (or 7, reordered as above).

    Raises ``ValueError`` on any other width."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            rows = pickle.load(f)
        rt = np.asarray(rows, np.float64)
        if rt.shape[1] == 7:
            rt = rt[:, _ID_FIRST]
    else:
        with open(path, newline="") as f:
            rows = [row for row in csv.reader(f) if any(c.strip() for c in row)]
        if _numeric_row(_cells(rows[0])):
            rt = _floats([_cells(row) for row in rows])
            if rt.shape[1] == 7:
                rt = rt[:, _ID_FIRST]
        else:
            header = [c.strip().lower() for c in rows[0]]
            body = [[c.strip() for c in row] for row in rows[1:]]
            if all(w in header for w in _NAMES):
                rt = _floats([[row[header.index(w)] for w in _NAMES] for row in body])
            else:
                rt = _floats(body)
                if rt.shape[1] == 7:
                    rt = rt[:, _ID_FIRST]
    if rt.ndim != 2 or rt.shape[1] != 6:
        raise ValueError(f"{path}: expected 6 (or id+6) columns, got {rt.shape[-1]}")
    return rt


def cmr_seed_value(cmr_seed: int) -> int:
    """The 10-seed protocol's seed -> file-name tag: ((seed % 2) * 5) *
    10 ** (seed // 2), so seeds 0-9 give 0, 5, 0, 50, 0, 500, 0, 5000, 0,
    50000."""
    return ((cmr_seed % 2) * 5) * 10 ** (cmr_seed // 2)


def cmr_test_rt_path(dir_path: str, seq: str, max_r: float, max_t: float,
                     cmr_seed: int) -> str:
    """The per-seed pickle of the 10-seed protocol under ``dir_path``:
    ``test_RT_seq<seq>_<max_r>_<max_t>_<tag>.pkl``."""
    return os.path.join(
        dir_path, f"test_RT_seq{seq}_{max_r:.2f}_{max_t:.2f}_{cmr_seed_value(cmr_seed):d}.pkl")
