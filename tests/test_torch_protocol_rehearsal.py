"""The port's protocol rehearsal (``tools/protocol_rehearsal_torch.py``)
against the JAX tool (``tools/protocol_rehearsal.py``), on the CPU.

- the generators write the same trees for the same seed, file by file:
  every ``.npy`` array equal, every ``calib.txt`` equal, the h5 local maps
  equal (h5py imports here; the card's machine lacks it, and the cmr
  generator then raises an error that names it);
- JAX's geometric-consistency checks (tests/test_protocol_rehearsal.py)
  through the port's loaders: a generated frame reprojects onto lit
  pixels, and so does a loader's sample warped by its ground truth;
- ``_summarize`` equals JAX's on one info dir, and ``protocol_summary``'s
  identity prediction is the initial extrinsic's error.
"""

import os
import sys

import numpy as np
import pytest

from i2pnet_tpu_torch import metrics as M
from i2pnet_tpu_torch.eval.evaluator import SECTION
from test_protocol_rehearsal import _lit_fraction
from tools import protocol_rehearsal as J
from tools import protocol_rehearsal_torch as R


def test_tool_imports_no_jax():
    """The twin imports numpy, the standard library and the port, never jax,
    the JAX package or the JAX tool (h5py only where the cmr family writes
    its maps)."""
    import ast

    tree = ast.parse(open(R.__file__).read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    roots = {name.split(".")[0] for name in names}
    assert roots <= {"argparse", "json", "os", "subprocess", "sys", "numpy", "h5py",
                     "i2pnet_tpu_torch", "__future__"}, roots


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


@pytest.mark.parametrize("family", ["large", "cmr"])
def test_generators_write_jax_trees(family, tmp_path):
    import h5py

    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    for mod, root in zip((J, R), roots):
        os.makedirs(root)  # the tools' main makes the data dir first
        rng = np.random.default_rng(3)
        if family == "cmr":
            mod.gen_cmr_root(root, rng, frames_train=2, frames_test=1, n_points=600)
        else:
            mod.gen_large_root(root, rng, frames_train=2, frames_eval=1, n_points=600)
    names = _files(roots[0])
    assert names == _files(roots[1])
    kinds = {os.path.splitext(n)[1] for n in names}
    assert kinds == ({".npy", ".txt", ".h5"} if family == "cmr" else {".npy", ".txt"})
    for name in names:
        a, b = (os.path.join(r, name) for r in roots)
        if name.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        elif name.endswith(".h5"):
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                assert sorted(fa) == sorted(fb) == ["PC", "intensity"]
                for k in fa:
                    assert np.array_equal(fa[k][()], fb[k][()]), (name, k)
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), name


def test_cmr_generator_names_h5py_when_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="h5py"):
        R.gen_cmr_root(str(tmp_path), np.random.default_rng(0), 1, 1, 100)


def test_make_frame_projects_onto_lit_pixels(tmp_path):
    rng = np.random.default_rng(0)
    K, Pc4 = R._calib_mats(str(tmp_path))
    pc, img = R.make_frame(rng, K, Pc4, 2000)
    p_cam = Pc4[:3, :3] @ pc + Pc4[:3, 3:4]
    assert np.all(p_cam[2] > 1.0)
    uvw = K @ p_cam
    uv = (uvw[:2] / uvw[2]).T
    assert np.all(uv[:, 1] > R.CROP_TOP)
    assert _lit_fraction(img, uv, margin=0) > 0.95
    assert img.shape == (R.IMG_H_RAW, R.IMG_W_RAW, 3)


@pytest.mark.parametrize("family", ["cmr", "large"])
def test_generated_roots_consistent_through_port_loaders(tmp_path, family):
    """A frame loaded through the port's protocol loader, its cloud warped
    by the sample's ground truth, lands on lit pixels of its image."""
    rng = np.random.default_rng(1)
    root = str(tmp_path)
    if family == "cmr":
        from i2pnet_tpu_torch.data.kitti_odometry_cmr import KittiOdometryCMRDataset

        R.gen_cmr_root(root, rng, frames_train=0, frames_test=2, n_points=4000)
        ds = KittiOdometryCMRDataset(root, mode="test", sample_point=2048)
    else:
        from i2pnet_tpu_torch.data.kitti_large_range import KittiLargeRangeDataset

        R.gen_large_root(root, rng, frames_train=0, frames_eval=2, n_points=4000)
        ds = KittiLargeRangeDataset(root, mode="test", sample_point=4096, seqs=(7,))
    s = ds[0]
    q, t = s["decalib_real_gt"], s["decalib_dual_gt"]
    rot = M.quat_to_rotmat_batch(np.asarray(q)[None])[0]
    lidar = s["lidar"][:, :3]
    nz = np.abs(lidar).sum(axis=1) > 0
    cam = lidar[nz] @ rot.T + t
    uvw = cam @ np.asarray(s["init_intrinsic"]).T
    infront = uvw[:, 2] > 1.0
    uv = uvw[infront, :2] / uvw[infront, 2:3]
    frac = _lit_fraction(np.asarray(s["rgb"]), uv)
    assert frac > 0.8, f"{family}: only {frac:.2f} of points hit lit pixels"


def _info_dir(path, rng, count=6):
    """An evaluation's files: a metrics npz (1-D float arrays and one that
    is not) and a section-framed prediction.txt of count pairs."""
    os.makedirs(path)
    np.savez(os.path.join(path, "metrics_1.npz"), RRE=rng.uniform(0, 20, count),
             RTE=rng.uniform(0, 8, count), ids=np.arange(count))
    np.savez(os.path.join(path, "metrics_0.npz"), RRE=np.zeros(1), RTE=np.zeros(1))
    rows = []
    for i in range(count):
        rows.append(f"{SECTION} frame {i}")
        for name in ("init", "pred", "gt"):
            rv = rng.normal(scale=0.3, size=3)
            c, s = np.cos(rv[0]), np.sin(rv[0])
            E = np.hstack([np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]), rng.normal(size=(3, 1))])
            rows.append(f"{name} " + " ".join("%.9f" % v for v in E.reshape(-1)))
    with open(os.path.join(path, "prediction.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def test_summaries_match_jax(tmp_path):
    info = _info_dir(str(tmp_path / "info"), np.random.default_rng(4))
    got = R._summarize(info)
    assert got == J._summarize(info)
    assert set(got) == {"mean_RRE", "mean_RTE", "n_eval"} and got["n_eval"] == 6

    from i2pnet_tpu_torch.eval.analysis import parse_prediction_file

    mats = parse_prediction_file(os.path.join(info, "prediction.txt"))
    protocol = R.protocol_summary(info)
    for name, E in (("model", mats["pred"]), ("identity", mats["init"])):
        rre, rte = M.rte_rre(E, mats["gt"])
        assert protocol[name]["rte_mean"] == float(rte.mean())
        assert protocol[name]["rre_median"] == float(np.median(rre))
    assert protocol["n_eval"] == 6
