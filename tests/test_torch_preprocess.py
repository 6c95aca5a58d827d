"""The port's fixed-decalibration tables (``i2pnet_tpu_torch/data/preprocess.py``)
against the JAX package's, on the CPU.

- ``generate_test_rt``: equal bit for bit over seeds, sizes and both
  ``clip_tz``.
- ``load_test_rt``: equal to JAX's (which reads CSVs with pandas) on every
  format: the reference's ``id,tx,ty,tz,rx,ry,rz`` header, headerless 6 and 7
  columns, named columns in another order, another 7-column header, and
  the per-seed pickles of 6- and 7-wide rows; both raise on 5 columns.
- ``cmr_seed_value`` and ``cmr_test_rt_path`` over the ten seeds.
- Importing the port's module leaves pandas unimported (a subprocess).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from i2pnet_tpu.data import preprocess as JP
from i2pnet_tpu_torch.data import preprocess as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("clip_tz", [False, True])
@pytest.mark.parametrize("n,seed", [(1, 0), (16, 3), (1101, 9)])
def test_generate_test_rt_matches_jax(n, seed, clip_tz):
    for max_r, max_t in ((10.0, 2.0), (5.0, 0.5)):
        ours = P.generate_test_rt(n, max_r_deg=max_r, max_t=max_t, seed=seed, clip_tz=clip_tz)
        ref = JP.generate_test_rt(n, max_r_deg=max_r, max_t=max_t, seed=seed, clip_tz=clip_tz)
        assert ours.dtype == ref.dtype == np.float64 and ours.shape == (n, 6)
        np.testing.assert_array_equal(ours, ref)
    if clip_tz:  # tz capped at min(max_t, 1 m)
        assert ours[:, 5].max() <= 0.5
        assert P.generate_test_rt(n, seed=seed, clip_tz=True)[:, 5].max() <= 1.0


def _table(seed=0, n=12):
    rng = np.random.default_rng(seed)
    rt = np.concatenate([rng.uniform(-0.2, 0.2, (n, 3)), rng.uniform(-2, 2, (n, 3))], 1)
    return rt, np.arange(n)[:, None]


def _write(path, header, rows):
    with open(path, "w") as f:
        if header is not None:
            f.write(header + "\n")
        for row in rows:
            f.write(",".join(repr(float(v)) for v in row) + "\n")


def _formats(tmp_path):
    """(name, path) of every table format, all holding the same rows."""
    rt, ids = _table()
    t_first = np.concatenate([ids, rt[:, 3:], rt[:, :3]], 1)  # id, tx..tz, rx..rz
    out = []

    def csv(name, header, rows):
        path = str(tmp_path / f"{name}.csv")
        _write(path, header, rows)
        out.append((name, path))

    csv("reference_header", "id,tx,ty,tz,rx,ry,rz", t_first)
    csv("spaced_header", " ID , tx, ty, tz, rx, ry, rz", t_first)
    csv("headerless_6", None, rt)
    csv("headerless_7", None, t_first)
    order = [4, 1, 5, 0, 3, 2]  # ty, ry, tz, rx, tx, rz
    names = np.array(["rx", "ry", "rz", "tx", "ty", "tz"])[order]
    csv("shuffled_names", ",".join(names), rt[:, order])
    csv("other_header_7", "a,b,c,d,e,f,g", t_first)
    csv("other_header_6", "a,b,c,d,e,f", rt)
    for name, rows in (("pickle_6", rt.tolist()), ("pickle_7", t_first.tolist())):
        path = str(tmp_path / f"{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump(rows, f)
        out.append((name, path))
    return rt, out


def test_load_test_rt_matches_jax_on_every_format(tmp_path):
    rt, formats = _formats(tmp_path)
    for name, path in formats:
        ours, ref = P.load_test_rt(path), JP.load_test_rt(path)
        assert ours.dtype == ref.dtype == np.float64, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)
        np.testing.assert_allclose(ours, rt, rtol=0, atol=1e-15, err_msg=name)
    assert len(formats) == 9


def test_load_test_rt_raises_where_jax_raises(tmp_path):
    rows = np.random.default_rng(1).uniform(-1, 1, (4, 5))
    for header in (None, "a,b,c,d,e"):
        path = str(tmp_path / f"five_{header is None}.csv")
        _write(path, header, rows)
        for load in (P.load_test_rt, JP.load_test_rt):
            with pytest.raises(ValueError, match="expected 6"):
                load(path)
    path = str(tmp_path / "five.pkl")
    with open(path, "wb") as f:
        pickle.dump(rows.tolist(), f)
    for load in (P.load_test_rt, JP.load_test_rt):
        with pytest.raises(ValueError, match="expected 6"):
            load(path)


def test_cmr_seed_tags_and_paths_match_jax(tmp_path):
    assert [P.cmr_seed_value(s) for s in range(10)] == [0, 5, 0, 50, 0, 500, 0, 5000, 0, 50000]
    for seed in range(10):
        assert P.cmr_seed_value(seed) == JP.cmr_seed_value(seed)
        for seq, r, t in (("00", 10.0, 2.0), ("03", 5.0, 0.5)):
            assert (P.cmr_test_rt_path(str(tmp_path), seq, r, t, seed)
                    == JP.cmr_test_rt_path(str(tmp_path), seq, r, t, seed))
    assert os.path.basename(P.cmr_test_rt_path("d", "00", 10.0, 2.0, 3)) == \
        "test_RT_seq00_10.00_2.00_50.pkl"


def test_preprocess_imports_no_pandas():
    """The port's table helpers (and the data package, the CLIs' factory)
    import neither pandas nor h5py nor PIL."""
    probe = ("import sys\n"
             "import i2pnet_tpu_torch.data.preprocess, i2pnet_tpu_torch.data, i2pnet_tpu_torch.cli\n"
             "bad = [m for m in ('pandas', 'h5py', 'PIL', 'cv2', 'jax') if m in sys.modules]\n"
             "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
