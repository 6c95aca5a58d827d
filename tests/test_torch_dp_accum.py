"""Data parallelism with gradient accumulation: each rank's microbatch k
must be its share of the global microbatch k.

The JAX package's DP step is its one-device step on the global batch, and
``make_accum_train_step`` cuts the global B into ``(accum_steps, B //
accum_steps)``: microbatch k is global rows ``[k*B/a, (k+1)*B/a)``, and its
BatchNorm and BatchStatsNorm statistics are taken over those rows. The
port loads on rank r the rows ``host_batch_rows`` gives (its share of each
global microbatch, in k order), and ``_make_step`` cuts the rank's rows
into ``a`` microbatches, so the all-reduced statistics of microbatch k are
over exactly JAX's rows.

- two gloo ranks (``tests/_torch_dp_worker.py``) with ``accum_steps=2`` on
  the tiny free and the tiny proj config (f32, dropout off, B=8) against the
  one-process accumulating step on the same global batch (itself held
  against JAX's in tests/test_torch_train_accum.py), at the f32 DP bars of
  tests/test_torch_dp_train.py: metrics rtol 1e-5 / atol 1e-6, each
  gradient within 1e-3 of its leaf's largest, the running statistics rtol
  1e-5 / atol 1e-6; the ranks' gradients bit-identical;
- the same step on each rank's contiguous rows (the grouping before
  ``host_batch_rows``: global microbatch 0 was rows 0, 1, 4 and 5) breaks
  those bars;
- ``host_batch_rows`` and ``BatchLoader(host_slice=rows)``; the
  ``Trainer``'s refusal where ``B % (accum_steps * world) != 0``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
from i2pnet_tpu_torch.data import BatchLoader
from i2pnet_tpu_torch.models import I2PNet, I2PNetProj, init_flax_
from i2pnet_tpu_torch.ops import quaternion as Q
from i2pnet_tpu_torch.parallel import distributed as D
from i2pnet_tpu_torch.train import create_train_state, make_accum_train_step
from _torch_dp_worker import spawn
from _torch_util import n, t
from test_torch_dp_train import ABSORBED

B, ACCUM = 8, 2
METRICS = ("loss", "loss_q", "loss_x", "sx", "sq")


def _batch(family):
    """B=8 seeded inputs, decalibrated by a known pose."""
    rng = np.random.default_rng(21)
    ang = 0.15
    q = np.tile(np.array([[np.cos(ang / 2), 0, np.sin(ang / 2), 0]], np.float32), (B, 1))
    tr = np.tile(np.array([[0.5, -0.2, 0.3]], np.float32), (B, 1))
    k = np.tile(np.array([[[64.0, 0, 64], [0, 64.0, 32], [0, 0, 1]]], np.float32), (B, 1, 1))
    rgb = rng.normal(size=(B, 64, 128, 3)).astype(np.float32)
    if family == "proj":
        raw = (rng.normal(size=(B, 512, 3)) * 10).astype(np.float32)
        raw[:, 256:] = 0.0
        lidar = n(Q.warp_points(t(raw), t(q), t(tr))) * (np.sum(raw**2, -1, keepdims=True) > 0)
        return {"rgb": rgb, "lidar": lidar.astype(np.float32), "raw_xyz": raw, "intrinsic": k,
                "decalib_q_gt": q, "decalib_t_gt": tr}
    lidar = rng.uniform(-10, 10, size=(B, I2PNetConfig.tiny().lidar_in_points, 3))
    lidar[..., 2] += 20.0
    return {"rgb": rgb, "lidar": lidar.astype(np.float32), "intrinsic": k,
            "decalib_q_gt": q, "decalib_t_gt": tr}


@functools.cache
def _single(family):
    """The family's tiny config (dropout off), its initial state and the
    one-process accumulating step on the whole batch."""
    Cfg, Model = (I2PNetProjConfig, I2PNetProj) if family == "proj" else (I2PNetConfig, I2PNet)
    cfg = dataclasses.replace(Cfg.tiny(), head_dropout_rate=0.0)
    model = init_flax_(Model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _batch(family)
    st = create_train_state(model, lr=1e-3, steps_per_epoch=10)
    step = make_accum_train_step(model, cfg, ACCUM, proj=family == "proj")
    metrics = step(st, {k: t(v) for k, v in batch.items()})
    return cfg, state, batch, {
        "metrics": metrics, "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
        "buffers": {k: b.clone() for k, b in model.named_buffers()}}


def _bars_broken(run, ref) -> list:
    """The f32 DP bars of tests/test_torch_dp_train.py that run breaks."""
    out = []
    if not all(np.allclose(n(run["metrics"][k]), n(ref["metrics"][k]), rtol=1e-5, atol=1e-6)
               for k in METRICS):
        out.append("metrics")
    for name, r in ref["grads"].items():
        if ABSORBED.search(name):
            continue
        scale = float(r.abs().max()) + 1e-12
        if float((run["grads"][name] - r).abs().max()) > 1e-3 * scale + 1e-6:
            out.append("gradients")
            break
    if not all(np.allclose(n(run["buffers"][k]), n(b), rtol=1e-5, atol=1e-6)
               for k, b in ref["buffers"].items()):
        out.append("statistics")
    return out


@pytest.mark.parametrize("family", ["free", "proj"])
def test_dp_accum_step_matches_one_process(family, tmp_path):
    cfg, state, batch, ref = _single(family)
    ranks = spawn(tmp_path, "accum_step", family, dataclasses.asdict(cfg), state, batch, 1e-3,
                  ACCUM)
    np.testing.assert_array_equal(ranks[0]["grouped"]["rows"], [0, 1, 4, 5])
    np.testing.assert_array_equal(ranks[1]["grouped"]["rows"], [2, 3, 6, 7])
    for r in ranks:
        assert _bars_broken(r["grouped"], ref) == []
    grouped = [r["grouped"] for r in ranks]
    for key in ("grads", "buffers"):
        assert all(torch.equal(a, grouped[1][key][k]) for k, a in grouped[0][key].items()), key
    # the grouping before: each rank's contiguous rows cut into microbatches
    broken = _bars_broken(ranks[0]["contiguous"], ref)
    assert "statistics" in broken and "gradients" in broken, broken


@pytest.mark.parametrize("B_,W,a", [(8, 1, 1), (8, 2, 1), (8, 2, 2), (16, 4, 2), (24, 2, 3),
                                    (8, 4, 2)])
def test_host_batch_rows_tile_each_microbatch(B_, W, a, monkeypatch):
    per_rank = []
    for rank in range(W):
        monkeypatch.setattr(D, "process_info", lambda: (rank, W))
        rows = D.host_batch_rows(B_, a)
        if a == 1:  # the slice's rows
            np.testing.assert_array_equal(rows, np.arange(B_)[D.host_batch_slice(B_)])
        per_rank.append(rows.reshape(a, -1))  # the rank's microbatches, as _make_step cuts them
    for k in range(a):
        got = np.sort(np.concatenate([r[k] for r in per_rank]))
        np.testing.assert_array_equal(got, np.arange(k * B_ // a, (k + 1) * B_ // a))


@pytest.mark.parametrize("B_,W,a", [(8, 3, 1), (8, 4, 4), (6, 2, 2)])
def test_host_batch_rows_refuse_uneven_microbatches(B_, W, a, monkeypatch):
    monkeypatch.setattr(D, "process_info", lambda: (0, W))
    with pytest.raises(ValueError, match=r"B % \(accum_steps \* world\) == 0"):
        D.host_batch_rows(B_, a)


class _Indexed:
    def __len__(self):
        return 24

    def __getitem__(self, i):
        return {"rgb": np.full((1, 1, 3), i, np.float32), "path_info": str(i)}


def test_batch_loader_takes_the_rows_in_their_order():
    rows = np.array([0, 1, 4, 5])
    loaders = [BatchLoader(_Indexed(), B, shuffle=True, seed=3, host_slice=h)
               for h in (None, rows)]
    for whole, mine in zip(*(list(ld) for ld in loaders)):
        np.testing.assert_array_equal(mine["rgb"], whole["rgb"][rows])


def test_trainer_refuses_uneven_microbatches_at_construction(tmp_path, monkeypatch):
    cfg = I2PNetProjConfig.tiny()
    model = I2PNetProj(cfg, device="cpu")
    monkeypatch.setattr(D, "process_info", lambda: (0, 2))
    from i2pnet_tpu_torch.train.trainer import Trainer

    with pytest.raises(ValueError, match=r"B % \(accum_steps \* world\) == 0: B 6, "
                                         r"accum_steps 2, world 2"):
        Trainer(model, cfg, [], log_dir=str(tmp_path / "log"), batch_size=6, proj=True,
                accum_steps=2, device="cpu")
    assert not (tmp_path / "log").exists()
