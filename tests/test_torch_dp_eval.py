"""The port's data-parallel evaluation and training entry points on the
CPU, two gloo ranks (``tests/_torch_dp_worker.py``, spawned once a test).

- the DP ``Evaluator``: a 2-stage cascade of each tiny config in f32 over 7
  samples in batches of 3 (3, 3, 1: a ragged batch, 2 rows and 1 repeated,
  and a batch with fewer rows than ranks, where rank 1 holds only a
  repeat), against the JAX package's and the port's single-process
  evaluators. The free family against JAX's ``Evaluator(mesh=...)`` on a
  2-device mesh; the proj family against JAX's single-device evaluator:
  JAX's pad-and-trim lets the repeated rows into its proj batch
  statistics on a ragged batch (ADVICE.md round 5), where the port's
  fan-out counts the real rows alone, so the port's ``--dp`` is JAX's
  single-device evaluator there. out3 within 2e-4 of JAX's (the bar of
  tests/test_torch_eval.py) and of the port's single process bit for bit
  (free: no batch-wide statistic at eval) or within 1e-4 (proj: the
  statistics sum in another order), prediction.txt's sections in the same
  count and order, rank 0's files alone. The free ranks' cv1 calls (a
  bf16 forward of a tiny config whose cost volume fuses cv1) are
  bit-identical to the single-process calls on the same
  rows: nothing batch-wide reaches cv1.
- ``train_torch.py`` at W = 2: two steps of the tiny proj config on a
  KITTI large-range tree, then ``--resume``: one file set, that of a
  single-process run, the ranks' parameters bit-identical.
- ``evaluate_torch.py --dp`` on that run's log dir, started as torchrun
  starts it (the group joined and left by the entry point): rank 0's files
  and summary those of the single process, rank 1 silent.
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

import evaluate_torch
import train_torch
from i2pnet_tpu import metrics as JM
from i2pnet_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from i2pnet_tpu.eval import Evaluator as JaxEvaluator
from i2pnet_tpu.parallel import make_mesh as jax_make_mesh
from i2pnet_tpu_torch import metrics as M
from i2pnet_tpu_torch.data import BatchLoader
from i2pnet_tpu_torch.eval import Evaluator, analysis
from i2pnet_tpu_torch.models import init_flax_
from i2pnet_tpu_torch.ops import cv_cuda
from i2pnet_tpu_torch.parallel import Mesh, fan_out_rows
from _torch_dp_worker import build_model, spawn
from _torch_util import port, randomize_stats, t
from test_torch_data import write_large_range_tree
from test_torch_eval import FAMILIES, MemoryDataset, _record

SAMPLES, BATCH = 7, 3


def _rank_mesh(rank):
    return Mesh(rank, 2, torch.device("cpu"))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dp_evaluator_matches_single_device(family, tmp_path, monkeypatch):
    jcfg, JaxModel, Cfg, Model, points, proj = FAMILIES[family]
    ds = MemoryDataset(SAMPLES, points, zero_tail=proj)
    s = ds[0]
    args = [s["rgb"][None], s["lidar"][None]] + ([s["raw_point_xyz"][None]] if proj else []) \
        + [s["init_intrinsic"][None]]
    jmodel = JaxModel(jcfg)
    init = jax.jit(functools.partial(jmodel.init, train=False))
    rng = np.random.default_rng(2)
    variables = [randomize_stats(init(jax.random.key(k), *args), rng) for k in (0, 1)]
    cfg = Cfg(**dataclasses.asdict(jcfg))
    models = [port(Model(cfg, device="cpu"), v) for v in variables]
    states = [m.state_dict() for m in models]

    # JAX: the free family on a 2-device mesh, the proj family on one device
    jlog, plog = [], []
    _record(monkeypatch, JM, jlog)
    monkeypatch.setenv("I2PNET_PROJ_DENSE_EVAL", "interpret")
    mesh = None if proj else jax_make_mesh(jax.devices()[:2])
    JaxEvaluator(jmodel, jcfg, [v["params"] for v in variables],
                 [v.get("batch_stats", {}) for v in variables], proj=proj,
                 log_dir=str(tmp_path / "jax"), mesh=mesh).validate(
        JaxBatchLoader(ds, BATCH, shuffle=False, drop_last=False))
    # the port in one process
    _record(monkeypatch, M, plog)
    single_dir = str(tmp_path / "single")
    Evaluator(models, cfg, proj=proj, log_dir=single_dir, device="cpu").validate(
        BatchLoader(ds, BATCH, shuffle=False, drop_last=False))
    monkeypatch.undo()

    cv1_model = None
    if not proj:  # cv1 fuses in bf16 where mlp1 has 3 layers and mlp2 2
        bf_cfg = dataclasses.asdict(dataclasses.replace(
            cfg, compute_dtype="bfloat16", cost_volume_mlps=((16, 16, 16), (16, 16))))
        bf = init_flax_(build_model("free", bf_cfg), torch.Generator().manual_seed(3)).eval()
        assert bf.cost_volume1.fuses_cv1()
        cv1_model = (bf_cfg, bf.state_dict())
    ranks = spawn(tmp_path, "evaluator", family, dataclasses.asdict(cfg), states, ds, BATCH,
                  cv1_model)

    lead, other = ranks
    assert other["summary"] is None and other["scored"] == [] and other["files"] == []
    assert sorted(f for f in lead["files"] if not f.startswith("metrics_")) == \
        ["log_test.txt", "prediction.txt"]
    assert sum(f.startswith("metrics_") for f in lead["files"]) == 1
    assert lead["summary"]["count"] == SAMPLES
    shapes = [(3, 7), (3, 7), (1, 7)]
    assert [a.shape for a in lead["scored"]] == [a.shape for a in jlog] == shapes
    out3 = np.concatenate(lead["scored"])
    assert float(np.abs(out3 - np.concatenate(jlog)).max()) <= 2e-4
    single = np.concatenate(plog)
    gap = float(np.abs(out3 - single).max())
    # free: no batch-wide statistic at eval, so the fan-out is exact; proj:
    # the statistics sum in another order, which the second stage carries
    # (2.2e-5 measured)
    assert gap == 0.0 if not proj else gap <= 1e-4, gap

    with open(os.path.join(single_dir, "prediction.txt")) as f:
        single_pred = f.read()
    heads = [[line for line in text.splitlines() if line.startswith("§")]
             for text in (lead["prediction"], single_pred)]
    assert heads[0] == heads[1] and len(heads[0]) == SAMPLES
    ours = analysis.parse_prediction_file(os.path.join(single_dir, "prediction.txt"))
    path = tmp_path / "dp_prediction.txt"
    path.write_text(lead["prediction"])
    dp = analysis.parse_prediction_file(str(path))
    np.testing.assert_array_equal(dp["init"], ours["init"])
    np.testing.assert_array_equal(dp["gt"], ours["gt"])

    if not proj:
        # each rank's cv1 calls against the single-process calls on its rows
        calls = []
        monkeypatch.setattr(cv_cuda, "cv1",
                            lambda *ops: calls.append(cv_cuda.cv1_plain(*ops)) or calls[-1])
        first = {k: np.stack([ds[i][k] for i in range(BATCH)])
                 for k in ("rgb", "lidar", "init_intrinsic", "raw_point_xyz")}
        for rank, r in enumerate(ranks):
            idx, _ = fan_out_rows(BATCH, _rank_mesh(rank))
            calls.clear()
            with torch.no_grad():
                bf(*(t(first[k][idx]) for k in ("rgb", "lidar", "init_intrinsic")),
                   raw_xyz=t(first["raw_point_xyz"][idx]))
            assert len(calls) == len(r["cv1"]) == 1
            assert torch.equal(calls[0], r["cv1"][0][1])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """tests/test_torch_train_cli.py's tree: 8 training pairs, 2 in
    validation."""
    return write_large_range_tree(str(tmp_path_factory.mktemp("kitti_large")), (0, 1, 7, 8, 9),
                                  2, 3000, seed=5)


def _files(root):
    """The files under root (TensorBoard's event files by their prefix:
    their names carry the time)."""
    out = set()
    for d, _, names in os.walk(root):
        out |= {os.path.relpath(os.path.join(d, f.split(".out.tfevents")[0]), root)
                for f in names}
    return out


def _train_args(tree):
    return ["--dataset", "kd_corr_nolidar", "--network", "i2pnet_proj", "--tiny",
            "--root_path", tree, "--batch_size", "4", "--save_rate", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def single_run(tree, tmp_path_factory):
    """train_torch.py in one process for one epoch: its log dir and update
    count."""
    log_dir = str(tmp_path_factory.mktemp("single"))
    trainer = train_torch.main(_train_args(tree) + ["--log_dir", log_dir, "--max_epoch", "1"])
    trainer.writer.close()
    return log_dir, trainer.state.step


def test_train_torch_on_two_ranks(tree, single_run, tmp_path):
    dp_dir, (single_dir, single_step) = str(tmp_path / "dp"), single_run
    args = _train_args(tree) + ["--log_dir", dp_dir]
    ranks = spawn(tmp_path, "train_cli", args + ["--max_epoch", "1"],
                  args + ["--max_epoch", "2", "--resume"])

    first, resumed = ranks[0]
    # 8 training pairs, a global batch of 4: 2 steps an epoch
    assert first["step"] == single_step == 2
    assert resumed["start_epoch"] == 1 and resumed["step"] == 4
    for a, b in zip(ranks[0], ranks[1]):
        assert a["step"] == b["step"]
        assert all(torch.equal(p, b["params"][k]) for k, p in a["params"].items())
    # rank 0 alone wrote: the single process's file set, a record a step
    files = _files(dp_dir)
    assert {f for f in files if not f.startswith("torch/ckpt/")} == \
        {f for f in _files(single_dir) if not f.startswith("torch/ckpt/")}
    assert {f for f in files if f.startswith("torch/ckpt/")} == {"torch/ckpt/0.pt",
                                                                "torch/ckpt/1.pt"}
    with open(os.path.join(dp_dir, "log.txt")) as f:
        assert [line.split()[:4] for line in f] == [["epoch", str(i // 2), "iter", str(i + 1)]
                                                    for i in range(4)]


def test_evaluate_torch_dp_on_two_ranks(tree, single_run, tmp_path):
    """evaluate_torch.py --dp as torchrun starts it: each rank joins the
    group from the environment and leaves it; rank 0 alone writes and
    returns the summary, which equals the single process's; its files are
    the single process's, prediction.txt's sections in the same order.
    The test split's 4 pairs in batches of 3: a ragged batch and one with
    fewer rows than ranks. The tiny proj cascade in f32, out3 within the
    fan-out's 1e-4 (its statistics sum in another order)."""
    model_dir, _ = single_run
    argv = ["--dataset", "kd_corr_nolidar", "--network", "i2pnet_proj", "--tiny",
            "--root_path", tree, "--model_dir", model_dir, model_dir, "--batch_size", "3",
            "--device", "cpu"]
    ranks = spawn(tmp_path, "evaluate_cli", argv, join=False)
    single_dir = str(tmp_path / "single_eval")
    single = evaluate_torch.main(argv + ["--log_dir", single_dir])

    lead, other = ranks
    assert lead["left"] and other["left"]
    assert other["summary"] is None and other["files"] == []
    # the metrics npz is named by the time it was written
    names = [[n.split("_")[0] if n.startswith("metrics_") else n for n in files]
             for files in (lead["files"], sorted(os.listdir(single_dir)))]
    assert names[0] == names[1] == ["log_test.txt", "metrics", "prediction.txt"]
    assert lead["summary"]["count"] == single["count"] == 4
    assert set(lead["summary"]) == set(single)
    for k, v in single.items():
        if k not in ("mean_time_s", "mean_fps", "timing_includes_compile"):
            assert lead["summary"][k] == pytest.approx(v, rel=1e-4), k
    ours = analysis.parse_prediction_file(os.path.join(single_dir, "prediction.txt"))
    dp_pred = os.path.join(tmp_path, "dp_evaluate_cli", "rank0", "eval", "prediction.txt")
    dp = analysis.parse_prediction_file(dp_pred)
    np.testing.assert_array_equal(dp["init"], ours["init"])
    np.testing.assert_array_equal(dp["gt"], ours["gt"])
    assert float(np.abs(dp["pred"] - ours["pred"]).max()) <= 1e-4
    heads = []
    for path in (dp_pred, os.path.join(single_dir, "prediction.txt")):
        with open(path) as f:
            heads.append([line for line in f if line.startswith("§")])
    assert heads[0] == heads[1] and len(heads[0]) == 4
