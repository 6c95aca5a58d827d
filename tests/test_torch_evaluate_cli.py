"""End to end on the CPU: the JAX package's ``evaluate.py`` on a JAX
checkpoint, then ``tools/jax_ckpt_to_torch.py``, then the port's
``evaluate_torch.py --device cpu --tiny`` on the same on-disk KITTI
large-range test tree (sequences 7 and 8, full-size 376x1241 images), a
2-stage cascade of ``i2pnet_proj`` at ``I2PNetProjConfig.tiny()``, batches
of 4 (the last ragged).

The second stage's log dir has no best snapshot, so both packages warn and
take its epoch checkpoint. Both runs evaluate the same samples (the init
and gt rows of the prediction files are equal) and count the same; out3
per sample agrees within 2e-4, the f32 bar of tests/test_torch_model.py.
The JAX run takes its proj levels' dense route (``interpret``), the route
the port takes at eval.
"""

import functools
import importlib.util
import os

import jax
import numpy as np
import pytest

import evaluate
import evaluate_torch
from i2pnet_tpu import metrics as JM
from i2pnet_tpu.config import I2PNetProjConfig as JaxProjConfig
from i2pnet_tpu.models import I2PNetProj as JaxI2PNetProj
from i2pnet_tpu.train import create_train_state
from i2pnet_tpu.train.checkpoint import CheckpointManager as JaxManager
from i2pnet_tpu_torch import cli
from i2pnet_tpu_torch import metrics as M
from i2pnet_tpu_torch.config import I2PNetProjConfig
from i2pnet_tpu_torch.eval import analysis
from i2pnet_tpu_torch.models import I2PNetProj
from i2pnet_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_data import write_large_range_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_jax_checkpoint_evaluates_through_the_port(tmp_path, monkeypatch):
    root = write_large_range_tree(str(tmp_path / "data"), (7, 8), 3, 3000, seed=5)
    model = JaxI2PNetProj(JaxProjConfig.tiny())
    rng = np.random.default_rng(0)
    shapes = [(1, 64, 128, 3), (1, 2048, 3), (1, 2048, 3)]
    args = [rng.normal(size=s).astype(np.float32) for s in shapes]
    args.append(np.array([[[64.0, 0, 64], [0, 64.0, 32], [0, 0, 1]]], np.float32))
    init = jax.jit(functools.partial(model.init, train=False))
    stages = [str(tmp_path / "stage_a"), str(tmp_path / "stage_b")]
    for key, log_dir in enumerate(stages):
        v = init(jax.random.key(key), *args)
        mgr = JaxManager(log_dir)
        mgr.save(7, create_train_state(model, v), meta={"epoch": 7})
        mgr.wait()
        if key == 0:
            mgr.save_best("model_rotation_best",
                          {"params": v["params"], "batch_stats": v.get("batch_stats", {})})
        mgr.close()

    common = ["--tiny", "--root_path", root, "--batch_size", "4", "--model_dir", *stages]
    monkeypatch.setenv("I2PNET_KNN_MODE", "exact")  # evaluate.py sets it; restored after
    # evaluate.py inits the model eagerly only for the variables' tree (the
    # checkpoints overwrite every value); the jitted init gives the same tree
    # without compiling each op on its own
    monkeypatch.setattr(JaxI2PNetProj, "init", lambda self, key, *a, train: init(key, *a))
    monkeypatch.setenv("I2PNET_PROJ_DENSE_EVAL", "interpret")
    jlog, plog = [], []
    _record(monkeypatch, JM, jlog)
    _record(monkeypatch, M, plog)
    jdir, pdir = str(tmp_path / "jax_eval"), str(tmp_path / "port_eval")
    with pytest.warns(UserWarning, match="best snapshot"):
        evaluate.main(common + ["--log_dir", jdir])

    assert _converter().convert(stages[0]) == {"steps": [7], "best": ["model_rotation_best"]}
    assert _converter().convert(stages[1]) == {"steps": [7], "best": []}
    assert sorted(os.listdir(os.path.join(stages[0], "torch", "best"))) == ["model_rotation_best.pt"]
    with pytest.warns(UserWarning, match="best snapshot"):
        summary = evaluate_torch.main(common + ["--log_dir", pdir, "--device", "cpu", "--analyze"])

    assert summary["count"] == 6 and np.isfinite(summary["rre_mean"])
    assert [a.shape for a in plog] == [a.shape for a in jlog] == [(4, 7), (2, 7)]
    assert float(np.abs(np.concatenate(plog) - np.concatenate(jlog)).max()) <= 2e-4
    ours = analysis.parse_prediction_file(os.path.join(pdir, "prediction.txt"))
    ref = analysis.parse_prediction_file(os.path.join(jdir, "prediction.txt"))
    assert ours["pred"].shape == ref["pred"].shape == (6, 3, 4)
    np.testing.assert_array_equal(ours["init"], ref["init"])
    np.testing.assert_array_equal(ours["gt"], ref["gt"])
    with open(os.path.join(pdir, "log_test.txt")) as f:
        assert "count=6" in f.read().split()


def test_evaluate_torch_refuses_what_is_not_ported(tmp_path):
    """--dp raises, naming its ROADMAP item (--vis_rate runs:
    tests/test_torch_visualize.py). The datasets once refused here build
    evaluate.py's test split (``cli.eval_split``), and --test_rt is read for
    kd_cmr_snr and nus_cmr_snr."""
    base = ["--model_dir", str(tmp_path), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="item 9"):
        evaluate_torch.main(base + ["--dp"])
    rt = str(tmp_path / "rt.csv")
    with open(rt, "w") as f:
        f.write("id,tx,ty,tz,rx,ry,rz\n0,1.0,2.0,-1.5,0.1,-0.05,0.02\n")
    for extra, cls, table in (
            (["--dataset", "kd_cmr_snr"], "KittiOdometryCMRDataset", None),
            (["--dataset", "nus_corr_nolidar"], "NuScenesLargeRangeDataset", None),
            (["--dataset", "kd_cmr_snr", "--test_rt", rt], "KittiOdometryCMRDataset",
             [[0.1, -0.05, 0.02, 1.0, 2.0, -1.5]])):
        args = evaluate_torch.parse_args(base + extra + ["--root_path", str(tmp_path)])
        ds = cli.eval_split(args, None)
        assert type(ds).__name__ == cls and ds.mode == "test" and len(ds) == 0
        if table is not None:
            np.testing.assert_array_equal(ds.test_RT, table)
    # --efgh needs --dataset kitti and the free-point network, as evaluate.py
    for extra in (["--efgh"], ["--efgh", "--dataset", "kitti"]):
        with pytest.raises(SystemExit, match="--efgh needs"):
            evaluate_torch.main(base + extra)
    # the same flags and defaults as evaluate.py, and --device (the card)
    assert evaluate_torch.parse_args(["--model_dir", "x"]).device == "cuda"
    for flag, value in vars(evaluate.parse_args(["--model_dir", "x"])).items():
        assert getattr(evaluate_torch.parse_args(["--model_dir", "x"]), flag) == value, flag


def test_evaluate_torch_takes_test_rt_on_kd_corr_nolidar(tmp_path):
    """evaluate.py accepts --test_rt on kd_corr_nolidar and ignores it (its
    large-range loader draws the decalibrations): the port runs the
    protocol the same way and warns that the loader does not read it."""
    root = write_large_range_tree(str(tmp_path / "data"), (7, 8), 1, 3000, seed=5)
    run = str(tmp_path / "run")
    model = I2PNetProj(I2PNetProjConfig.tiny(), device="cpu")
    CheckpointManager(run).save_best("model_rotation_best", {"model": model.state_dict()})
    with pytest.warns(UserWarning, match="does not read it"):
        summary = evaluate_torch.main(["--tiny", "--root_path", root, "--model_dir", run,
                                       "--device", "cpu", "--batch_size", "2", "--test_rt",
                                       str(tmp_path / "rt.csv"),
                                       "--log_dir", str(tmp_path / "eval")])
    assert summary["count"] == 2 and np.isfinite(summary["rre_mean"])
