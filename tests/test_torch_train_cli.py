"""The port's training entry point on the CPU.

- ``train_torch.py --device cpu --tiny`` on a KITTI large-range tree
  (tests/test_torch_data.py's) writes the JAX trainer's artifact set, and
  ``evaluate_torch.py --device cpu`` reads the run back: the CPU rehearsal
  of the card's phase 18.
- ``train_torch.py`` takes ``train.py``'s flags with its defaults, plus
  ``--device`` (the card); builds every dataset as ``train.py`` does;
  refuses ``--efgh`` off the kitti dataset; raises without a
  card unless ``--device cpu``; ``--debug_nans`` stops on a non-finite
  step.
- ``cli.build`` draws fresh weights with the JAX package's initial
  distribution (flax's defaults).
- ``UniWriter``, ``AverageMeter`` and ``Timings`` against the JAX
  package's on the same calls.
"""

import json
import os
import tarfile
import time
import types

import jax
import numpy as np
import pytest
import torch

import evaluate_torch
import train
import train_torch
from i2pnet_tpu.config import I2PNetConfig as JaxConfig
from i2pnet_tpu.config import I2PNetProjConfig as JaxProjConfig
from i2pnet_tpu.models import I2PNet as JaxI2PNet
from i2pnet_tpu.models import I2PNetProj as JaxI2PNetProj
from i2pnet_tpu.utils.avgmeter import AverageMeter as JaxAverageMeter
from i2pnet_tpu.utils.monitor import UniWriter as JaxUniWriter
from i2pnet_tpu.utils.timings import Timings as JaxTimings
from i2pnet_tpu_torch import cli
from i2pnet_tpu_torch.convert import flax_to_state_dict
from i2pnet_tpu_torch.data import KittiLargeRangeDataset, NuScenesLargeRangeDataset
from i2pnet_tpu_torch.train.trainer import Trainer
from i2pnet_tpu_torch.utils.avgmeter import AverageMeter
from i2pnet_tpu_torch.utils.monitor import UniWriter
from i2pnet_tpu_torch.utils.timings import Timings
from test_monitor import _FakeTB, _FakeWandbRun
from test_torch_data import write_large_range_tree

TINY_PROJ = ["--dataset", "kd_corr_nolidar", "--network", "i2pnet_proj", "--tiny"]
BESTS = ["model_msee_best.pt", "model_rotation_best.pt", "model_transition_best.pt"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Sequences 0, 1, 7, 8 and 9, 2 frames each: the training split holds
    0-8, validation 9 and the test split 7-8."""
    return write_large_range_tree(str(tmp_path_factory.mktemp("kitti_large")), (0, 1, 7, 8, 9),
                                  2, 3000, seed=5)


def test_train_torch_writes_the_artifacts_and_evaluate_torch_reads_them(tree, tmp_path):
    log_dir, eval_dir = str(tmp_path / "run"), str(tmp_path / "eval")
    args = TINY_PROJ + ["--root_path", tree, "--log_dir", log_dir, "--batch_size", "2",
                        "--save_rate", "1", "--device", "cpu"]
    trainer = train_torch.main(args + ["--max_epoch", "1"])
    assert {"config.json", "metrics.jsonl", "log.txt", "log_rotate.txt", "log_trans.txt",
            "src_snapshot.tar.gz"} <= set(os.listdir(log_dir))
    assert os.listdir(os.path.join(log_dir, "torch", "ckpt")) == ["0.pt"]
    assert sorted(os.listdir(os.path.join(log_dir, "torch", "best"))) == BESTS
    with open(os.path.join(log_dir, "config.json")) as f:
        run = json.load(f)
    assert run["proj"] and run["flags"]["device"] == "cpu" and run["batch_size"] == 2
    with tarfile.open(os.path.join(log_dir, "src_snapshot.tar.gz")) as tar:
        names = tar.getnames()
    assert "i2pnet_tpu_torch/train/trainer.py" in names
    assert "i2pnet_tpu_torch/csrc/conv_train.cu" in names
    assert not any(name.endswith(".pyc") for name in names)
    with open(os.path.join(log_dir, "log.txt")) as f:
        # training sequences 0-8 hold 0, 1, 7 and 8 here: 8 pairs, 4 steps
        assert [line.split()[:4] for line in f] == [["epoch", "0", "iter", str(i)]
                                                    for i in range(1, 5)]

    # resume one more epoch: the counters and the optimizer come back
    resumed = train_torch.main(args + ["--max_epoch", "2", "--resume"])
    assert resumed.start_epoch == 1 and resumed.state.step == 8 == 2 * trainer.state.step
    assert resumed.ckpt.all_steps() == [0, 1]

    summary = evaluate_torch.main(["--tiny", "--root_path", tree, "--model_dir", log_dir,
                                   "--device", "cpu", "--batch_size", "2",
                                   "--log_dir", eval_dir])
    assert summary["count"] == 4 and np.isfinite(summary["rre_mean"])
    assert os.path.exists(os.path.join(eval_dir, "prediction.txt"))


def test_train_torch_flags_match_train_py():
    ours, ref = vars(train_torch.parse_args([])), vars(train.parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ours == ref


@pytest.mark.parametrize("extra,error,match", [
    (["--dataset", "kd_cmr_snr"], None, "KittiOdometryCMRDataset"),
    (["--dataset", "nus_cmr_snr"], None, "NuScenesCMRDataset"),
    (["--efgh"], SystemExit, "--efgh needs"),
    (["--dataset", "nus_corr_nolidar"], None, "NuScenesLargeRangeDataset")])
def test_train_torch_refuses_what_is_not_ported(extra, error, match, tmp_path):
    """--efgh off the kitti dataset exits, as train.py does. The datasets
    once refused here build as train.py builds them: the same class and
    training split, with the same image size and point budget, and no
    validation split."""
    base = ["--dataset", "kd_corr_nolidar", "--device", "cpu", "--log_dir", str(tmp_path)]
    if error is not None:
        with pytest.raises(error, match=match):
            train_torch.main(base + extra)
        return
    args = train_torch.parse_args(base + extra + ["--root_path", str(tmp_path)])
    ours, ref = cli.build_datasets(args, None), train.build(argparse_namespace(args))[3:]
    assert type(ours[0]).__name__ == type(ref[0]).__name__ == match
    assert ours[1] is None and ref[1] is None
    assert (ours[0].mode, ours[0].img_H, ours[0].img_W, ours[0].sample_point) == \
        (ref[0].mode, ref[0].img_H, ref[0].img_W, ref[0].sample_point) == \
        ("train", *((384, 1280, 8192) if match == "KittiOdometryCMRDataset" else
                    (640, 1280, 8192) if match == "NuScenesCMRDataset" else (160, 512, 150000)))


def test_train_torch_class_target_needs_mask_heads(tree, tmp_path):
    """--train_target class runs the mask-only loss; the CLI's configs have
    no mask head, so the first step raises as JAX's step does."""
    with pytest.raises(ValueError, match="needs mask heads"):
        train_torch.main(["--dataset", "kd_corr_nolidar", "--network", "i2pnet", "--tiny",
                          "--root_path", tree, "--device", "cpu", "--log_dir", str(tmp_path),
                          "--batch_size", "2", "--max_epoch", "1", "--train_target", "class"])


def test_train_torch_runs_on_the_card_unless_asked(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_torch.main(TINY_PROJ + ["--root_path", tree, "--log_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Timings("cuda")


def test_debug_nans_stops_on_the_first_non_finite_step(tree, tmp_path):
    args = train_torch.parse_args(TINY_PROJ + ["--root_path", tree, "--device", "cpu"])
    model, cfg, proj = cli.build(args)
    with torch.no_grad():
        model.sx.fill_(float("nan"))
    train_ds, valid_ds = cli.build_datasets(args, cfg)
    trainer = Trainer(model, cfg, train_ds, valid_ds, log_dir=str(tmp_path), batch_size=2,
                      epochs=1, proj=proj, device="cpu", debug_nans=True)
    with pytest.raises(FloatingPointError, match="after update 1"):
        trainer.train()


def test_build_datasets_matches_train_py(tree):
    """The same splits as train.py builds (train 0-8, val 9-10) with the
    tiny crop; the first sample of each equal key for key."""
    args = train_torch.parse_args(TINY_PROJ + ["--root_path", tree, "--color_augment"])
    ours = cli.build_datasets(args, None)
    ref = train.build(argparse_namespace(args))[3:]
    for a, b in zip(ours, ref):
        assert len(a) == len(b) > 0
        assert (a.color_augment, a.img_H, a.sample_point) == (b.color_augment, b.img_H,
                                                              b.sample_point)
        x, y = a[0], b[0]
        for key, value in y.items():
            np.testing.assert_array_equal(np.asarray(x[key]), np.asarray(value), err_msg=key)
    assert isinstance(ours[0], KittiLargeRangeDataset)
    # a root without nuScenes split lists gives an empty training split, as
    # train.py's glob does
    nus, valid = cli.build_datasets(
        train_torch.parse_args(["--dataset", "nus_corr_nolidar", "--root_path", tree]), None)
    assert isinstance(nus, NuScenesLargeRangeDataset) and len(nus) == 0 and valid is None


def argparse_namespace(args):
    import argparse

    return argparse.Namespace(**{k: v for k, v in vars(args).items() if k != "device"})


@pytest.mark.parametrize("network", ["i2pnet", "i2pnet_proj"])
def test_build_starts_from_the_jax_initial_distribution(network):
    """Every leaf that flax initialises to a constant (biases, norms'
    shifts and scales, running statistics) holds it; every kernel is a
    normal truncated at 2 std with variance 1 / fan_in, as flax's
    lecun_normal draws it (the std within 10% where the kernel has 4000 or
    more entries; every entry within 2 std); the same seed gives the same
    weights."""
    args = train_torch.parse_args(["--network", network, "--tiny", "--device", "cpu"])
    model = cli.build(args)[0]
    proj = network == "i2pnet_proj"
    jm = (JaxI2PNetProj(JaxProjConfig.tiny()) if proj else JaxI2PNet(JaxConfig.tiny()))
    shapes = [(1, 64, 128, 3), (1, 512, 3)] + ([(1, 512, 3)] if proj else [])
    inputs = [np.ones(s, np.float32) for s in shapes]
    inputs.append(np.array([[[64.0, 0, 64], [0, 64.0, 32], [0, 0, 1]]], np.float32))
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, dict(jax.jit(
        jm.init, static_argnames="train")(jax.random.key(0), *inputs, train=False))))
    ours = model.state_dict()
    assert set(ours) == set(ref)
    for name, r in ref.items():
        r, got = r.numpy(), ours[name].numpy()
        if name.endswith("weight") and r.ndim > 1:
            std = r[0].size ** -0.5
            assert np.abs(got).max() <= 2 * std / 0.87962566103423978 + 1e-6, name
            if r.size >= 4000:
                for w in (got, r):
                    assert abs(w.std() / std - 1) < 0.1, name
        else:
            np.testing.assert_array_equal(got, r, err_msg=name)
    again = cli.build(args)[0].state_dict()
    assert all(torch.equal(again[k], v) for k, v in ours.items())


# ---- utils against the JAX package's --------------------------------------

class _FakeRun(_FakeWandbRun):
    """test_monitor.py's fake wandb run, also recording config updates."""

    def __init__(self):
        super().__init__()
        self.configs = []
        self.config = types.SimpleNamespace(update=self.configs.append)


@pytest.fixture
def writers(tmp_path):
    out = []
    for cls, sub in ((UniWriter, "port"), (JaxUniWriter, "jax")):
        w = cls(str(tmp_path / sub), enable_tb=False)
        w._tb, w._wandb = _FakeTB(), _FakeRun()
        out.append(w)
    yield out
    for w in out:
        w._wandb = None
        w.close()


def test_uniwriter_matches_jax(writers, tmp_path):
    ours, ref = writers
    for w, value in ((ours, torch.tensor(2.5)), (ref, np.float32(2.5))):
        w.config({"config": {"a": (1, 2)}, "lr": 1e-3, "flags": {"x": None}})
        w.add_scalar("train/loss", 1.5, 3)
        w.add_scalar("train/loss_q", value, 4)
        w.add_scalar("val/acc", np.float64(0.25), 0)
        w.text_log("log.txt", "epoch 0 iter 1 loss 1.500000\n")
    assert ours._tb.scalars == ref._tb.scalars and ours._wandb.configs == ref._wandb.configs
    assert ours._wandb.logged == ref._wandb.logged and len(ours._wandb.logged) == 3
    for name in ("config.json", "log.txt"):
        with open(tmp_path / "port" / name) as f, open(tmp_path / "jax" / name) as g:
            assert f.read() == g.read(), name
    records = []
    for sub in ("port", "jax"):
        with open(tmp_path / sub / "metrics.jsonl") as f:
            records.append([{k: v for k, v in json.loads(line).items() if k != "ts"}
                            for line in f])
    assert records[0] == records[1] and len(records[0]) == 3


def test_average_meter_matches_jax():
    ours, ref = AverageMeter(), JaxAverageMeter()
    for val, n in ((1.0, 1), (3.5, 4), (-2.0, 2)):
        ours.update(val, n)
        ref.update(val, n)
        assert vars(ours) == vars(ref)
    ours.reset()
    ref.reset()
    assert vars(ours) == vars(ref)


def test_timings_match_jax(monkeypatch):
    """The same checkpoints on a scripted clock give the same counts, means
    and standard deviations, and the same summary text."""
    ticks = iter(np.cumsum([0.5, 0.25, 1.0, 0.125, 2.0, 0.5, 0.75] * 2).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    ours, ref = Timings("cpu"), JaxTimings()
    for timer, value in ((ours, torch.ones(2)), (ref, jax.numpy.ones(2))):
        timer.time("first")  # no previous checkpoint: starts the chain
        timer.time("load", value)
        timer.time("step")
        timer.time("load")
        timer.reset()
        timer.time("step", value)
        timer.time("step")
    assert ours.summary() == ref.summary()
    assert str(ours) == str(ref)
    assert ours.summary()["step"]["count"] == 3
