"""The port's training slice against the JAX package's, on the CPU (the
accumulation step against JAX's is in ``test_torch_train_accum.py``).

- With ``accum_steps=1`` the step is bit-identical to the plain step, both
  families, dropout on; with 2 the metrics are the microbatches' mean and
  the running statistics move microbatch by microbatch; B not divisible
  raises. A step's sx and sq metrics are the values its loss used.
- A checkpoint round trip: save, restore into a fresh state, and the next
  step is bit-identical to continuing; a model-only checkpoint still loads
  for inference and refuses to resume.
- The port's ``Trainer`` against JAX's ``Trainer`` on a KITTI large-range
  tree (tests/test_torch_data.py's), the tiny proj config in f32, dropout
  0, B=2, one epoch: the per-step losses, the validation dict, the best
  snapshots and the text logs; then each resumes for a second epoch, JAX
  from its orbax checkpoint and the port from ``tools/jax_ckpt_to_torch.py``'s
  conversion of it (weights and Adam moments), and the losses agree again.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from i2pnet_tpu.config import I2PNetConfig as JaxConfig
from i2pnet_tpu.config import I2PNetProjConfig as JaxProjConfig
from i2pnet_tpu.data.kitti_large_range import KittiLargeRangeDataset as JaxLargeRange
from i2pnet_tpu.models import I2PNet as JaxI2PNet
from i2pnet_tpu.models import I2PNetProj as JaxI2PNetProj
from i2pnet_tpu.train.trainer import Trainer as JaxTrainer
from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
from i2pnet_tpu_torch.convert import load_flax_variables
from i2pnet_tpu_torch.data import KittiLargeRangeDataset
from i2pnet_tpu_torch.models import I2PNet, I2PNetProj
from i2pnet_tpu_torch.ops import quaternion as TQ
from i2pnet_tpu_torch.train import (
    create_train_state,
    make_accum_train_step,
    make_train_step,
    make_train_step_proj,
)
from i2pnet_tpu_torch.train.checkpoint import (
    CheckpointManager,
    restore_inference_variables,
    restore_train_state,
)
from i2pnet_tpu_torch.train.step import _proj_loss_fn
from i2pnet_tpu_torch.train.trainer import Trainer
from _torch_util import n, randomize_stats, t
from test_torch_data import write_large_range_tree
from test_train import _synthetic_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# conv and Dense biases that a batch-statistics norm follows: their true
# gradient is 0 and both sides hold cancellation residue
ABSORBED = re.compile(r"(Conv|Dense)_\d+\.bias$")
METRICS = ("loss", "loss_q", "loss_x", "sx", "sq")
B = 4


def _proj_cfg(dtype="float32", rate=0.0):
    return dataclasses.replace(I2PNetProjConfig.tiny(), compute_dtype=dtype, head_dropout_rate=rate)


def _free_cfg(dtype="float32", rate=0.0):
    return dataclasses.replace(I2PNetConfig.tiny(), compute_dtype=dtype, head_dropout_rate=rate)


def _jcfg(cfg):
    cls = JaxProjConfig if isinstance(cfg, I2PNetProjConfig) else JaxConfig
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _proj_batch():
    """B=4 rows of 512 points (the tail half zero padding) at 64x128, each
    row its own cloud, image and decalibration."""
    rng = np.random.default_rng(0)
    rgb = rng.normal(size=(B, 64, 128, 3)).astype(np.float32)
    raw = (rng.normal(size=(B, 512, 3)) * 10).astype(np.float32)
    raw[:, 256:] = 0.0
    ang = rng.uniform(0.1, 0.3, size=B)
    q = np.stack([np.cos(ang / 2), 0 * ang, np.sin(ang / 2), 0 * ang], 1).astype(np.float32)
    tr = rng.uniform(-1, 1, size=(B, 3)).astype(np.float32)
    lidar = n(TQ.warp_points(t(raw), t(q), t(tr))) * (np.sum(raw**2, -1, keepdims=True) > 0)
    k = np.tile(np.array([[[64.0, 0, 64], [0, 64.0, 32], [0, 0, 1]]], np.float32), (B, 1, 1))
    return {"rgb": rgb, "lidar": lidar.astype(np.float32), "raw_xyz": raw, "intrinsic": k,
            "decalib_q_gt": q, "decalib_t_gt": tr}


def _free_batch():
    """B=4: tests/test_train.py's batch of 2 at seeds 2 and 3. Seed 1 holds
    two pre-activations within f32 rounding of zero, where the port and JAX
    take opposite LeakyReLU branches and one cost-volume element's
    cotangent differs tenfold; ``test_torch_train_kink.py`` holds the step
    to JAX's at this file's bar on that input, with the branches aligned,
    and to the port's own f64 step. On seeds 2 and 3 the plain step's
    gradients agree within 3e-5 of a leaf's max."""
    halves = [_synthetic_batch(JaxConfig.tiny(), B=2, seed=s) for s in (2, 3)]
    return {k: np.concatenate([np.asarray(h[k]) for h in halves]) for k in halves[0]}


def _tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


@functools.cache
def _variables(proj):
    """JAX's initial variables for the tiny config, running statistics
    randomised (zeros and ones would make every fold trivial)."""
    batch = _proj_batch() if proj else _free_batch()
    if proj:
        jm = JaxI2PNetProj(_jcfg(_proj_cfg()))
        args = (batch["rgb"], batch["lidar"], batch["raw_xyz"], batch["intrinsic"])
    else:
        jm = JaxI2PNet(_jcfg(_free_cfg()))
        args = (batch["rgb"], batch["lidar"], batch["intrinsic"])
    v = jax.jit(jm.init, static_argnames="train")(jax.random.key(0), *args, train=False)
    return randomize_stats(v, np.random.default_rng(1))


def _port_model(proj, cfg):
    model = (I2PNetProj if proj else I2PNet)(cfg, device="cpu")
    return load_flax_variables(model, _variables(proj))


# ---- make_accum_train_step ------------------------------------------------

def _run(proj, make, steps=1, dtype="float32", rate=0.5):
    """(model, state, per-step metrics) of ``steps`` steps from JAX's initial
    variables, the dropout generator seeded 0."""
    cfg = _proj_cfg(dtype, rate) if proj else _free_cfg(dtype, rate)
    model = _port_model(proj, cfg)
    state = create_train_state(model, steps_per_epoch=1)
    step = make(model, cfg)
    gen = torch.Generator().manual_seed(0)
    batch = _tbatch(_proj_batch() if proj else _free_batch())
    return model, state, [step(state, batch, gen) for _ in range(steps)]


def _assert_same_state(a, b):
    """Parameters, running statistics, Adam's moments and step: bit for bit."""
    (ma, sa), (mb, sb) = a, b
    assert sa.step == sb.step
    for (name, x), y in zip(ma.state_dict().items(), mb.state_dict().values()):
        assert torch.equal(x, y), name
    pa, pb = list(ma.parameters()), list(mb.parameters())
    for x, y in zip(pa, pb):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa.optimizer.state[x][key], sb.optimizer.state[y][key]), key
    assert sa.optimizer.param_groups[0]["lr"] == sb.optimizer.param_groups[0]["lr"]


@pytest.mark.parametrize("proj", [True, False], ids=["proj", "free"])
def test_accum_step_of_one_is_the_plain_step(proj):
    """accum_steps=1, bf16, dropout at 0.5 from one generator seed: two
    steps equal the plain step's bit for bit (metrics, parameters,
    statistics, Adam's state, the schedule's rate)."""
    plain = make_train_step_proj if proj else make_train_step
    m1, s1, met1 = _run(proj, lambda m, c: make_accum_train_step(m, c, 1, proj=proj), 2,
                        "bfloat16")
    m0, s0, met0 = _run(proj, lambda m, c: plain(m, c), 2, "bfloat16")
    for a, b in zip(met1, met0):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(n(a[key]), n(b[key]), err_msg=key)
    _assert_same_state((m1, s1), (m0, s0))


@pytest.mark.parametrize("proj", [True, False], ids=["proj", "free"])
def test_step_metrics_hold_the_weights_the_loss_used(proj):
    """sx and sq in a step's metrics are the values its loss used, as in
    JAX, not the parameters the update then moved."""
    plain = make_train_step_proj if proj else make_train_step
    model, _, (metrics,) = _run(proj, plain)
    for key in ("sx", "sq"):
        before = float(np.asarray(_variables(proj)["params"][key]).reshape(()))
        assert float(metrics[key]) == before and float(getattr(model, key).detach()) != before, key


def test_accum_metrics_are_the_microbatch_mean():
    """With 2 microbatches the metrics are the mean of each microbatch's
    loss run in sequence, and the running statistics are those two
    forwards' (each normalising with its own statistics)."""
    cfg = _proj_cfg()
    model, _, (metrics,) = _run(True, lambda m, c: make_accum_train_step(m, c, 2, proj=True),
                                rate=0.0)
    ref = _port_model(True, cfg).train()
    batch = _tbatch(_proj_batch())
    micro = [_proj_loss_fn(ref, cfg)({k: v[i:i + 2] for k, v in batch.items()}, None)[1]
             for i in (0, 2)]
    for key in METRICS:
        assert torch.equal(metrics[key], torch.stack([m[key] for m in micro]).mean(0)), key
    for (name, x), y in zip(model.named_buffers(), ref.buffers()):
        assert torch.equal(x, y), name


def test_accum_step_needs_divisible_batch():
    cfg = _proj_cfg()
    model = _port_model(True, cfg)
    step = make_accum_train_step(model, cfg, 3, proj=True)
    with pytest.raises(ValueError, match="not divisible by accum_steps 3"):
        step(create_train_state(model), _tbatch(_proj_batch()))
    with pytest.raises(ValueError, match=">= 1"):
        make_accum_train_step(model, cfg, 0, proj=True)


# ---- checkpoints ------------------------------------------------------------

def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path):
    """One step, saved with its meta (inf bests) through the manager (read
    back with weights_only=True), restored into a fresh model and state:
    the next step equals the one that continues without the round trip.
    A model-only checkpoint (the evaluation layout) loads for inference and
    refuses to resume."""
    cfg = _proj_cfg("bfloat16", rate=0.5)
    model, state, _ = _run(True, make_train_step_proj, 1, "bfloat16")
    mgr = CheckpointManager(str(tmp_path))
    meta = {"epoch": 0, "n_iter": 1, "best": {"rotation": float("inf"), "acc": -float("inf")},
            "extra_best": {}}
    mgr.save(0, state, meta)
    payload, got_meta = mgr.restore()
    assert got_meta == meta and set(payload) == {"model", "optimizer", "step"}

    fresh = I2PNetProj(cfg, device="cpu")
    resumed = create_train_state(fresh, steps_per_epoch=1)
    restore_train_state(resumed, payload)
    _assert_same_state((fresh, resumed), (model, state))
    batch = _tbatch(_proj_batch())
    a = make_train_step_proj(model, cfg)(state, batch, torch.Generator().manual_seed(1))
    b = make_train_step_proj(fresh, cfg)(resumed, batch, torch.Generator().manual_seed(1))
    assert torch.equal(a["loss"], b["loss"])
    _assert_same_state((fresh, resumed), (model, state))

    mgr.save(1, {"model": model.state_dict(), "step": 2})
    with pytest.raises(ValueError, match="no optimizer state"):
        restore_train_state(create_train_state(I2PNetProj(cfg, device="cpu")), mgr.restore()[0])
    loaded = restore_inference_variables(str(tmp_path), I2PNetProj(cfg, device="cpu"),
                                         best="latest")
    for name, x in model.state_dict().items():
        assert torch.equal(loaded[name], x), name


# ---- the Trainer against JAX's ------------------------------------------------

def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(ROOT, "tools", "jax_ckpt_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _scalars(log_dir):
    """{tag: [(step, value), ...]} of metrics.jsonl."""
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["tag"], []).append((rec["step"], rec["value"]))
    return out


def _log_lines(log_dir, name):
    """Each line of a text log as (its words, its numbers)."""
    with open(os.path.join(log_dir, name)) as f:
        rows = [line.split() for line in f]
    return [([w for w in r if not re.fullmatch(r"-?[\d.]+(e-?\d+)?", w)],
             [float(w) for w in r if re.fullmatch(r"-?[\d.]+(e-?\d+)?", w)]) for r in rows]


def _assert_logs_agree(port_dir, jax_dir, tags, rtol):
    ours, ref = _scalars(port_dir), _scalars(jax_dir)
    for tag in tags:
        assert [s for s, _ in ours[tag]] == [s for s, _ in ref[tag]], tag
        np.testing.assert_allclose([v for _, v in ours[tag]], [v for _, v in ref[tag]],
                                   rtol=rtol, err_msg=tag)
    for name in ("log.txt", "log_rotate.txt", "log_trans.txt"):
        a, b = _log_lines(port_dir, name), _log_lines(jax_dir, name)
        assert [w for w, _ in a] == [w for w, _ in b], name
        np.testing.assert_allclose(np.concatenate([v for _, v in a]),
                                   np.concatenate([v for _, v in b]), rtol=1e-3, err_msg=name)


def test_trainer_matches_jax_and_resumes_from_a_converted_jax_run(tmp_path, monkeypatch):
    """One epoch of 2 steps and a validation batch in each package from
    JAX's initial variables, then a resumed second epoch. Bars: the
    per-step losses within 1e-4 relative, the validation dict within 1e-3
    relative key for key."""
    root = write_large_range_tree(str(tmp_path / "data"), (0, 1, 9), 2, 3000, seed=5)
    cfg = _proj_cfg()
    jcfg = _jcfg(cfg)
    kw = dict(img_H=64, img_W=128, sample_point=2048, seed=0)
    common = dict(batch_size=2, seed=0, proj=True, save_rate=1)
    jm = JaxI2PNetProj(jcfg)
    # JAX's trainer inits its variables eagerly, which compiles op by op;
    # the jitted init gives the same values
    init = jax.jit(jm.init, static_argnames="train")
    monkeypatch.setattr(JaxI2PNetProj, "init",
                        lambda self, key, *a, train, **k: init(key, *a, train=train, **k))

    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jt = JaxTrainer(jm, jcfg, JaxLargeRange(root, mode="train", **kw),
                    JaxLargeRange(root, mode="val", **kw), log_dir=jdir, epochs=1, **common)
    variables = {"params": jax.tree_util.tree_map(np.asarray, jt.state.params),
                 "batch_stats": jax.tree_util.tree_map(np.asarray, jt.state.batch_stats)}
    jt.train()
    train_ds = KittiLargeRangeDataset(root, mode="train", **kw)
    # JAX's trainer assembled one batch to init its variables, which drew
    # from the dataset's generator: the port's dataset makes the same draws
    [train_ds[i] for i in range(2)]
    model = load_flax_variables(I2PNetProj(cfg, device="cpu"), variables)
    pt = Trainer(model, cfg, train_ds, KittiLargeRangeDataset(root, mode="val", **kw),
                 log_dir=pdir, epochs=1, device="cpu", **common)
    pt.train()

    assert [s for s, _ in _scalars(pdir)["train/loss"]] == [1, 2]
    val_tags = [f"val/{k}" for k in jt.validate()]
    assert sorted(val_tags) == sorted(f"val/{k}" for k in pt.validate())
    _assert_logs_agree(pdir, jdir, ["train/loss", "train/loss_q", "train/loss_x"], 1e-4)
    _assert_logs_agree(pdir, jdir, val_tags, 1e-3)
    assert sorted(os.listdir(os.path.join(jdir, "best"))) == sorted(
        name[:-3] for name in os.listdir(os.path.join(pdir, "torch", "best")))
    assert {"config.json", "metrics.jsonl", "src_snapshot.tar.gz"} <= set(os.listdir(pdir))
    assert pt.ckpt.all_steps() == [0] and pt.best.keys() == jt.best.keys()
    for key, value in jt.best.items():
        np.testing.assert_allclose(pt.best[key], value, rtol=1e-3, err_msg=key)

    # resume: JAX from its checkpoint; the port from the converted one
    assert _converter().convert(jdir)["steps"] == [0]
    rdir = str(tmp_path / "port_resumed")
    shutil.copytree(jdir, rdir)
    jt = JaxTrainer(jm, jcfg, JaxLargeRange(root, mode="train", **kw),
                    JaxLargeRange(root, mode="val", **kw), log_dir=jdir, epochs=2, resume=True,
                    **common)
    jt.train()
    train_ds = KittiLargeRangeDataset(root, mode="train", **kw)
    [train_ds[i] for i in range(2)]
    pt = Trainer(I2PNetProj(cfg, device="cpu"), cfg, train_ds,
                 KittiLargeRangeDataset(root, mode="val", **kw), log_dir=rdir, epochs=2,
                 resume=True, device="cpu", **common)
    assert pt.start_epoch == 1 and pt.n_iter == 2 and pt.state.step == 2
    pt.train()
    ours, ref = _scalars(rdir)["train/loss"], _scalars(jdir)["train/loss"]
    assert [s for s, _ in ours] == [s for s, _ in ref] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in ours[2:]], [v for _, v in ref[2:]], rtol=1e-4)
