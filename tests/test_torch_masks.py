"""The projection-mask branch of the free-point model against the JAX
package's, on the CPU, at ``I2PNetConfig.tiny()``: the forward with both
mask heads (ground-truth labels mixed in by ``delay_weight``, predicted
masks alone, the sigmoid heads, one head, ``ab_delay``) and the eval-time
ground-truth fallback, the mask losses on the models' real pm3/pm4 (softmax
focal and plain, sigmoid), the train step under ``train_target`` all /
regist / class, and ``make_accum_train_step`` with masks; then the
``Trainer`` with ``train_target="class"``.

Weights from JAX's init through ``convert.py``'s strict load; inputs from
a numpy seed. Bars: the forward 2e-4 (the free forward's); the steps as
``tests/test_torch_train.py``'s f32 step (JAX op by op): metrics 1e-4,
gradients 1e-3 of a leaf's max, statistics 1e-4.
"""

import dataclasses
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu import losses as jl
from i2pnet_tpu.models import I2PNet as JaxI2PNet
from i2pnet_tpu.train.trainer import Trainer as JaxTrainer
from i2pnet_tpu.train.step import _free_point_loss_fn as jax_loss_fn
from i2pnet_tpu_torch import losses as tl
from i2pnet_tpu_torch.config import I2PNetConfig
from i2pnet_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from i2pnet_tpu_torch.models import I2PNet
from i2pnet_tpu_torch.train import create_train_state, make_accum_train_step, make_train_step
from i2pnet_tpu_torch.train.step import _free_point_loss_fn
from i2pnet_tpu_torch.train.trainer import Trainer
from _torch_util import n, port, randomize_stats, t
from test_torch_train import ABSORBED, _jcfg
from test_train import _synthetic_batch

B, H, W = 2, 64, 128
MASKS = dict(use_projection_mask=True, layer_mask=(True, True))
FORWARD_CASES = {
    "gt_delay": (dict(MASKS), True),
    "predicted": (dict(MASKS, ground_truth_mask_layer=(False, False)), False),
    "sigmoid": (dict(MASKS, mask_sigmoid=True, ground_truth_mask_layer=(False, False)), True),
    "one_head": (dict(MASKS, one_head_mask=True), True),
    "ab_delay": (dict(MASKS, ab_delay=True, layer_mask=(False, True)), True),
    "gt_fallback": (dict(layer_mask=(False, False)), False),
}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    lidar = rng.uniform(-10, 10, size=(B, 512, 3)).astype(np.float32)
    lidar[..., 2] += 20.0
    k = np.tile(np.array([[[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1))
    gt = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=(B, 512))]
    return rgb, lidar, k, gt


@functools.cache
def _forward(case):
    """(JAX outputs, port outputs) of one eval forward."""
    kw, with_gt = FORWARD_CASES[case]
    cfg = dataclasses.replace(I2PNetConfig.tiny(), **kw)
    rgb, lidar, k, gt = _inputs()
    extra = dict(gt_project=gt, now_step=np.float32(cfg.mask_delay_step * 0.25)) if with_gt else {}
    jm = JaxI2PNet(_jcfg(cfg))
    v = randomize_stats(jm.init(jax.random.key(0), rgb, lidar, k, train=False, **extra),
                        np.random.default_rng(1))
    ref = jm.apply(v, rgb, lidar, k, train=False, **extra)
    model = port(I2PNet(cfg, device="cpu"), v)
    with torch.no_grad():
        got = model(t(rgb), t(lidar), t(k), **{a: torch.tensor(b) for a, b in extra.items()})
    return cfg, ref, got


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_mask_forward_matches_jax(case):
    cfg, ref, got = _forward(case)
    for key in ("out3", "out4"):
        assert float(np.abs(n(got[key]) - n(ref[key])).max()) <= 2e-4, key
    for key in ("pm3", "pm4"):
        assert (got[key] is None) == (ref[key] is None), key
        if ref[key] is None:
            continue
        assert float(np.abs(n(got[key][0]) - n(ref[key][0])).max()) <= 2e-4, key
        np.testing.assert_array_equal(n(got[key][1]), n(ref[key][1]))  # the level's points
        if ref[key][2] is not None:  # gt_project through the FPS levels
            np.testing.assert_array_equal(n(got[key][2]), n(ref[key][2]))
    if case == "one_head":
        assert got["pm4"] is None and got["pm3"] is not None
    if case == "gt_fallback":  # labels from the coarse pose, one-hot
        assert set(np.unique(n(got["pm3"][0]))) <= {0.0, 1.0} and got["pm3"][2] is None


@pytest.mark.parametrize("case", ["gt_delay", "predicted", "sigmoid"])
def test_mask_losses_on_the_models_masks_match_jax(case):
    """projection_mask_loss on the forward's real pm3/pm4 (gt labels from
    the subsampled gt_project, or recomputed at the level's points): focal
    and plain CE on the softmax heads, BCE on the sigmoid ones."""
    cfg, ref, got = _forward(case)
    rgb, lidar, k, _ = _inputs()
    q = np.tile(np.array([[np.cos(0.05), 0.0, np.sin(0.05), 0.0]], np.float32), (B, 1))
    tr = np.tile(np.array([[0.5, -0.2, 0.1]], np.float32), (B, 1))
    sigmoid = cfg.mask_sigmoid
    for key in ("pm3", "pm4"):
        for focal in ((False,) if sigmoid else (True, False)):
            r = jl.projection_mask_loss(ref[key], k, (H, W), q, tr, focal=focal, sigmoid=sigmoid)
            g = tl.projection_mask_loss(got[key], t(k), (H, W), t(q), t(tr), focal=focal,
                                        sigmoid=sigmoid)
            np.testing.assert_allclose(n(g), n(r), rtol=1e-4, err_msg=f"{key} focal={focal}")


@pytest.mark.parametrize("case", ["gt_delay", "predicted", "sigmoid", "one_head"])
def test_mask_accuracy_matches_jax(case):
    """The trainer's per-sample mask accuracy on the forward's real masks:
    the head JAX's trainer reads, the labels from gt_project or recomputed
    at the head's points, the sigmoid threshold."""
    cfg, ref, got = _forward(case)
    _, _, k, _ = _inputs()
    batch = {"decalib_real_gt": np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (B, 1)),
             "decalib_dual_gt": np.tile(np.array([[0.4, -0.1, 0.2]], np.float32), (B, 1))}
    shape = np.zeros((B, H, W, 3), np.float32)
    want = JaxTrainer._mask_accuracy(types.SimpleNamespace(proj=False, cfg=_jcfg(cfg)), ref,
                                     {"intrinsic": k, "rgb": shape}, batch)
    acc = Trainer._mask_accuracy(types.SimpleNamespace(proj=False, cfg=cfg, device="cpu"), got,
                                 {"intrinsic": t(k), "rgb": t(shape)}, batch)
    assert acc.shape == (B,) and np.isfinite(acc).all()
    np.testing.assert_allclose(acc, want, rtol=0, atol=1e-12)


# ---- the train steps -----------------------------------------------------------

STEP_CFG = dict(MASKS, ground_truth_projection_mask=True, mask_delay=True, head_dropout_rate=0.0)
STEP = 5  # the delay counter at update 5: mask_delay_step - 5


def _step_cfg():
    return dataclasses.replace(I2PNetConfig.tiny(), **STEP_CFG)


@functools.cache
def _variables():
    cfg = _step_cfg()
    batch = _synthetic_batch(_jcfg(cfg))
    v = jax.jit(JaxI2PNet(_jcfg(cfg)).init, static_argnames="train")(
        jax.random.key(0), batch["rgb"], batch["lidar"], batch["intrinsic"], train=False)
    return randomize_stats(v, np.random.default_rng(1))


@functools.cache
def _jax_step(target):
    """JAX's gradients, new statistics and metrics of one step, op by op."""
    cfg = _step_cfg()
    batch = _synthetic_batch(_jcfg(cfg))
    v = _variables()
    grad = jax.grad(jax_loss_fn(JaxI2PNet(_jcfg(cfg)), _jcfg(cfg), train_target=target),
                    has_aux=True)
    grads, (state, metrics) = grad(v["params"], v["batch_stats"], batch, jax.random.key(0),
                                   jnp.int32(STEP))
    return grads, state["batch_stats"], metrics


def _assert_grads(model, grads):
    """Every leaf within 1e-3 of its max. A leaf whose true gradient is 0
    holds cancellation residue on both sides (under 'class' the coarse
    pose's Dense biases reach the mask loss only through train-mode
    BatchNorms: ~1e-10 in both frameworks), so a leaf's scale is at least
    1e-4 of the largest leaf's."""
    ref = flax_to_state_dict({"params": grads})
    params = dict(model.named_parameters())
    assert set(ref) == set(params)
    floor = 1e-4 * max(float(np.max(np.abs(g.numpy()))) for g in ref.values())
    for name, gr in ref.items():
        if ABSORBED.search(name):
            continue
        gr = gr.numpy()
        got = np.zeros_like(gr) if params[name].grad is None else n(params[name].grad)
        scale = max(float(np.max(np.abs(gr))), floor) + 1e-12
        np.testing.assert_allclose(got / scale, gr / scale, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("target", ["all", "regist", "class"])
def test_mask_train_step_matches_jax(target):
    """Loss and metrics (with loss_mask), every leaf's gradient (zero where
    the target's loss does not reach it: the l3 pose head, sx and sq under
    'class', the mask heads under 'regist'), and the running statistics."""
    cfg = _step_cfg()
    grads, stats, metrics_ref = _jax_step(target)
    batch = {k: t(v) for k, v in _synthetic_batch(_jcfg(cfg)).items()}
    model = load_flax_variables(I2PNet(cfg, device="cpu"), _variables()).train()
    loss, metrics = _free_point_loss_fn(model, cfg, train_target=target)(batch, None, STEP)
    loss.backward()
    for key in ("loss", "loss_q", "loss_x", "loss_mask", "sx", "sq"):
        np.testing.assert_allclose(n(metrics[key]), n(metrics_ref[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    _assert_grads(model, grads)
    buffers = dict(model.named_buffers())
    for name, r in flax_to_state_dict({"batch_stats": stats}).items():
        np.testing.assert_allclose(n(buffers[name]), r.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    if target == "class":
        assert model.sx.grad is None and model.l3_head.hidden_layer.weight.grad is None


def test_class_step_moves_every_parameter_as_optax_does():
    """Under 'class' the parameters the loss does not reach get a zero
    gradient, so Adam's decay term still moves every non-zero one (the
    l3 pose head's weights, sx, sq), as optax does."""
    cfg = _step_cfg()
    model = load_flax_variables(I2PNet(cfg, device="cpu"), _variables())
    state = create_train_state(model, steps_per_epoch=100)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    batch = {k: t(v) for k, v in _synthetic_batch(_jcfg(cfg)).items()}
    make_train_step(model, cfg, train_target="class")(state, batch)
    assert len(state.optimizer.state) == len(before)
    assert all(not torch.equal(p, before[k]) for k, p in model.named_parameters()
               if bool(before[k].any()))
    assert not torch.equal(model.l3_head.hidden_layer.weight, before["l3_head.hidden_layer.weight"])
    with pytest.raises(ValueError, match="mask heads"):
        plain = I2PNet(I2PNetConfig.tiny(), device="cpu")
        make_train_step(plain, plain.cfg, train_target="class")(
            create_train_state(plain), batch)


def test_mask_accum_step_matches_jax():
    """make_accum_train_step with the mask heads, 2 microbatches of 2 (B=4),
    against JAX's loss taken microbatch by microbatch as its
    make_accum_train_step composes it (the second microbatch on the first's
    new statistics, the gradients averaged; op by op, without its scan):
    the metrics' mean 1e-4, the averaged gradient 1e-3 of a leaf's max, the
    statistics after the second microbatch 1e-4."""
    cfg = _step_cfg()
    # the first microbatch is the 'all' step's batch: its JAX run is shared
    halves = [_synthetic_batch(_jcfg(cfg), seed=s) for s in (0, 3)]
    grad = jax.grad(jax_loss_fn(JaxI2PNet(_jcfg(cfg)), _jcfg(cfg)), has_aux=True)
    v = _variables()
    g, stats, m = _jax_step("all")
    grads, metrics_ref = [g], [m]
    g, (state, m) = grad(v["params"], stats, halves[1], jax.random.key(0), jnp.int32(STEP))
    stats = state["batch_stats"]
    grads.append(g)
    metrics_ref.append(m)
    grads = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *grads)

    model = load_flax_variables(I2PNet(cfg, device="cpu"), v)
    state = create_train_state(model, steps_per_epoch=100)
    state.set_step(STEP)
    batch = {k: t(np.concatenate([np.asarray(h[k]) for h in halves])) for k in halves[0]}
    metrics = make_accum_train_step(model, cfg, 2)(state, batch)
    for key in ("loss", "loss_q", "loss_x", "loss_mask", "sx", "sq"):
        ref = np.mean([n(m[key]) for m in metrics_ref])
        np.testing.assert_allclose(n(metrics[key]), ref, rtol=1e-4, atol=1e-4, err_msg=key)
    _assert_grads(model, grads)  # the step leaves the averaged gradient in .grad
    buffers = dict(model.named_buffers())
    for name, r in flax_to_state_dict({"batch_stats": stats}).items():
        np.testing.assert_allclose(n(buffers[name]), r.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


# ---- the trainer ---------------------------------------------------------------

class _Pairs:
    """In-memory pairs with the loaders' keys."""

    def __init__(self, count, seed):
        rng = np.random.default_rng(seed)
        k = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
        self.samples = []
        for i in range(count):
            lidar = (rng.uniform(-10, 10, size=(512, 3)) + [0, 0, 20]).astype(np.float32)
            self.samples.append(dict(
                rgb=rng.normal(size=(H, W, 3)).astype(np.float32), lidar=lidar,
                lidar_feats=lidar, raw_point_xyz=lidar, init_intrinsic=k,
                init_extrinsic=np.eye(3, 4, dtype=np.float32),
                decalib_real_gt=np.array([1.0, 0, 0, 0], np.float32),
                decalib_dual_gt=(0.2 * rng.normal(size=3)).astype(np.float32),
                path_info=f"00 {i:06d}"))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


@pytest.mark.parametrize("sigmoid", [False, True])
def test_trainer_class_target_keeps_the_accuracy_best(tmp_path, sigmoid):
    """train_target='class': validation's acc is the l3 head's mask accuracy
    (metrics.eval_acc against the in-frustum labels at the head's points),
    finite and in [0, 1]; the only snapshot is model_acc_best."""
    kw = dict(STEP_CFG)
    if sigmoid:
        kw.update(mask_sigmoid=True, ground_truth_mask_layer=(False, False))
    cfg = dataclasses.replace(I2PNetConfig.tiny(), **kw)
    model = I2PNet(cfg, device="cpu")
    trainer = Trainer(model, cfg, _Pairs(4, 0), _Pairs(2, 1), log_dir=str(tmp_path),
                      batch_size=2, epochs=1, save_rate=1, train_target="class", device="cpu")
    trainer.train()
    acc = trainer.best["acc"]
    assert 0.0 <= acc <= 1.0 and np.isfinite(acc)
    bests = sorted(os.listdir(os.path.join(tmp_path, "torch", "best")))
    assert bests == ["model_acc_best.pt"], bests
    assert trainer.best["rotation"] == np.inf
