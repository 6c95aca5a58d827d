"""The port's free-point train step against the JAX package's, on the CPU:
the losses, the quaternion helpers, the optimizer, the step's loss,
gradients and BatchNorm statistics in f32 and in bf16, the optimizer state
carried across by ``load_optax_adam_state``, dropout, convergence and
determinism.

``I2PNetConfig.tiny()`` with images (B=2, 64, 128), the batch of
``tests/test_train.py``. At that size the JAX package's fused train path
holds for all three encoder stages (asserted), so its bf16 step runs its
Pallas train kernels, in interpret mode, where the port runs their plain
versions. The JAX steps are computed once and shared.
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from i2pnet_tpu import losses as jl
from i2pnet_tpu.config import I2PNetConfig as JaxConfig
from i2pnet_tpu.models import I2PNet as JaxI2PNet
from i2pnet_tpu.ops import quaternion as JQ
from i2pnet_tpu.ops.conv_pallas_train import stage_supported_train
from i2pnet_tpu.train import create_train_state as jax_train_state
from i2pnet_tpu.train import make_optimizer as jax_optimizer
from i2pnet_tpu.train.step import _free_point_loss_fn as jax_loss_fn
from i2pnet_tpu_torch import losses as tl
from i2pnet_tpu_torch.config import I2PNetConfig
from i2pnet_tpu_torch.convert import flax_to_state_dict, load_flax_variables, load_optax_adam_state
from i2pnet_tpu_torch.models import I2PNet
from i2pnet_tpu_torch.nn.heads import PoseHead, dropout
from i2pnet_tpu_torch.ops import conv_train_cuda, fps_cuda
from i2pnet_tpu_torch.ops import quaternion as TQ
from i2pnet_tpu_torch.train import (
    clip_by_global_norm_,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from i2pnet_tpu_torch.train.step import _free_point_loss_fn
from _torch_util import n, randomize_stats, t
from test_train import _synthetic_batch

B, H, W = 2, 64, 128
# conv and Dense biases that a train-mode BatchNorm follows: their true
# gradient is 0 and both sides hold cancellation residue
ABSORBED = re.compile(r"(Conv|Dense)_\d+\.bias$")


def _cfg(dtype, rate=0.0):
    return dataclasses.replace(I2PNetConfig.tiny(), compute_dtype=dtype, head_dropout_rate=rate)


def _jcfg(cfg):
    return JaxConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


def _init(cfg, batch, seed=1):
    jm = JaxI2PNet(_jcfg(cfg))
    # jitted: the same values as op by op, in a quarter of the time
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.key(0), batch["rgb"], batch["lidar"], batch["intrinsic"], train=False)
    return jm, randomize_stats(v, np.random.default_rng(seed))


# ---- losses, quaternions, optimizer -----------------------------------------

def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tr = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(n(TQ.quat_to_rotmat(t(q))), n(JQ.quat_to_rotmat(q)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(n(TQ.pose_to_matrix(t(q), t(tr))), n(JQ.pose_to_matrix(q, tr)),
                               rtol=1e-6, atol=1e-7)


def _loss_inputs():
    rng = np.random.default_rng(1)
    pcl = rng.uniform(-10, 10, size=(B, 64, 3)).astype(np.float32)
    pcl[..., 2] += 15.0
    K = np.tile(np.array([[[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1))
    q = rng.normal(size=(B, 4)).astype(np.float32) * 0.05
    q[:, 0] += 1.0
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tr = rng.normal(size=(B, 3)).astype(np.float32) * 0.3
    out3, out4 = (np.concatenate([q + 0.01 * rng.normal(size=q.shape), tr + 0.1], 1).astype(np.float32)
                  for _ in range(2))
    return pcl, K, q, tr, out3, out4


@pytest.mark.parametrize("l1", [True, False])
def test_registration_loss_matches_jax(l1):
    _, _, q, tr, out3, out4 = _loss_inputs()
    sx, sq = np.array([0.3], np.float32), np.array([-2.5], np.float32)
    ref = jl.registration_loss(out3, out4, q, tr, sx, sq, l1_trans=l1)
    got = tl.registration_loss(*map(t, (out3, out4, q, tr, sx, sq)), l1_trans=l1)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(n(g), n(r), rtol=1e-6)


def test_projection_losses_match_jax():
    pcl, K, q, tr, out3, out4 = _loss_inputs()
    labels = jl.get_projection_gt(pcl, K, (H, W), q, tr)
    got = tl.get_projection_gt(t(pcl), t(K), (H, W), t(q), t(tr))
    assert got.dtype == torch.int32 and 0 < int(got.sum()) < got.numel()
    np.testing.assert_array_equal(got.numpy(), np.asarray(labels))
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(B, 64, 2)).astype(np.float32)
    onehot = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=(B, 64))]
    prob = rng.uniform(0.05, 0.95, size=(B, 64, 1)).astype(np.float32)
    for pm_j, pm_t, kw in (
        ((logits, pcl), (t(logits), t(pcl)), dict(focal=True)),
        ((logits, pcl), (t(logits), t(pcl)), dict(focal=False)),
        ((logits, pcl, onehot), (t(logits), t(pcl), t(onehot)), dict(focal=True)),
        ((prob, pcl), (t(prob), t(pcl)), dict(sigmoid=True)),
    ):
        ref = jl.projection_mask_loss(pm_j, K, (H, W), q, tr, **kw)
        got = tl.projection_mask_loss(pm_t, t(K), (H, W), t(q), t(tr), **kw)
        np.testing.assert_allclose(n(got), n(ref), rtol=1e-6)
    assert tl.projection_mask_loss(None, t(K), (H, W), t(q), t(tr)) is None
    ref = jl.pointwise_reprojection_loss(pcl, K, (H, W), out3, out4, q, tr)
    got = tl.pointwise_reprojection_loss(*map(t, (pcl, K)), (H, W), *map(t, (out3, out4, q, tr)))
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-5)
    R3, R4 = (JQ.quat_to_rotmat(o[:, :4]) for o in (out3, out4))
    sq, sx = np.float32(-2.5), np.float32(0.1)
    ref = jl.rt_loss(q, tr, R3, out3[:, 4:], R4, out4[:, 4:], sq, sx)
    got = tl.rt_loss(t(q), t(tr), t(R3), t(out3[:, 4:]), t(R4), t(out4[:, 4:]),
                     torch.tensor(sq), torch.tensor(sx))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(n(g), n(r), rtol=1e-5)


@pytest.mark.parametrize("clip", [-1.0, 0.5, 100.0], ids=["no-clip", "clipping", "clip-idle"])
def test_optimizer_matches_optax(clip):
    """Adam + coupled L2 + the staircase (decay 0.9 per update here) +
    global-norm clipping, three updates on identical params and grads:
    the same f32 arithmetic in another order, within 1e-6."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = jax_optimizer(lr=1e-3, weight_decay=1e-4, lr_decay=0.9, steps_per_epoch=1, clip=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(t(params[k])) for k in shapes]
    opt, sched = make_optimizer(tp, lr=1e-3, weight_decay=1e-4, lr_decay=0.9, steps_per_epoch=1)
    for _ in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(tp, shapes):
            p.grad = t(grads[k])
        if clip > 0:
            clip_by_global_norm_(tp, clip)
        opt.step()
        sched.step()
        for p, k in zip(tp, shapes):
            np.testing.assert_allclose(n(p), np.asarray(jp[k]), rtol=1e-6, atol=1e-9)


# ---- the whole step ------------------------------------------------------------

@functools.cache
def _jax_step(dtype):
    """(cfg, batch, jax model, variables, JAX grads, JAX new batch_stats,
    JAX metrics) of one step, dropout off, shared by the tests. f32: JAX op
    by op (its jitted step differs from its own op-by-op one by up to 1% of
    a leaf's scale on the coarse-head side, where XLA's fusions reassociate
    a sensitive path; the port follows the op-by-op one). bf16: JAX's
    jitted step, its train kernels in interpret mode."""
    cfg = _cfg(dtype)
    batch = _synthetic_batch(cfg)
    jm, v = _init(cfg, batch)
    grad = jax.grad(jax_loss_fn(jm, _jcfg(cfg)), has_aux=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I2PNET_FUSED_TRAIN", "interpret")
        if dtype == "bfloat16":
            grad = jax.jit(grad)
        grads, (state, metrics) = grad(v["params"], v["batch_stats"], batch, jax.random.key(0),
                                       jnp.int32(0))
    return cfg, batch, jm, v, grads, state["batch_stats"], metrics


def test_tiny_config_takes_the_fused_train_path():
    h, w = H, W
    for cin, chans, strides in I2PNetConfig.tiny().rgb_encoder_channels:
        assert stage_supported_train(h, w, cin, chans, strides), (h, w)
        for s in strides:
            h, w = h // s, w // s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(dtype):
    """Loss and metrics, then the gradients per leaf, then the BatchNorm
    running statistics after the step.

    Gradients, not updated params: Adam's first update is about +-lr
    wherever |g| >> eps, so noise in a near-zero gradient would flip it.

    f32: the same arithmetic with sums in another order; measured gaps
    3e-7 relative on the loss, 1.0e-4 of a leaf's max on the gradients,
    4e-6 on the statistics; bars 1e-4, 1e-3 and 1e-4.

    bf16: the frameworks round at other points (Dense products, BatchNorm
    casts, softmaxes, cotangents) and the kernels sum in another order.
    JAX's own jitted and op-by-op bf16 steps differ by up to 0.29 in a
    leaf's relative L2 gradient error (median 0.055) and 5e-3 on loss_x;
    the port against the jitted step measured 0.35 (median 0.073), 9e-4
    and 4e-3 on the statistics. Bars: 5e-3 relative on the metrics, 1e-2
    on the statistics, 0.5 per leaf and 0.15 as the median."""
    cfg, batch, _, v, grads, stats_ref, metrics_ref = _jax_step(dtype)
    bf16 = cfg.compute_dtype == "bfloat16"
    model = load_flax_variables(I2PNet(cfg, device="cpu"), v).train()
    before = (dict(conv_train_cuda.launches), fps_cuda.launches)
    loss, metrics = _free_point_loss_fn(model, cfg)(_tbatch(batch), None)
    loss.backward()
    assert (dict(conv_train_cuda.launches), fps_cuda.launches) == before  # CPU: plain

    tol = 5e-3 if bf16 else 1e-4
    for key in ("loss", "loss_q", "loss_x", "loss_mask", "sx", "sq"):
        np.testing.assert_allclose(n(metrics[key]), n(metrics_ref[key]), rtol=tol, atol=tol,
                                   err_msg=key)
    ref = flax_to_state_dict({"params": grads})
    params = dict(model.named_parameters())
    assert set(ref) == set(params)
    rel = []
    for name, gr in ref.items():
        if ABSORBED.search(name):
            continue
        gr = gr.numpy()
        got = n(params[name].grad)
        assert np.isfinite(got).all(), name
        if bf16:
            rel.append(float(np.linalg.norm(got - gr) / (np.linalg.norm(gr) + 1e-12)))
            assert rel[-1] <= 0.5, name
        else:
            scale = float(np.max(np.abs(gr))) + 1e-12
            np.testing.assert_allclose(got / scale, gr / scale, atol=1e-3, err_msg=name)
    if bf16:
        assert np.median(rel) <= 0.15
    ref = flax_to_state_dict({"batch_stats": stats_ref})
    buffers = dict(model.named_buffers())
    assert set(ref) == set(buffers)
    stol = 1e-2 if bf16 else 1e-4
    for name, r in ref.items():
        np.testing.assert_allclose(n(buffers[name]), r.numpy(), rtol=stol, atol=stol, err_msg=name)


def test_optax_state_carries_across():
    """One JAX step, then the port continues from the carried state: Adam's
    moments, the count and the schedule's rate (steps_per_epoch=1, so the
    second update runs at 0.99 * lr). Given JAX's second gradients, the
    port's update equals optax's; and a port step from the carried state
    has JAX's second-step loss."""
    cfg, batch, jm, v, g1, stats1, _ = _jax_step("float32")
    state = jax_train_state(jm, v, steps_per_epoch=1)
    state = state.apply_gradients(grads=g1, batch_stats=stats1)
    grad = jax.jit(jax.grad(jax_loss_fn(jm, _jcfg(cfg)), has_aux=True))
    g2, (_, m2) = grad(state.params, state.batch_stats, batch, jax.random.key(1), state.step)
    state2 = state.apply_gradients(grads=g2)
    carried = {"params": state.params, "batch_stats": state.batch_stats}

    model = load_flax_variables(I2PNet(cfg, device="cpu"), carried)
    ts = create_train_state(model, steps_per_epoch=1)
    load_optax_adam_state(ts, state.opt_state)
    assert ts.step == 1 and ts.optimizer.param_groups[0]["lr"] == pytest.approx(0.99e-3)
    params = dict(model.named_parameters())
    for name, g in flax_to_state_dict({"params": g2}).items():
        params[name].grad = g
    ts.optimizer.step()
    # optax forms the bias correction 1 - 0.999**k in f32, torch in double:
    # at k = 2 the f32 form is off by ~3e-5 relative, ~1e-8 of an update
    # of size lr; so atol 1e-7 (1e-4 of lr) for parameters near 0
    ref = flax_to_state_dict({"params": state2.params})
    for name, p in params.items():
        np.testing.assert_allclose(n(p), ref[name].numpy(), rtol=1e-6, atol=1e-7, err_msg=name)

    model = load_flax_variables(I2PNet(cfg, device="cpu"), carried)
    ts = create_train_state(model, steps_per_epoch=1)
    load_optax_adam_state(ts, state.opt_state)
    metrics = make_train_step(model, cfg)(ts, _tbatch(batch))
    assert ts.step == 2
    np.testing.assert_allclose(n(metrics["loss"]), n(m2["loss"]), rtol=1e-4)


def test_dropout_statistics():
    """Keep fraction ~ 1-p, kept values scaled by 1/(1-p), the same seed
    the same mask; identity at eval and at rate 0. The bits are not JAX's,
    so the statistics are compared with flax's Dropout."""
    import flax.linen as fnn

    x = torch.ones(200_000)
    for rate in (0.5, 0.2):
        got = dropout(x, rate, True, torch.Generator().manual_seed(0))
        ref = np.asarray(fnn.Dropout(rate).apply({}, jnp.ones(200_000), deterministic=False,
                                                 rngs={"dropout": jax.random.key(0)}))
        for out in (n(got), ref):
            kept = out != 0
            assert abs(kept.mean() - (1 - rate)) < 5e-3
            np.testing.assert_allclose(out[kept], 1 / (1 - rate), rtol=1e-6)
        again = dropout(x, rate, True, torch.Generator().manual_seed(0))
        assert torch.equal(got, again)
    assert dropout(x, 0.5, False) is x and dropout(x, 0.0, True) is x
    head = PoseHead(8, 16, dropout_rate=0.5, split_dp=True).train()
    pred, mask = torch.randn(2, 10, 8), torch.randn(2, 10, 8)
    q1, t1, _ = head(pred, mask, generator=torch.Generator().manual_seed(1))
    q2, t2, _ = head(pred, mask, generator=torch.Generator().manual_seed(1))
    assert torch.equal(q1, q2) and torch.equal(t1, t2)
    q_eval, _, _ = head.eval()(pred, mask)
    assert not torch.equal(q1, q_eval)


def test_train_step_decreases_loss_and_is_deterministic():
    """Eight steps with dropout on (the shipped rate 0.5) lower the loss, as
    tests/test_train.py::test_train_step_decreases_loss; and two runs from
    the same weights and generator seed give bit-identical losses."""
    cfg = _cfg("bfloat16", rate=0.5)
    batch = _synthetic_batch(cfg)
    _, v = _init(cfg, batch)

    def run():
        model = load_flax_variables(I2PNet(cfg, device="cpu"), v)
        state = create_train_state(model, lr=1e-3, steps_per_epoch=100)
        step = make_train_step(model, cfg)
        gen = torch.Generator().manual_seed(0)
        tb = _tbatch(batch)
        return [float(step(state, tb, gen)["loss"]) for _ in range(8)]

    losses = run()
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    assert run() == losses


def test_model_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        I2PNet(I2PNetConfig.tiny())
    model = I2PNet(I2PNetConfig.tiny(), device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
