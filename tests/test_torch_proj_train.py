"""The port's fourth slice as a whole: the projection-family I2PNetProj train
step (``make_train_step_proj``) against the JAX package's on the CPU, in
f32 here and in bf16 in ``test_torch_proj_train_bf16.py`` (two files, so
that the two JAX reference steps build in parallel), with
``I2PNetProjConfig.tiny()`` at B=2, a 64x128 image and 512 points a row of
which the tail half is zero padding (tests/test_torch_proj_model.py's
inputs). At that size the JAX package's fused train path holds for all
three encoder stages (asserted), so its bf16 step runs its Pallas train
kernels in interpret mode where the port runs their plain versions.

Dropout is off in the parity tests (the two frameworks draw other bits) and
on in the convergence and determinism test. The bars are those of the
free-point step (tests/test_torch_train.py). The JAX steps are computed
once and shared.
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.config import I2PNetProjConfig as JaxProjConfig
from i2pnet_tpu.models import I2PNetProj as JaxI2PNetProj
from i2pnet_tpu.ops.conv_pallas_train import stage_supported_train
from i2pnet_tpu.train.step import _proj_loss_fn as jax_proj_loss_fn
from i2pnet_tpu_torch.config import I2PNetProjConfig
from i2pnet_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from i2pnet_tpu_torch.models import I2PNetProj
from i2pnet_tpu_torch.ops import conv_train_cuda, pool_route_cuda, select_cuda
from i2pnet_tpu_torch.train import create_train_state, make_train_step_proj
from i2pnet_tpu_torch.train.step import _proj_loss_fn
from _torch_util import n, randomize_stats, t
from test_torch_proj_model import B, H, W, _inputs

# conv and Dense biases that a batch-statistics norm follows: their true
# gradient is 0 and both sides hold cancellation residue
ABSORBED = re.compile(r"(Conv|Dense)_\d+\.bias$")
METRICS = ("loss", "loss_q", "loss_x", "sx", "sq")


def _cfg(dtype, rate=0.0):
    return dataclasses.replace(I2PNetProjConfig.tiny(), compute_dtype=dtype, head_dropout_rate=rate)


def _jcfg(cfg):
    return JaxProjConfig(**dataclasses.asdict(cfg))


def _batch():
    rgb, lidar, raw, k = _inputs()
    ang = 0.2  # the decalibration _inputs applies
    q = np.array([[np.cos(ang / 2), 0, np.sin(ang / 2), 0]] * B, np.float32)
    tr = np.array([[1.0, 0, 0.5]] * B, np.float32)
    return {"rgb": rgb, "lidar": lidar, "raw_xyz": raw, "intrinsic": k,
            "decalib_q_gt": q, "decalib_t_gt": tr}


def _tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


@functools.cache
def _variables():
    jm = JaxI2PNetProj(_jcfg(_cfg("float32")))
    rgb, lidar, raw, k = _inputs()
    v = jax.jit(jm.init, static_argnames="train")(jax.random.key(0), rgb, lidar, raw, k, train=False)
    return randomize_stats(v, np.random.default_rng(1))


@functools.cache
def _jax_step(dtype):
    """(cfg, JAX grads, JAX new batch_stats, JAX metrics) of one step with
    dropout off: JAX's jitted step, its bf16 train kernels in interpret
    mode. The jitted f32 step reassociates sums, but at this size its
    gradients stay within 1e-4 of each leaf's max of the port's, ten times
    inside the f32 bar (the free step's do not: tests/test_torch_train.py
    runs JAX op by op), and JAX op by op takes minutes on a CPU."""
    cfg = _cfg(dtype)
    v = _variables()
    grad = jax.jit(jax.grad(jax_proj_loss_fn(JaxI2PNetProj(_jcfg(cfg)), _jcfg(cfg)), has_aux=True))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I2PNET_FUSED_TRAIN", "interpret")
        grads, (state, metrics) = grad(v["params"], v["batch_stats"], _batch(), jax.random.key(0),
                                       jnp.int32(0))
    return cfg, grads, state["batch_stats"], metrics


def _port_step(cfg, monkeypatch, **env):
    """One port step (loss and backward, no update) on the shared weights:
    (model, metrics)."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    model = load_flax_variables(I2PNetProj(cfg, device="cpu"), _variables()).train()
    loss, metrics = _proj_loss_fn(model, cfg)(_tbatch(_batch()), None)
    loss.backward()
    return model, metrics


def _counts():
    return dict(conv_train_cuda.launches), dict(pool_route_cuda.launches), select_cuda.launches


def test_tiny_proj_config_takes_the_fused_train_path():
    h, w = H, W
    for cin, chans, strides in I2PNetProjConfig.tiny().rgb_encoder_channels:
        assert stage_supported_train(h, w, cin, chans, strides), (h, w)
        for s in strides:
            h, w = h // s, w // s


def check_step_matches_jax(dtype, monkeypatch):
    """Metrics, the gradient of every leaf, the RGB running statistics.

    f32: the same arithmetic with sums in another order; bars 1e-4 on the
    metrics, 1e-3 of each leaf's max on the gradients, 1e-4 on the
    statistics. bf16 against JAX's interpret-mode kernels: 5e-3 on the
    metrics, 1e-2 on the statistics, relative L2 gradient error 0.5 per
    leaf and 0.15 as the median (the frameworks round at other points)."""
    cfg, grads, stats_ref, metrics_ref = _jax_step(dtype)
    bf16 = dtype == "bfloat16"
    before = _counts()
    model, metrics = _port_step(cfg, monkeypatch, I2PNET_FUSED_TRAIN="interpret")
    assert _counts() == before  # CPU: every kernel's plain version

    tol = 5e-3 if bf16 else 1e-4
    for key in METRICS:
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


def test_proj_train_step_matches_jax_f32(monkeypatch):
    check_step_matches_jax("float32", monkeypatch)


def test_proj_train_step_pallas_backend_is_bit_identical(monkeypatch):
    """The bf16 step under I2PNET_POOL_BWD=pallas (no taps saved, the
    backward recomputes them) gives idx's metrics, gradients and running
    statistics bit for bit, as JAX's own test holds its two first-max
    backends (tests/test_conv_pallas_train.py)."""
    cfg = _cfg("bfloat16")
    runs = {}
    for bwd in ("idx", "pallas"):
        calls = dict.fromkeys(("bn_pool_fwd_plain", "bn_pool_fwd_notap_plain",
                               "bn_pool_bwd_plain", "bn_pool_bwd_recompute_plain"), 0)
        for name in calls:
            fn = getattr(conv_train_cuda, name)

            def spy(*a, _fn=fn, _name=name):
                calls[_name] += 1
                return _fn(*a)

            monkeypatch.setattr(conv_train_cuda, name, spy)
        runs[bwd] = _port_step(cfg, monkeypatch, I2PNET_POOL_BWD=bwd) + (calls,)
        monkeypatch.undo()
    (m_idx, met_idx, calls_idx), (m_pal, met_pal, calls_pal) = runs["idx"], runs["pallas"]
    # six encoder blocks at the tiny widths; the recompute backward calls
    # the idx forward's plain version to find its taps
    assert calls_idx == {"bn_pool_fwd_plain": 6, "bn_pool_fwd_notap_plain": 0,
                         "bn_pool_bwd_plain": 6, "bn_pool_bwd_recompute_plain": 0}
    assert calls_pal == {"bn_pool_fwd_plain": 6, "bn_pool_fwd_notap_plain": 6,
                         "bn_pool_bwd_plain": 6, "bn_pool_bwd_recompute_plain": 6}
    for key in METRICS:
        assert torch.equal(met_idx[key], met_pal[key]), key
    grads = dict(m_pal.named_parameters())
    for name, p in m_idx.named_parameters():
        assert torch.equal(p.grad, grads[name].grad), name
    buffers = dict(m_pal.named_buffers())
    for name, b in m_idx.named_buffers():
        assert torch.equal(b, buffers[name]), name


def test_proj_train_forward_without_gradient_takes_the_no_tap_forward(monkeypatch):
    """A train-mode forward under no_grad runs the no-tap forward's plain
    version in every encoder block (6 at the tiny widths) and never the
    tap-saving one, and still moves the running statistics."""
    calls = {"bn_pool_fwd_notap_plain": 0, "bn_pool_fwd_plain": 0}
    for name in calls:
        fn = getattr(conv_train_cuda, name)

        def spy(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(conv_train_cuda, name, spy)
    model = load_flax_variables(I2PNetProj(_cfg("bfloat16"), device="cpu"), _variables()).train()
    before = model.rgb_encoder.RGBEncoderStage_0.BatchNorm_0.running_mean.clone()
    with torch.no_grad():
        out = model(*map(t, _inputs()))
    assert torch.isfinite(out["out3"]).all()
    assert calls == {"bn_pool_fwd_notap_plain": 6, "bn_pool_fwd_plain": 0}
    assert not torch.equal(model.rgb_encoder.RGBEncoderStage_0.BatchNorm_0.running_mean, before)


def test_proj_train_step_decreases_loss_and_is_deterministic():
    """Ten steps with dropout on (the shipped rate 0.5) lower the loss (the
    last three steps' mean below the first three's: with dropout a single
    step's loss is noisy); a second run from the same weights and generator
    seed repeats the first three losses bit for bit (each step's loss
    depends on every step before it)."""
    cfg = _cfg("bfloat16", rate=0.5)

    def run(steps):
        model = load_flax_variables(I2PNetProj(cfg, device="cpu"), _variables())
        state = create_train_state(model, lr=1e-3, steps_per_epoch=100)
        step = make_train_step_proj(model, cfg)
        gen = torch.Generator().manual_seed(0)
        tb = _tbatch(_batch())
        return [float(step(state, tb, gen)["loss"]) for _ in range(steps)]

    losses = run(10)
    assert np.isfinite(losses).all(), losses
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert run(3) == losses[:3]
