"""The efgh (online-calibration) branch of the free-point model against the
JAX package's, on the CPU, at ``I2PNetConfig.tiny()``: the points stay in
the LiDAR frame and every projection goes through the per-sample
calibration matrix scaled to the feature grid.

- The f32 eval forward, within the free forward's 2e-4.
- The bf16 eval forward, the JAX side on its Pallas kernels in interpret
  mode (``I2PNET_FUSED_EVAL``/``I2PNET_FUSED_CV=interpret``), the port on
  their plain versions: 3e-2 max / 5e-3 mean on out3/out4 (PR 1's bf16
  bar); the encoder blocks and cv1 routed to the fused paths (6 and 1), at
  the efgh scale (LiDAR uv in feature pixels, depths restored: pi_xyz in
  the hundreds).
- ``make_accum_train_step`` with calib, 2 microbatches of 2, against JAX's
  loss microbatch by microbatch, op by op: tests/test_torch_train_accum.py's
  bars.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.models import I2PNet as JaxI2PNet
from i2pnet_tpu.train.step import _free_point_loss_fn as jax_loss_fn
from i2pnet_tpu_torch.config import I2PNetConfig
from i2pnet_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from i2pnet_tpu_torch.models import I2PNet
from i2pnet_tpu_torch.ops import conv_cuda, cv_cuda, fps_cuda
from i2pnet_tpu_torch.train import create_train_state, make_accum_train_step
from _torch_util import n, port, randomize_stats, t
from test_torch_train import ABSORBED, _jcfg

B, H, W, N = 2, 64, 128, 512
CONFIGS = {
    "f32": dataclasses.replace(I2PNetConfig.tiny(), efgh=True),
    # a depth-3 cv1 mlp1, which the fused cv1 gate takes (test_torch_model.py)
    "bf16": dataclasses.replace(I2PNetConfig.tiny(), efgh=True, compute_dtype="bfloat16",
                                cost_volume_mlps=((16, 16, 16), (16, 16))),
}


def _inputs(seed=0, batch=B):
    """A LiDAR-frame cloud (x forward) and calib = K @ [R|t], the velo ->
    camera rotation of the KITTI raw loader, as its emit_calib builds for
    camera-frame points (K @ [I|0]) composed with that extrinsic; the focal
    length differs per sample, as across recording dates, so that a sample
    given another's calib answers otherwise."""
    rng = np.random.default_rng(seed)
    rgb = rng.normal(size=(batch, H, W, 3)).astype(np.float32)
    lidar = rng.uniform(-10, 10, size=(batch, N, 3)).astype(np.float32)
    lidar[..., 0] += 20.0
    k = np.array([[[60.0 - 2 * i, 0, W / 2], [0, 60.0 - 2 * i, H / 2], [0, 0, 1]]
                  for i in range(batch)], np.float32)
    velo_to_cam = np.array([[0, -1, 0, 0.06], [0, 0, -1, -0.07], [1, 0, 0, -0.27]], np.float32)
    return rgb, lidar, k, (k @ velo_to_cam).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def efgh_run(request):
    cfg = CONFIGS[request.param]
    rgb, lidar, k, calib = _inputs()
    jm = JaxI2PNet(_jcfg(cfg))
    v = randomize_stats(jm.init(jax.random.key(0), rgb, lidar, k, calib=calib, train=False),
                        np.random.default_rng(1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I2PNET_FUSED_EVAL", "interpret")
        mp.setenv("I2PNET_FUSED_CV", "interpret")
        ref = jm.apply(v, rgb, lidar, k, calib=calib, train=False)
    model = port(I2PNet(cfg, device="cpu"), v)
    return request.param, {key: n(ref[key]) for key in ("out3", "out4")}, model


def test_efgh_forward_matches_jax(efgh_run, monkeypatch):
    name, ref, model = efgh_run
    rgb, lidar, k, calib = map(t, _inputs())
    calls = {"block": 0, "cv1": 0}
    block, cv1 = conv_cuda.fused_conv_block, cv_cuda.cv1

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(conv_cuda, "fused_conv_block", count("block", block))
    monkeypatch.setattr(cv_cuda, "cv1", count("cv1", cv1))
    launches = (fps_cuda.launches, conv_cuda.launches, cv_cuda.launches)
    with torch.no_grad():
        out = model(rgb, lidar, k, calib=calib)
    assert (fps_cuda.launches, conv_cuda.launches, cv_cuda.launches) == launches  # CPU: plain
    assert calls == ({"block": 6, "cv1": 1} if name == "bf16" else {"block": 0, "cv1": 0})
    for key in ("out3", "out4"):
        got = n(out[key])
        assert got.shape == (B, 7) and np.isfinite(got).all()
        d = np.abs(got - ref[key])
        if name == "f32":
            assert float(d.max()) <= 2e-4, key
        else:
            assert float(d.max()) <= 3e-2 and float(d.mean()) <= 5e-3, key
    # the calib frame differs from the normalized plane: a model without
    # efgh on the same weights answers otherwise
    plain = I2PNet(dataclasses.replace(model.cfg, efgh=False), device="cpu")
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        other = plain.eval()(rgb, lidar, k)
    assert not torch.allclose(other["out3"], out["out3"])


def test_efgh_accum_step_matches_jax():
    """make_accum_train_step with calib in the batch, 2 microbatches of 2
    (B=4), f32, dropout off, against JAX's loss taken microbatch by
    microbatch as its make_accum_train_step composes it (the second
    microbatch on the first's new statistics, the gradients averaged; op by
    op, without its scan: JAX's jitted step reassociates sums by more than
    the bar): the metrics' mean 1e-4, the averaged gradient 1e-3 of a
    leaf's max, the running statistics after the second microbatch 1e-4."""
    cfg = dataclasses.replace(CONFIGS["f32"], head_dropout_rate=0.0)
    rgb, lidar, k, calib = _inputs(3, batch=4)
    q = np.tile(np.array([[np.cos(0.05), 0.0, np.sin(0.05), 0.0]], np.float32), (4, 1))
    tr = np.tile(np.array([[0.5, -0.2, 0.1]], np.float32), (4, 1))
    batch = dict(rgb=rgb, lidar=lidar, intrinsic=k, calib=calib, decalib_q_gt=q, decalib_t_gt=tr)
    jm = JaxI2PNet(_jcfg(cfg))
    v = jax.jit(jm.init, static_argnames="train")(jax.random.key(0), rgb[:2], lidar[:2], k[:2],
                                                   calib=calib[:2], train=False)
    v = randomize_stats(v, np.random.default_rng(1))
    grad = jax.grad(jax_loss_fn(jm, _jcfg(cfg)), has_aux=True)
    stats, grads, metrics_ref = v["batch_stats"], [], []
    for half in (slice(0, 2), slice(2, 4)):
        mb = {key: jnp.asarray(a[half]) for key, a in batch.items()}
        g, (state, m) = grad(v["params"], stats, mb, jax.random.key(0), jnp.int32(0))
        stats = state["batch_stats"]
        grads.append(g)
        metrics_ref.append(m)
    grads = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *grads)

    model = load_flax_variables(I2PNet(cfg, device="cpu"), v)
    state = create_train_state(model, steps_per_epoch=100)
    metrics = make_accum_train_step(model, cfg, 2)(state, {key: t(a) for key, a in batch.items()})
    for key in ("loss", "loss_q", "loss_x", "sx", "sq"):
        ref = np.mean([n(m[key]) for m in metrics_ref])
        np.testing.assert_allclose(n(metrics[key]), ref, rtol=1e-4, atol=1e-4, err_msg=key)
    params = dict(model.named_parameters())
    for name, g in flax_to_state_dict({"params": grads}).items():
        if ABSORBED.search(name):
            continue
        g = g.numpy()
        scale = float(np.abs(g).max()) + 1e-12
        np.testing.assert_allclose(n(params[name].grad) / scale, g / scale, atol=1e-3,
                                   err_msg=name)
    buffers = dict(model.named_buffers())
    for name, r in flax_to_state_dict({"batch_stats": stats}).items():
        np.testing.assert_allclose(n(buffers[name]), r.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
