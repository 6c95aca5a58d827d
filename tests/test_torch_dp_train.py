"""The port's data-parallel training on the CPU: two gloo ranks
(``tests/_torch_dp_worker.py``, spawned once a test) against the JAX
package's DP forms on conftest's virtual devices (2-device meshes) and
against the port's own single-process run.

- the bf16 ``RGBEncoderStage`` in training, kernels' plain versions, under
  the mesh (``fused_stage_train``'s moments all-reduced) against JAX's stage
  under a 2-device mesh with ``I2PNET_FUSED_TRAIN=interpret`` (its
  ``shard_map`` with psum'd moments), at the bars of
  tests/test_torch_conv_train.py's single-device comparison (the two
  frameworks round at other points), and against the port's single-process
  stage at JAX's own DP bars (tests/test_dp_fused.py): the loss within
  1e-4 of |loss| + 1, the running statistics within rtol 1e-5 / atol 1e-6,
  each gradient within 1e-3 of the leaf's largest;
- ``BatchStatsNorm`` (forward and backward) and a dense-route
  ``ProjectPointNet`` level on an even and a ragged batch (the ragged
  rank's padded row carries no weight), against JAX's single-device
  modules on the real rows, on the setup of tests/test_dense_window.py's
  ``test_dense_eval_dp_matches_single_device``, within its 1e-5;
- the tiny proj config's DP train step in f32 (dropout off) against JAX's
  ``shard_train_step`` on a 2-device mesh, at the bars of
  tests/test_torch_proj_train.py (metrics 1e-4, each gradient within 1e-3
  of its leaf's largest, statistics 1e-4), and the tiny free config's
  against the port's single-process step (JAX's jitted free f32 step is 1%
  of a leaf off its own op-by-op step, so the port is its own reference
  there): the same bars, and the ranks' gradients, parameters and
  statistics bit-identical after the update.
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from i2pnet_tpu.config import I2PNetProjConfig as JaxProjConfig
from i2pnet_tpu.models import I2PNetProj as JaxI2PNetProj
from i2pnet_tpu.nn.layers import BatchStatsNorm as JaxBatchStatsNorm
from i2pnet_tpu.nn.proj_backbone import ProjectPointNet as JaxProjectPointNet
from i2pnet_tpu.ops import quaternion as JQ
from i2pnet_tpu.parallel import make_mesh as jax_make_mesh
from i2pnet_tpu.parallel import replicate_spec, shard_batch, shard_train_step
from i2pnet_tpu.train.step import _proj_loss_fn as jax_proj_loss_fn
from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
from i2pnet_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from i2pnet_tpu_torch.models import I2PNet, I2PNetProj, init_flax_
from i2pnet_tpu_torch.nn.layers import BatchStatsNorm, RGBEncoderStage
from i2pnet_tpu_torch.nn.proj_backbone import ProjectPointNet
from i2pnet_tpu_torch.ops import conv_train_cuda, select_cuda
from i2pnet_tpu_torch.train import create_train_state, make_train_step
from _torch_dp_worker import spawn
from _torch_util import n, randomize_stats, t
from test_dense_window import _grids
from test_dp_fused import _stage_setup

BF = torch.bfloat16
# conv and Dense biases that a batch-statistics norm follows: their true
# gradient is 0 and both sides hold cancellation residue
ABSORBED = re.compile(r"(Conv|Dense)_\d+\.bias$")


def _dp_mesh(k=2):
    return Mesh(np.asarray(jax.devices()[:k]), ("data",))


def _close_leaves(got: dict, ref: dict, bar: float, label: str) -> None:
    """Each leaf within ``bar`` of the reference leaf's largest magnitude."""
    assert set(got) == set(ref), label
    for name, r in ref.items():
        if ABSORBED.search(name):
            continue
        g, r = n(got[name]), n(r)
        scale = float(np.abs(r).max()) + 1e-12
        gap = float(np.abs(g - r).max())
        assert gap <= bar * scale + 1e-6, (label, name, gap, scale)


def _ranks_sum(results, key):
    return {k: sum(r[key][k] for r in results) for k in results[0][key]}


def test_dp_encoder_stage_matches_jax_shard_map(tmp_path, monkeypatch):
    monkeypatch.setenv("I2PNET_FUSED_TRAIN", "interpret")
    mod, variables, x, g, channels = _stage_setup(train=True)

    def loss(params, batch_stats, x):
        out, upd = mod.apply({"params": params, "batch_stats": batch_stats}, x, True,
                             mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * g), (out, upd)

    mesh = _dp_mesh()
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    jitted = jax.jit(jax.value_and_grad(loss, has_aux=True), in_shardings=(repl, repl, data),
                     out_shardings=((repl, (data, repl)), repl))
    with jax.set_mesh(mesh):
        (l_jax, (out_jax, upd_jax)), gr_jax = jitted(
            jax.device_put(variables["params"], repl),
            jax.device_put(variables["batch_stats"], repl), jax.device_put(x, data))

    # the port: one process, then two ranks on 4 rows each
    single = load_flax_variables(RGBEncoderStage(3, channels, (2, 2), BF), variables).train()
    state = {k: v.clone() for k, v in single.state_dict().items()}
    before = dict(conv_train_cuda.launches)
    out1 = single(t(x))
    l1 = (out1.float() * t(g)).sum()
    l1.backward()
    ranks = spawn(tmp_path, "stage", state, 3, channels, (2, 2), np.asarray(x), np.asarray(g))
    assert dict(conv_train_cuda.launches) == before  # CPU: the plain versions
    out_dp = torch.cat([r["out"] for r in ranks])
    l_dp = float((out_dp * t(g)).sum().detach())
    grads_dp = _ranks_sum(ranks, "grads")  # shard_map's transpose sums the replicas' cotangents
    for r in ranks[1:]:  # the statistics are global: every rank moves its buffers alike
        assert all(torch.equal(r["buffers"][k], ranks[0]["buffers"][k]) for k in r["buffers"])

    # DP against the single process, at JAX's DP bars
    assert abs(l_dp - float(l1)) < 1e-4 * (abs(float(l1)) + 1.0)
    for k, b in single.named_buffers():
        np.testing.assert_allclose(n(ranks[0]["buffers"][k]), n(b), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    _close_leaves(grads_dp, {k: p.grad for k, p in single.named_parameters()}, 1e-3,
                  "dp vs single")

    # DP against JAX's shard_map stage, at the cross-framework bars
    assert abs(l_dp - float(l_jax)) < 2e-2 * (abs(float(l_jax)) + 1.0)
    np.testing.assert_allclose(n(out_dp), n(out_jax), atol=3e-2)
    ref = flax_to_state_dict({"batch_stats": jax.device_get(upd_jax["batch_stats"])})
    for k, r in ref.items():
        np.testing.assert_allclose(n(ranks[0]["buffers"][k]), r.numpy(), rtol=2e-2, atol=2e-3,
                                   err_msg=k)
    _close_leaves(grads_dp, flax_to_state_dict({"params": jax.device_get(gr_jax)}), 5e-2,
                  "dp vs jax")


@pytest.mark.parametrize("rows", [8, 7], ids=["even", "ragged"])
def test_dp_batch_stats_norm_and_dense_window(rows, tmp_path, monkeypatch):
    """Rank 0 takes rows 0-3; rank 1 rows 4-7, or 4-6 and row 6 again with
    1 of its 4 rows padding on the ragged batch. The reference is each
    JAX module on the real rows alone."""
    rng = np.random.default_rng(11)
    x = rng.normal(loc=0.5, size=(rows, 5, 3, 6)).astype(np.float32)
    gx = rng.normal(size=x.shape).astype(np.float32)
    jnorm = JaxBatchStatsNorm()
    nvars = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(scale=0.3, size=a.shape).astype(np.float32),
        jnorm.init(jax.random.key(1), x))
    y_ref, vjp = jax.vjp(lambda v, a: jnorm.apply(v, a), nvars, x)
    dv_ref, dx_ref = vjp(jnp.asarray(gx))

    xyz_raw, xyz, feat = (np.asarray(a)[:rows] for a in _grids(7, B=8))
    kw = dict(out_h=4, out_w=8, stride_h=2, stride_w=2, kernel_size=(3, 5), nsample=4,
              distance=1.5, mlp=(8, 16))
    jpn = JaxProjectPointNet(use_trans=True, use_bn=True, **kw)
    monkeypatch.setenv("I2PNET_PROJ_DENSE_EVAL", "0")  # JAX's gathered route, as its DP test
    pvars = randomize_stats(jpn.init(jax.random.key(2), xyz_raw, xyz, feat, center_mode=True),
                            np.random.default_rng(3))
    _, _, feat_ref = jax.jit(lambda v, a, b, c: jpn.apply(v, a, b, c, center_mode=True))(
        pvars, xyz_raw, xyz, feat)
    monkeypatch.delenv("I2PNET_PROJ_DENSE_EVAL")  # the port's default: the dense route

    norm_state = load_flax_variables(BatchStatsNorm(6), nvars).state_dict()
    pn_kw = dict(kw, in_channels=10, use_trans=True, use_bn=True)
    pn_state = load_flax_variables(ProjectPointNet(**pn_kw), pvars).state_dict()
    before = select_cuda.launches
    ranks = spawn(tmp_path, "norms", rows, norm_state, x, gx, pn_state, pn_kw,
                  (xyz_raw, xyz, feat))
    assert select_cuda.launches == before
    assert [r["valid"] for r in ranks] == [4, rows - 4]

    def real(key):
        return np.concatenate([n(r[key])[:r["valid"]] for r in ranks])

    np.testing.assert_allclose(real("y"), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(real("dx"), np.asarray(dx_ref), rtol=1e-5, atol=1e-5)
    ref = flax_to_state_dict({"params": dv_ref["params"]})
    for k, g in _ranks_sum(ranks, "grads").items():
        np.testing.assert_allclose(n(g), ref[k].numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    # the padded row normalised with the real rows' statistics is dropped
    np.testing.assert_allclose(real("feat"), np.asarray(feat_ref), rtol=1e-5, atol=1e-5)


PROJ_B = 4
METRICS = ("loss", "loss_q", "loss_x", "sx", "sq")


def _proj_batch():
    """tests/test_torch_proj_model.py's inputs at B=4: a 64x128 image, 512
    points a row with a zero tail, decalibrated by a known pose."""
    rng = np.random.default_rng(0)
    B, H, W, N = PROJ_B, 64, 128, 512
    rgb = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    raw = (rng.normal(size=(B, N, 3)) * 10).astype(np.float32)
    raw[:, N // 2:] = 0.0
    ang = 0.2
    q = np.array([[np.cos(ang / 2), 0, np.sin(ang / 2), 0]] * B, np.float32)
    tr = np.array([[1.0, 0, 0.5]] * B, np.float32)
    lidar = np.asarray(JQ.warp_points(raw, q, tr)) * (np.sum(raw**2, -1, keepdims=True) > 0)
    k = np.tile(np.array([[[64.0, 0, 64], [0, 64.0, 32], [0, 0, 1]]], np.float32), (B, 1, 1))
    return {"rgb": rgb, "lidar": lidar.astype(np.float32), "raw_xyz": raw, "intrinsic": k,
            "decalib_q_gt": q, "decalib_t_gt": tr}


def test_dp_proj_train_step_matches_jax_shard_train_step(tmp_path):
    cfg = dataclasses.replace(I2PNetProjConfig.tiny(), head_dropout_rate=0.0)
    jcfg = JaxProjConfig(**dataclasses.asdict(cfg))
    jm = JaxI2PNetProj(jcfg)
    batch = _proj_batch()
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.key(0), *(batch[k] for k in ("rgb", "lidar", "raw_xyz", "intrinsic")),
        train=False)
    v = randomize_stats(v, np.random.default_rng(1))
    grad = jax.grad(jax_proj_loss_fn(jm, jcfg), has_aux=True)

    def grad_step(state, batch, rng):
        grads, (new, metrics) = grad(state["params"], state["batch_stats"], batch, rng,
                                     jnp.int32(0))
        return {"grads": grads, "batch_stats": new["batch_stats"]}, metrics

    mesh = jax_make_mesh(jax.devices()[:2])
    step = shard_train_step(grad_step, mesh)
    out, metrics_ref = step(jax.device_put(dict(v), replicate_spec(mesh)),
                            shard_batch(mesh, batch), jax.random.key(0))
    out = jax.device_get(out)

    state = load_flax_variables(I2PNetProj(cfg, device="cpu"), v).state_dict()
    ranks = spawn(tmp_path, "step", "proj", dataclasses.asdict(cfg), state, batch, 1e-3)
    for r in ranks:
        for key in METRICS:
            np.testing.assert_allclose(n(r["metrics"][key]), n(metrics_ref[key]), rtol=1e-4,
                                       atol=1e-4, err_msg=key)
    _close_leaves(ranks[0]["grads"], flax_to_state_dict({"params": out["grads"]}), 1e-3,
                  "proj dp vs jax")
    for k, r in flax_to_state_dict({"batch_stats": out["batch_stats"]}).items():
        np.testing.assert_allclose(n(ranks[0]["buffers"][k]), r.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    # one optimizer update from the same averaged gradient on every rank
    for key in ("grads", "params", "buffers"):
        assert all(torch.equal(a, ranks[1][key][k]) for k, a in ranks[0][key].items()), key


@functools.cache
def _free_single():
    """The tiny free config's single-process f32 step at B=4 (dropout off),
    and the initial state dict."""
    cfg = dataclasses.replace(I2PNetConfig.tiny(), head_dropout_rate=0.0)
    torch.manual_seed(0)
    model = init_flax_(I2PNet(cfg, device="cpu"), torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(5)
    B = 4
    lidar = rng.uniform(-10, 10, size=(B, cfg.lidar_in_points, 3)).astype(np.float32)
    lidar[..., 2] += 20.0
    ang = 0.1
    batch = {
        "rgb": rng.normal(size=(B, 64, 128, 3)).astype(np.float32), "lidar": lidar,
        "intrinsic": np.tile(np.array([[[64.0, 0, 64], [0, 64.0, 32], [0, 0, 1]]], np.float32),
                             (B, 1, 1)),
        "decalib_q_gt": np.tile(np.array([[np.cos(ang / 2), 0, np.sin(ang / 2), 0]], np.float32),
                                (B, 1)),
        "decalib_t_gt": np.tile(np.array([[0.5, -0.2, 0.1]], np.float32), (B, 1)),
    }
    st = create_train_state(model, lr=1e-3, steps_per_epoch=10)
    metrics = make_train_step(model, cfg)(st, {k: t(a) for k, a in batch.items()})
    return cfg, state, batch, {
        "metrics": metrics, "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
        "params": {k: p.detach().clone() for k, p in model.named_parameters()},
        "buffers": {k: b.clone() for k, b in model.named_buffers()}}


def test_dp_free_train_step_matches_single_process(tmp_path):
    cfg, state, batch, ref = _free_single()
    ranks = spawn(tmp_path, "step", "free", dataclasses.asdict(cfg), state, batch, 1e-3)
    for r in ranks:
        for key in METRICS:
            np.testing.assert_allclose(n(r["metrics"][key]), n(ref["metrics"][key]), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    _close_leaves(ranks[0]["grads"], ref["grads"], 1e-3, "free dp vs single")
    for k, b in ref["buffers"].items():
        np.testing.assert_allclose(n(ranks[0]["buffers"][k]), n(b), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # (the updated parameters are not compared: Adam's first update is
    # lr * g / (|g| + eps), which turns a gradient of rounding size into a
    # full step of either sign)
    for key in ("grads", "params", "buffers"):
        assert all(torch.equal(a, ranks[1][key][k]) for k, a in ranks[0][key].items()), key
