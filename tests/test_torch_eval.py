"""The port's evaluation harness against the JAX package's, on the CPU.

- ``ops/se3.py`` against ``i2pnet_tpu.ops.se3`` in f32, within 1e-5
  relative, small angles (0 and below the 1e-5 branch) and angles near pi
  included;
- ``metrics.py`` function by function within 1e-6 relative (the numpy
  ones exactly);
- the checkpoints, the eval steps and ``set_seed``;
- the slice: JAX's ``Evaluator`` and the port's on the same in-memory
  dataset and converted weights, a 2-stage cascade in f32 on
  ``I2PNetConfig.tiny()`` and ``I2PNetProjConfig.tiny()``, a ragged last
  batch included: out3 per sample within 2e-4 (the bar of
  tests/test_torch_model.py), the summaries within what that bar allows
  (stated at the test), the prediction files parsed by both packages'
  ``analysis``, and the cascade equal to its hand-composed pair of forwards.
"""

import dataclasses
import functools
import glob
import math
import os
import random

import jax
import numpy as np
import pytest
import torch

from i2pnet_tpu import metrics as JM
from i2pnet_tpu.config import I2PNetConfig as JaxConfig
from i2pnet_tpu.config import I2PNetProjConfig as JaxProjConfig
from i2pnet_tpu.data import transforms as JT
from i2pnet_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from i2pnet_tpu.eval import Evaluator as JaxEvaluator
from i2pnet_tpu.eval import analysis as janalysis
from i2pnet_tpu.models import I2PNet as JaxI2PNet
from i2pnet_tpu.models import I2PNetProj as JaxI2PNetProj
from i2pnet_tpu.ops import se3 as jse3
from i2pnet_tpu_torch import metrics as M
from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
from i2pnet_tpu_torch.convert import flax_to_state_dict
from i2pnet_tpu_torch.data import BatchLoader
from i2pnet_tpu_torch.eval import Evaluator
from i2pnet_tpu_torch.eval import analysis
from i2pnet_tpu_torch.models import I2PNet, I2PNetProj
from i2pnet_tpu_torch.ops import fps_cuda, quaternion as Q, se3
from i2pnet_tpu_torch.losses import get_projection_gt
from i2pnet_tpu_torch.train import create_train_state, make_eval_step, make_eval_step_proj
from i2pnet_tpu_torch.train.checkpoint import CheckpointManager, restore_inference_variables
from i2pnet_tpu_torch.utils.seeding import set_seed
from _torch_util import n, port, randomize_stats, t

H, W = 64, 128


def _rotvecs(rng, k):
    axis = rng.normal(size=(k, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angles = np.concatenate([rng.uniform(0.01, 3.1, k - 6),
                             [0.0, 1e-7, 3e-6, 9e-6, math.pi - 5e-4, math.pi - 2e-4]])
    return (axis * angles[:, None]).astype(np.float32)


def _close(got, want, rtol):
    got, want = n(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(float(np.abs(want).max()), 1.0))


def test_se3_matches_jax():
    rng = np.random.default_rng(0)
    w = _rotvecs(rng, 40)
    xi = np.concatenate([w, rng.normal(size=(40, 3)).astype(np.float32) * 3], -1)
    xi_b = np.concatenate([_rotvecs(rng, 40), rng.normal(size=(40, 3)).astype(np.float32)], -1)
    _close(se3.hat(t(w)), jse3.hat(w), 0)
    _close(se3.vee(se3.hat(t(w))), w, 0)
    for name in ("so3_exp", "_left_jacobian", "_left_jacobian_inv"):
        _close(getattr(se3, name)(t(w)), getattr(jse3, name)(w), 1e-5)
    R = np.asarray(jse3.so3_exp(w))
    _close(se3.so3_log(t(R)), jse3.so3_log(R), 1e-5)
    T = np.asarray(jse3.se3_exp(xi))
    _close(se3.se3_exp(t(xi)), T, 1e-5)
    _close(se3.se3_log(t(T)), jse3.se3_log(T), 1e-5)
    _close(se3.se3_inverse(t(T)), jse3.se3_inverse(T), 1e-5)
    _close(se3.se3_geodesic_sq_dist(t(xi), t(xi_b)), jse3.se3_geodesic_sq_dist(xi, xi_b), 1e-5)


def _qmul(a, b):
    aw, ax, ay, az = a.T
    bw, bx, by, bz = b.T
    return np.stack([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw], -1)


def _poses(rng, B):
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q.astype(np.float32), rng.normal(size=(B, 3)).astype(np.float32)


def test_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    B = 16
    out3 = np.concatenate(_poses(rng, B), -1)
    q_gt, t_gt = _poses(rng, B)
    init = np.concatenate([JM.quat_to_rotmat_batch(_poses(rng, B)[0]),
                           rng.normal(size=(B, 3, 1)) * 5], -1).astype(np.float32)
    exact = lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b))  # noqa: E731
    for a, b in zip(M.get_extrinsic(out3, q_gt, t_gt, init, out_raw=True),
                    JM.get_extrinsic(out3, q_gt, t_gt, init, out_raw=True)):
        exact(a, b)
    pred_E, gt_E, pred_raw, gt_raw = M.get_extrinsic(out3, q_gt, t_gt, init, out_raw=True)
    exact(M.quat_to_rotmat_batch(q_gt), JM.quat_to_rotmat_batch(q_gt))
    exact(M.inv_extrinsic(pred_E), JM.inv_extrinsic(pred_E))
    exact(M.mult_extrinsic_batch(pred_E, gt_E), JM.mult_extrinsic_batch(pred_E, gt_E))
    singular = np.array([[[0.0, 0, 1], [0, 1, 0], [-1, 0, 0]]])  # pitch 90 deg
    for Rs in (pred_E[:, :, :3], singular):
        exact(M.rotmat_to_euler(Rs, "deg"), JM.rotmat_to_euler(Rs, "deg"))
    for a, b in zip(M.calibration_error_batch(pred_E, gt_E), JM.calibration_error_batch(pred_E, gt_E)):
        exact(a, b)
    for a, b in zip(M.rte_rre(pred_E, gt_E), JM.rte_rre(pred_E, gt_E)):
        exact(a, b)
    exact(M.cal_rete_once(out3, q_gt, t_gt), JM.cal_rete_once(out3, q_gt, t_gt))
    exact(M.quaternion_distance(out3[:, :4], q_gt), JM.quaternion_distance(out3[:, :4], q_gt))
    R = JM.quat_to_rotmat_batch(out3[:, :4])
    for a, b in zip(M.get_extrinsic_rt(R, out3[:, 4:], q_gt, t_gt, init),
                    JM.get_extrinsic_rt(R, out3[:, 4:], q_gt, t_gt, init)):
        exact(a, b)
    logits = rng.normal(size=(B, 20, 2))
    labels = rng.integers(0, 2, size=(B, 20))
    exact(M.eval_acc(logits, labels), JM.eval_acc(logits, labels))
    exact(M.eval_acc(logits[..., :1], labels, sigmoid=True),
          JM.eval_acc(logits[..., :1], labels, sigmoid=True))
    # the Lie maps, f32 in both packages: 1e-6 relative on every row whose
    # predicted rotation lies within 150 deg of the ground truth's. Toward
    # 180 deg the log map's arccos amplifies the packages' f32 roundings (the
    # matrix products sum in other orders): on these poses msee differs by
    # 4.1e-6 relative at 167 deg and 1.7e-5 at 175 deg, so the rows from
    # 150 deg on are held at 5e-5
    gt_se3 = M.extrinsic_to_se3(gt_raw)
    _close(gt_se3, JM.extrinsic_to_se3(gt_raw), 1e-6)
    axis = rng.normal(size=(B, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    half = np.linspace(0, np.pi / 4, B)  # turns of up to 90 deg
    turn = np.concatenate([np.cos(half)[:, None], np.sin(half)[:, None] * axis], -1)
    near = np.concatenate([_qmul(q_gt, turn), out3[:, 4:]], -1).astype(np.float32)
    far = np.degrees(JM.quaternion_distance(out3[:, :4], q_gt)) >= 150.0
    assert 0 < far.sum() < B
    for pred, rows, rtol in ((near, slice(None), 1e-6), (out3, ~far, 1e-6), (out3, far, 5e-5)):
        pred_raw = M.get_extrinsic(pred, q_gt, t_gt, init, out_raw=True)[2]
        msee = M.eval_msee(pred, gt_se3, pred_E=pred_raw)
        _close(msee[rows], JM.eval_msee(pred, gt_se3, pred_E=pred_raw)[rows], rtol)
        _close(M.eval_msee(pred, gt_se3), msee, 1e-6)
        _close(M.eval_mrr(msee, gt_se3)[rows], JM.eval_mrr(msee, gt_se3)[rows], rtol)
    assert np.degrees(JM.quaternion_distance(near[:, :4], q_gt)).max() <= 90.01
    rre, rte = JM.rte_rre(pred_E, gt_E)
    th = (float(np.quantile(rre, 0.8)), float(np.quantile(rte, 0.8)))  # some pass, some not
    for threshold in (False, True):
        ours, ref = M.RteRreEval(threshold, *th), JM.RteRreEval(threshold, *th)
        for half in (slice(0, 8), slice(8, 16)):
            assert ours.add_batch(pred_E[half], gt_E[half]) == ref.add_batch(pred_E[half], gt_E[half])
        assert ours.eval_seq() == ref.eval_seq() and ours.get_recall() == ref.get_recall()
        assert 0 < ours.get_recall() < 1 or not threshold
        ours.save_metric(str(tmp_path / "a.npz"))
        ref.save_metric(str(tmp_path / "b.npz"))
        assert analysis.recall_analysis(str(tmp_path / "a.npz")) == \
            janalysis.recall_analysis(str(tmp_path / "b.npz"))


def _tiny_model(seed=0):
    torch.manual_seed(seed)
    return I2PNet(I2PNetConfig.tiny(), device="cpu")


def test_checkpoint_manager_roundtrip(tmp_path):
    from i2pnet_tpu_torch.train import create_train_state

    model = _tiny_model()
    state = create_train_state(model)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    for step in (1, 2, 3):
        state.step = step
        mgr.save(step, state, meta={"epoch": step})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "torch" / "ckpt")) == ["2.pt", "3.pt"]
    restored, meta = mgr.restore()
    assert meta == {"epoch": 3} and restored["step"] == 3
    sd = model.state_dict()
    assert restored["model"].keys() == sd.keys()
    assert all(torch.equal(restored["model"][k], sd[k]) for k in sd)
    assert mgr.restore(2)[0]["step"] == 2

    other = _tiny_model(1)
    mgr.save_best("model_rotation_best", {"model": other.state_dict()})
    got = restore_inference_variables(str(tmp_path), model)
    assert all(torch.equal(got[k], v) for k, v in other.state_dict().items())
    assert torch.equal(restore_inference_variables(str(tmp_path), model, "latest")["sx"], sd["sx"])
    with pytest.warns(UserWarning, match="model_msee_best"):
        got = restore_inference_variables(str(tmp_path), model, "model_msee_best")
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    with pytest.raises(ValueError, match="does not fit"):
        restore_inference_variables(str(tmp_path), I2PNetProj(I2PNetProjConfig.tiny(), device="cpu"))


def test_eval_steps_and_seed():
    model = _tiny_model().train()
    rng = np.random.default_rng(0)
    rgb = t(rng.normal(size=(2, H, W, 3)).astype(np.float32))
    lidar = t((rng.uniform(-5, 5, size=(2, 512, 3)) + [0, 0, 12]).astype(np.float32))
    intr = t(np.tile(np.array([[[64.0, 0, 64], [0, 64.0, 32], [0, 0, 1]]], np.float32), (2, 1, 1)))
    out = make_eval_step(model, model.cfg)({"rgb": rgb, "lidar": lidar, "intrinsic": intr})
    assert not model.training and out["out3"].is_inference()
    with torch.no_grad():
        ref = model(rgb, lidar, intr)
    assert torch.equal(out["out3"], ref["out3"]) and torch.equal(out["out4"], ref["out4"])
    # a trainer's step (with its state) under ground_truth_projection_mask_eval
    # feeds the model the batch's in-frustum labels, computed on the device
    cfg = dataclasses.replace(model.cfg, ground_truth_projection_mask_eval=True)
    gt_q = t(np.tile(np.array([[1.0, 0.0, 0.0, 0.0]], np.float32), (2, 1)))
    gt_t = t(np.tile(np.array([[0.3, -0.1, 0.2]], np.float32), (2, 1)))
    batch = {"rgb": rgb, "lidar": lidar, "intrinsic": intr, "decalib_q_gt": gt_q,
             "decalib_t_gt": gt_t}
    out = make_eval_step(model, cfg, create_train_state(model))(batch)
    gt = torch.nn.functional.one_hot(
        get_projection_gt(lidar, intr, (H, W), gt_q, gt_t).long(), 2).float()
    with torch.no_grad():
        masked = model(rgb, lidar, intr, gt_project=gt)
    assert torch.equal(out["out3"], masked["out3"]) and not torch.equal(out["out3"], ref["out3"])

    pmodel = I2PNetProj(I2PNetProjConfig.tiny(), device="cpu")
    raw = t((rng.normal(size=(2, 512, 3)) * 10).astype(np.float32))
    pout = make_eval_step_proj(pmodel, pmodel.cfg)(
        {"rgb": rgb, "lidar": raw, "raw_xyz": raw, "intrinsic": intr})
    with torch.no_grad():
        assert torch.equal(pout["out3"], pmodel(rgb, raw, raw, intr)["out3"])

    draws = []
    for _ in range(2):
        set_seed(7)
        draws.append((random.random(), np.random.rand(), float(torch.rand(1))))
    assert draws[0] == draws[1]


class MemoryDataset:
    """In-memory samples with the loader's keys: a cloud decalibrated by a
    seeded pose (its tail zero for the proj family), gt = its inverse."""

    def __init__(self, count, points, zero_tail, seed=0):
        rng = np.random.default_rng(seed)
        k = np.array([[64.0, 0, 64], [0, 64.0, 32], [0, 0, 1]], np.float32)
        self.samples = []
        for i in range(count):
            raw = rng.uniform(-5, 5, size=(points, 3)).astype(np.float32) + [0, 0, 12]
            if zero_tail:
                raw[points // 2:] = 0.0
            Pr = JT.generate_random_transform(rng, 0.5, 0.1, 0.5, 0.05, 0.2, 0.05, clip_tz=False)
            q, tr = JT.decalib_ground_truth(np.linalg.inv(Pr)[:3])
            lidar = (raw @ Pr[:3, :3].T + Pr[:3, 3]) * (np.sum(raw**2, -1, keepdims=True) > 0)
            self.samples.append(dict(
                rgb=rng.normal(size=(H, W, 3)).astype(np.float32),
                lidar=lidar.astype(np.float32), raw_point_xyz=raw.astype(np.float32),
                init_intrinsic=k, init_extrinsic=Pr[:3].astype(np.float32),
                decalib_real_gt=q, decalib_dual_gt=tr, path_info="07 %06d %06d" % (i, i)))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _record(monkeypatch, module, log):
    real = module.get_extrinsic

    def recording(out3, *a, **k):
        log.append(np.array(out3))
        return real(out3, *a, **k)

    monkeypatch.setattr(module, "get_extrinsic", recording)


FAMILIES = {
    "free": (JaxConfig.tiny(), JaxI2PNet, I2PNetConfig, I2PNet, 512, False),
    "proj": (JaxProjConfig.tiny(), JaxI2PNetProj, I2PNetProjConfig, I2PNetProj, 512, True),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_evaluator_matches_jax(family, tmp_path, monkeypatch):
    jcfg, JaxModel, Cfg, Model, points, proj = FAMILIES[family]
    ds = MemoryDataset(5, points, zero_tail=proj)
    s = ds[0]
    args = [s["rgb"][None], s["lidar"][None]] + ([s["raw_point_xyz"][None]] if proj else []) \
        + [s["init_intrinsic"][None]]
    jmodel = JaxModel(jcfg)
    init = jax.jit(functools.partial(jmodel.init, train=False))
    rng = np.random.default_rng(2)
    variables = [randomize_stats(init(jax.random.key(k), *args), rng) for k in (0, 1)]
    cfg = Cfg(**dataclasses.asdict(jcfg))
    models = [port(Model(cfg, device="cpu"), v) for v in variables]

    jlog, plog = [], []
    _record(monkeypatch, JM, jlog)
    _record(monkeypatch, M, plog)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    # the proj levels on the route the port takes at eval (the dense one)
    monkeypatch.setenv("I2PNET_PROJ_DENSE_EVAL", "interpret")
    jsum = JaxEvaluator(jmodel, jcfg, [v["params"] for v in variables],
                        [v.get("batch_stats", {}) for v in variables], proj=proj,
                        log_dir=jdir).validate(JaxBatchLoader(ds, 2, shuffle=False, drop_last=False))
    counts = fps_cuda.launches
    ev = Evaluator(models, cfg, proj=proj, log_dir=pdir, device="cpu")
    psum = ev.validate(BatchLoader(ds, 2, shuffle=False, drop_last=False))
    assert fps_cuda.launches == counts  # CPU: the plain versions

    assert [a.shape for a in plog] == [a.shape for a in jlog] == [(2, 7), (2, 7), (1, 7)]
    out3, ref3 = np.concatenate(plog), np.concatenate(jlog)
    assert float(np.abs(out3 - ref3).max()) <= 2e-4
    assert psum.keys() == jsum.keys() and psum["count"] == jsum["count"] == 5
    assert psum["timing_includes_compile"] == jsum["timing_includes_compile"] is False
    # out3 within 2e-4 moves a rotation by < 1e-3 rad: 0.06 deg, summed over
    # three Euler angles for RRE; translations by < 1e-3 m (the clouds sit
    # ~12 m out, the decalibrations are small); msee by 1e-2 relative
    for key in ("rre_mean", "rre_std", "roll_deg", "pitch_deg", "yaw_deg"):
        assert abs(psum[key] - jsum[key]) <= 0.2, key
    for key in ("rte_mean", "rte_std", "x_m", "y_m", "z_m"):
        assert abs(psum[key] - jsum[key]) <= 1e-3, key
    assert abs(psum["msee"] - jsum["msee"]) <= 1e-2 * max(abs(jsum["msee"]), 1e-3)

    # either package's analysis reads either's files
    files = {d: os.path.join(d, "prediction.txt") for d in (jdir, pdir)}
    parsed = {d: analysis.parse_prediction_file(f) for d, f in files.items()}
    for d, f in files.items():
        jp = janalysis.parse_prediction_file(f)
        assert all(np.array_equal(jp[k], parsed[d][k]) for k in ("init", "pred", "gt"))
    np.testing.assert_array_equal(parsed[pdir]["init"], parsed[jdir]["init"])
    np.testing.assert_array_equal(parsed[pdir]["gt"], parsed[jdir]["gt"])
    assert analysis.prediction_file_metrics(files[pdir])["count"] == 5
    with open(files[pdir]) as f:
        head = f.read().splitlines()[:4]
    assert head[0] == "§ 07 000000 000000" and head[1].startswith("init ")
    assert len(head[1].split()[1].split(".")[1]) == 9
    for d in (jdir, pdir):
        (npz,) = glob.glob(os.path.join(d, "metrics_*.npz"))
        assert analysis.recall_analysis(npz)["count"] == janalysis.recall_analysis(npz)["count"] == 5
        with open(os.path.join(d, "log_test.txt")) as f:
            assert [kv.split("=")[0] for kv in f.read().split()] == list(jsum)

    # the cascade is its hand-composed pair of forwards, bit for bit
    mb = {"rgb": t(ds[0]["rgb"][None]), "lidar": t(ds[0]["lidar"][None]),
          "intrinsic": t(ds[0]["init_intrinsic"][None]), "raw_xyz": t(ds[0]["raw_point_xyz"][None])}
    with torch.no_grad():
        call = (lambda m, lid: m(mb["rgb"], lid, mb["raw_xyz"], mb["intrinsic"])) if proj else \
            (lambda m, lid: m(mb["rgb"], lid, mb["intrinsic"], raw_xyz=mb["raw_xyz"]))
        o1 = call(models[0], mb["lidar"])["out3"]
        o2 = call(models[1], Q.warp_points(mb["lidar"], o1[:, :4], o1[:, 4:]))["out3"]
        q, tr = Q.compose_pose(o2[:, :4], o2[:, 4:], o1[:, :4], o1[:, 4:])
    assert torch.equal(ev.cascade(mb), torch.cat([q, tr], 1))


def test_evaluator_refuses_what_is_not_ported():
    """The data-parallel fan-out raises, naming its ROADMAP item (vis_rate
    runs: tests/test_torch_visualize.py)."""
    model = _tiny_model()
    with pytest.raises(NotImplementedError, match="item 9"):
        Evaluator([model], model.cfg, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Evaluator([model], model.cfg)


def test_evaluator_debug_nans(tmp_path):
    model = _tiny_model()
    with torch.no_grad():
        model.sx.fill_(0)
        for p in model.l3_head.parameters():
            p.fill_(float("nan"))
    ds = MemoryDataset(2, 512, zero_tail=False)
    with pytest.raises(FloatingPointError, match="out3 at cascade stage 0, batch 0"):
        Evaluator([model], model.cfg, log_dir=str(tmp_path), device="cpu",
                  debug_nans=True).validate(BatchLoader(ds, 2, shuffle=False))


def test_flax_snapshot_loads_through_the_checkpoints(tmp_path):
    """A converted best snapshot restores into the model strictly."""
    jcfg = JaxConfig.tiny()
    ds = MemoryDataset(1, 512, zero_tail=False)
    s = ds[0]
    v = jax.jit(functools.partial(JaxI2PNet(jcfg).init, train=False))(
        jax.random.key(3), s["rgb"][None], s["lidar"][None], s["init_intrinsic"][None])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_best("model_rotation_best", {"model": flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, dict(v)))})
    model = _tiny_model()
    model.load_state_dict(restore_inference_variables(str(tmp_path), model), strict=True)
    np.testing.assert_array_equal(n(model.sx), np.asarray(v["params"]["sx"]))
