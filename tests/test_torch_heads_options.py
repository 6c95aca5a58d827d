"""The free-point model's optional modules against the JAX package's, on
the CPU: the calibration-matrix projections (efgh), every CostVolume
option (``concat``/``cosine`` correlations, ``max_cost``,
``backward_fc``), every PoseHead option (``mlp1``/``mlp2`` with the three
correlations and the position embedding, the projection-mask input, the
sigmoid and maxhead variants), ``ProjectMask`` and ``delay_weight``; and
the cv1 gate, which must route the fused kernel exactly where JAX does.

Weights come from the JAX module's init (statistics randomised) through
``convert.py``'s strict load; inputs from a numpy seed. f32 at eval and in
training (batch statistics, then the running statistics): within 1e-5 (the
same arithmetic with sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.nn import heads as jheads
from i2pnet_tpu.nn.costvolume import CostVolume as JaxCostVolume
from i2pnet_tpu.ops import cv_pallas
from i2pnet_tpu.ops import quaternion as JQ
from i2pnet_tpu_torch.convert import flax_to_state_dict
from i2pnet_tpu_torch.nn.costvolume import CostVolume
from i2pnet_tpu_torch.nn.heads import PoseHead, ProjectMask, delay_weight
from i2pnet_tpu_torch.ops import cv_cuda
from i2pnet_tpu_torch.ops import quaternion as TQ
from _torch_util import n, port, randomize_stats, t

TOL = 1e-5


def _close(got, ref, tol=TOL, msg=""):
    ref = n(ref)
    np.testing.assert_allclose(n(got), ref, rtol=tol, atol=tol * max(1.0, float(np.abs(ref).max())),
                               err_msg=msg)


def _run_both(jmod, tmod, args, train: bool, jkw=None, tkw=None):
    """Eval, or one train-mode call: JAX's output (and new batch_stats)
    against the port module's (and its running statistics)."""
    v = randomize_stats(jmod.init(jax.random.key(0), *args, train=False, **(jkw or {})),
                        np.random.default_rng(1))
    tmod = port(tmod, v).train(train)
    if train:
        ref, state = jmod.apply(v, *args, train=True, mutable=["batch_stats"], **(jkw or {}))
    else:
        ref, state = jmod.apply(v, *args, train=False, **(jkw or {})), None
    targs = [None if a is None else t(a) for a in args]
    with torch.no_grad():
        got = tmod(*targs, **(tkw or {}))
    return got, ref, tmod, state


# ---- efgh projections ------------------------------------------------------------

def test_calib_projections_match_jax():
    rng = np.random.default_rng(0)
    xyz = (rng.uniform(-10, 10, size=(2, 64, 3)) + [0, 0, 20]).astype(np.float32)
    q = rng.normal(size=(2, 4)).astype(np.float32) * 0.05 + [1, 0, 0, 0]
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    tr = (0.3 * rng.normal(size=(2, 3))).astype(np.float32)
    calib = np.concatenate([rng.normal(size=(2, 3, 4)), np.tile([[[0, 0, 0, 1.0]]], (2, 1, 1))],
                           1).astype(np.float32)
    calib[:, :3, :3] += 50 * np.eye(3, dtype=np.float32)
    for c in (calib, calib[:, :3]):  # (B, 4, 4) and (B, 3, 4)
        for got, ref in ((TQ.project_with_calib(t(xyz), t(c)), JQ.project_with_calib(xyz, c)),
                         (TQ.warp_with_calib(t(xyz), t(q), t(tr), t(c)),
                          JQ.warp_with_calib(xyz, q, tr, c))):
            for g, r in zip(got, ref):
                _close(g, r, 1e-6)


# ---- the cost volume's options -------------------------------------------------

def _cv_inputs(seed=0, B=2, N=16, K=32, C=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N, 3)).astype(np.float32),
            rng.normal(size=(B, N, C)).astype(np.float32),
            rng.normal(size=(B, K, 3)).astype(np.float32),
            rng.normal(size=(B, K, C)).astype(np.float32),
            rng.uniform(1, 5, size=(B, N, 1)).astype(np.float32))


CV_OPTIONS = {
    "concat": dict(corr_func="concat"),
    "concat_q8": dict(corr_func="concat", nsample_q=8, backward_validation=False),
    "cosine": dict(corr_func="cosine"),
    "cosine_q8": dict(corr_func="cosine", nsample_q=8),
    "max_cost": dict(max_cost=True),
    "backward_fc": dict(backward_fc=True),
    "all": dict(corr_func="cosine", max_cost=True, backward_fc=True),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("option", sorted(CV_OPTIONS))
def test_cost_volume_option_matches_jax(option, train):
    kw = dict(nsample=4, nsample_q=-1, mlp1=(16, 8, 8), mlp2=(16, 8), backward_validation=True)
    kw.update(CV_OPTIONS[option])
    inputs = _cv_inputs()
    got, ref, cv, state = _run_both(JaxCostVolume(**kw), CostVolume(in_channels=16, **kw), inputs,
                                    train)
    assert tuple(got.shape) == ref.shape
    _close(got, ref, msg=option)
    if train:  # every running statistic moved as flax's did
        buffers = dict(cv.named_buffers())
        ref_stats = flax_to_state_dict({"batch_stats": state["batch_stats"]})
        assert set(ref_stats) == set(buffers)
        for name, r in ref_stats.items():
            _close(buffers[name], r, msg=name)


# the fused cv1 route's conditions: the base routes; each variant breaks one
GATE_CASES = {
    "base": {},
    "concat": dict(corr_func="concat"),
    "cosine": dict(corr_func="cosine"),
    "max_cost": dict(max_cost=True),
    "backward_fc": dict(backward_fc=True),
    "nsample_q": dict(nsample_q=8),
    "f32": dict(dtype=None),
    "train": dict(train=True),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_cv1_gate_routes_where_jax_fuses(case, monkeypatch):
    """Both packages at bf16 with their cv1 route on (JAX's in interpret
    mode): the port calls its fused cv1 exactly where JAX calls its own,
    and then launches nothing here (CPU: the plain version)."""
    kw = dict(nsample=4, nsample_q=-1, mlp1=(16, 8, 8), mlp2=(16, 8), backward_validation=True,
              dtype=jnp.bfloat16)
    kw.update(GATE_CASES[case])
    train = kw.pop("train", False)
    calls = {"jax": 0, "port": 0}
    jfused, tfused = cv_pallas.fused_cv1_eval, cv_cuda.fused_cv1_eval

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(cv_pallas, "fused_cv1_eval", count("jax", jfused))
    monkeypatch.setattr(cv_cuda, "fused_cv1_eval", count("port", tfused))
    monkeypatch.setenv("I2PNET_FUSED_CV", "interpret")
    inputs = _cv_inputs(1)
    jcv = JaxCostVolume(**kw)
    v = randomize_stats(jcv.init(jax.random.key(0), *inputs), np.random.default_rng(2))
    if train:
        jcv.apply(v, *inputs, train=True, mutable=["batch_stats"])
    else:
        jcv.apply(v, *inputs)
    tdtype = {None: None, jnp.bfloat16: torch.bfloat16}[kw.pop("dtype")]
    cv = port(CostVolume(in_channels=16, dtype=tdtype, **kw), v).train(train)
    before = cv_cuda.launches
    with torch.no_grad():
        cv(*map(t, inputs))
    assert cv_cuda.launches == before
    assert calls["port"] == calls["jax"] == (1 if case == "base" else 0)
    assert cv.fuses_cv1() == (case == "base")


# ---- the pose head's options ---------------------------------------------------

B, N, C, F = 2, 24, 16, 8


def _head_inputs(seed=0, mask_width=C):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N, C)).astype(np.float32),
            rng.normal(size=(B, N, mask_width)).astype(np.float32),
            rng.normal(size=(B, N, 3)).astype(np.float32) * 5,
            rng.normal(size=(B, N, F)).astype(np.float32))


HEAD_CASES = {
    f"{corr}{'_pos' if pos else ''}{'_mlp2' if mlp2 else ''}": dict(
        corr_func=corr, pos_embed=pos, mlp1=(16, 16), mlp2=(16,) if mlp2 else ())
    for corr in ("concat", "diff", "normalized_diff") for pos in (False, True)
    for mlp2 in (False, True)
}
HEAD_CASES.update({
    "projection_mask": dict(mask="logits"),
    "projection_mask_mlp2": dict(mask="logits", mlp1=(16, 16), mlp2=(16,)),
    "sigmoid": dict(mask="prob", sigmoid=True),
    "sigmoid_mlp1": dict(mask="prob", sigmoid=True, mlp1=(16, 16), pos_embed=True),
    "maxhead_mlp2": dict(maxhead=True, mlp1=(16, 16), mlp2=(16,), corr_func="diff"),
})


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_pose_head_option_matches_jax(case, train):
    kw = dict(mlp1=(), mlp2=(), corr_func="concat", pos_embed=False, sigmoid=False,
              maxhead=False)
    kw.update(HEAD_CASES[case])
    mask_kind = kw.pop("mask", None)
    pred, mask, xyz, feat = _head_inputs()
    rng = np.random.default_rng(3)
    pm = None
    if mask_kind == "logits":
        pm = rng.normal(size=(B, N, 2)).astype(np.float32)
    elif mask_kind == "prob":
        pm = rng.uniform(0, 1, size=(B, N, 1)).astype(np.float32)
    jhead = jheads.PoseHead(hidden=32, dropout_rate=0.0, **kw)
    thead = PoseHead(C, 32, mlp1=kw["mlp1"], mlp2=kw["mlp2"], sigmoid=kw["sigmoid"],
                     maxhead=kw["maxhead"], dropout_rate=0.0, corr_func=kw["corr_func"],
                     pos_embed=kw["pos_embed"], mask_channels=C, feature_channels=F)
    got, ref, thead, state = _run_both(jhead, thead, (pred, mask, xyz, feat, pm), train)
    for g, r, name in zip(got, ref, ("q", "t", "mask_p")):
        _close(g, r, msg=f"{case} {name}")
    if train and state:
        buffers = dict(thead.named_buffers())
        for name, r in flax_to_state_dict({"batch_stats": state["batch_stats"]}).items():
            _close(buffers[name], r, msg=name)


def test_sigmoid_pose_head_needs_a_mask():
    """JAX multiplies the prediction by the mask (a TypeError on None); the
    port raises TypeError too."""
    pred, mask, xyz, feat = _head_inputs()
    with pytest.raises(TypeError):
        jheads.PoseHead(mlp1=(), mlp2=(), hidden=8, sigmoid=True).init(
            jax.random.key(0), pred, mask, xyz, feat, None)
    with pytest.raises(TypeError, match="projection mask"):
        PoseHead(C, 8, sigmoid=True)(*map(t, (pred, mask, xyz, feat)))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("sigmoid", [False, True])
def test_project_mask_matches_jax(sigmoid, train):
    pred, _, _, feat = _head_inputs(4)
    got, ref, pmod, state = _run_both(jheads.ProjectMask((16, 8), sigmoid), ProjectMask(
        F + C, (16, 8), sigmoid), (feat, pred), train)
    assert tuple(got.shape) == ref.shape == (B, N, 1 if sigmoid else 2)
    _close(got, ref)
    if train:
        buffers = dict(pmod.named_buffers())
        for name, r in flax_to_state_dict({"batch_stats": state["batch_stats"]}).items():
            _close(buffers[name], r, msg=name)


@pytest.mark.parametrize("ab_delay", [False, True])
def test_delay_weight_matches_jax(ab_delay):
    rng = np.random.default_rng(5)
    gt = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=(B, N))]
    pred = rng.normal(size=(B, N, 2)).astype(np.float32)
    for step in (0.0, 37.0, 100.0):
        ref = jheads.delay_weight(gt, pred, jnp.float32(step), 100, ab_delay)
        got = delay_weight(t(gt), t(pred), torch.tensor(step), 100, ab_delay)
        _close(got, ref, 1e-6)
    assert delay_weight(None, t(pred), torch.tensor(1.0), 10) is not None
    assert torch.equal(delay_weight(t(gt), None, torch.tensor(1.0), 10), t(gt))
