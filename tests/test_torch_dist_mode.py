"""``dist_mode`` (the reference's distance-only backbone: each neighbour's
distance to the centre as the level's only input channel) in the port's
``ProjectPointNet`` and ``ProjSetUpconv`` against the JAX modules, with the
same (perturbed, converted) weights, on the CPU.

``ProjectPointNet`` runs both routes: at eval the dense one (the port's
select kernel takes its plain version on CPU tensors; JAX runs its Pallas
select kernel in interpret mode), in training the gathered one, forward
and gradients. The forward bars are tests/test_torch_proj_modules.py's:
f32 within ``TOL`` = 1e-5, bf16 2e-2. Every parameter gradient within
``GRAD_TOL`` = 1e-4 of the largest gradient of the module (at least 1),
the input's of its own: a Dense bias before a batch-statistics
normalisation has a true-zero gradient, and both packages leave rounding
noise there, up to 7e-5 of the largest leaf. The query's own pixel is one of its candidates, so
a zero distance sits in every window: its gradient must be 0, not NaN,
through ``safe_norm``, in the input's gradient too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.nn.proj_backbone import ProjectPointNet as JaxProjectPointNet
from i2pnet_tpu.nn.proj_backbone import ProjSetUpconv as JaxProjSetUpconv
from i2pnet_tpu_torch.convert import flax_to_state_dict
from i2pnet_tpu_torch.nn.proj_backbone import ProjectPointNet, ProjSetUpconv
from i2pnet_tpu_torch.ops import select_cuda
from _torch_util import n, port, t
from test_torch_proj_modules import LEVEL, TOL, _check, _grids, _perturb

UPCONV = dict(out_h=8, out_w=16, stride_h=1, stride_w=2, kernel_size=(3, 3), nsample=4,
              distance=2.0, mlp=(8,), mlp2=(8,))
DENSE = {"I2PNET_PROJ_DENSE_EVAL": "interpret"}
GRAD_TOL = 1e-4


def _upconv_inputs(with_feat1=True):
    rng = np.random.default_rng(2)
    xyz1_raw, xyz1, f1 = _grids(2, C=6)
    f2 = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)
    return (xyz1_raw, xyz1_raw[:, :, ::2].copy(), xyz1, xyz1[:, :, ::2].copy(),
            f1 if with_feat1 else None, f2)


def _check_grads(jax_module, torch_module, inputs, call_kw):
    """Training-mode forward and backward of sum(new_feat * cot) in both
    packages: the outputs, every parameter's gradient and the first input's
    (the raw grid's)."""
    v = _perturb(jax_module.init(jax.random.key(0), *inputs, **call_kw))
    first, rest = jnp.asarray(inputs[0]), inputs[1:]

    def feat_of(params, x0):
        out = jax_module.apply({"params": params}, x0, *rest, **call_kw, train=True)
        return out[-1] if isinstance(out, tuple) else out

    def loss(params, x0):
        feat = feat_of(params, x0)
        return jnp.sum(feat * cot), feat

    shape = jax.eval_shape(feat_of, v["params"], first).shape
    cot = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    (_, ref), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        v["params"], first)
    mod = port(torch_module, v).train()
    x0 = t(inputs[0]).requires_grad_()
    out = mod(x0, *[None if a is None else t(a) for a in rest], **call_kw)
    feat = out[-1] if isinstance(out, tuple) else out
    (feat * t(cot)).sum().backward()
    np.testing.assert_allclose(n(feat), np.asarray(ref), rtol=TOL, atol=TOL)
    want = flax_to_state_dict({"params": gp})
    got = {k: p.grad for k, p in mod.named_parameters()}
    assert set(got) == set(want)
    scale = max(max(float(np.abs(r).max()) for r in want.values()), 1.0)
    for k, g in got.items():
        np.testing.assert_allclose(n(g), want[k].numpy(), rtol=0, atol=GRAD_TOL * scale, err_msg=k)
    assert torch.isfinite(x0.grad).all()
    np.testing.assert_allclose(n(x0.grad), np.asarray(gx), rtol=0,
                               atol=GRAD_TOL * max(float(jnp.abs(gx).max()), 1.0))


@pytest.mark.parametrize("route,dtype", [("dense", None), ("dense", "bfloat16"),
                                         ("gathered", None)])
def test_project_pointnet_dist_mode(route, dtype):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype else (None, None)
    before = select_cuda.launches
    _check(JaxProjectPointNet(dtype=jdt, **LEVEL), ProjectPointNet(in_channels=1, dtype=tdt,
                                                                   **LEVEL),
           _grids(1), {"dist_mode": True}, train=route == "gathered", env=DENSE,
           tol=2e-2 if dtype else TOL)
    assert select_cuda.launches == before  # CPU: the plain version


def test_project_pointnet_dist_mode_dense_equals_gathered():
    """At eval the dense route gives the gathered route's features (f32, the
    dense tests' bar): the same level with the route switch off."""
    v = _perturb(JaxProjectPointNet(**LEVEL).init(jax.random.key(0), *_grids(1), dist_mode=True))
    mod = port(ProjectPointNet(in_channels=1, **LEVEL), v)
    inputs = [t(a) for a in _grids(1)]
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        dense = mod(*inputs, dist_mode=True)[2]
        mp.setenv("I2PNET_PROJ_DENSE_EVAL", "0")
        gathered = mod(*inputs, dist_mode=True)[2]
    np.testing.assert_allclose(n(dense), n(gathered), rtol=TOL, atol=TOL)


def test_project_pointnet_dist_mode_gradients():
    _check_grads(JaxProjectPointNet(**LEVEL), ProjectPointNet(in_channels=1, **LEVEL), _grids(1),
                 {"dist_mode": True})


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("with_feat1", [True, False])
def test_proj_set_upconv_dist_mode(with_feat1, train):
    _check(JaxProjSetUpconv(**UPCONV),
           ProjSetUpconv(feat2_channels=5, feat1_channels=6 if with_feat1 else 0, dist_mode=True,
                         **UPCONV),
           _upconv_inputs(with_feat1), {"dist_mode": True}, train=train)


def test_proj_set_upconv_dist_mode_gradients():
    _check_grads(JaxProjSetUpconv(**UPCONV),
                 ProjSetUpconv(feat2_channels=5, feat1_channels=6, dist_mode=True, **UPCONV),
                 _upconv_inputs(), {"dist_mode": True})


def test_width_mismatch_raises():
    """The modes are call-time flags, the widths fixed at construction: a
    call that needs another width raises ValueError on either route."""
    inputs = [t(a) for a in _grids(1)]
    dist_level = ProjectPointNet(in_channels=1, **LEVEL)
    center_level = ProjectPointNet(in_channels=10, **LEVEL)
    for train in (False, True):
        for mod, modes in ((dist_level, {"center_mode": True}), (dist_level, {}),
                           (center_level, {"dist_mode": True})):
            with pytest.raises(ValueError):
                mod.train(train)(*inputs, **modes)
    up = _upconv_inputs()
    ups = [None if a is None else t(a) for a in up]
    with pytest.raises(ValueError):
        ProjSetUpconv(feat2_channels=5, feat1_channels=6, dist_mode=True, **UPCONV)(*ups)
    with pytest.raises(ValueError):
        ProjSetUpconv(feat2_channels=5, feat1_channels=6, **UPCONV)(*ups, dist_mode=True)
    # center mode takes precedence over dist mode, as in JAX
    with torch.no_grad():
        center_level.eval()(*inputs, center_mode=True, dist_mode=True)
