"""The f32 free-point train step on ``tests/test_train.py``'s batch at seed 1,
where the port's gradient and JAX's (op by op) differ by up to 4.8% of a
leaf's max on cost-volume leaves while the losses agree within 1e-7.

The gap is two LeakyReLU kinks. Two pre-activations, each a BatchNorm
output inside a ``PointwiseConv``, lie within f32 rounding of zero, and
the two frameworks round them to opposite signs:

- ``cost_volume2.pc_encoding.BatchNorm_0`` at (0, 33, 2, 7): port
  +8.2e-7, JAX -3.6e-6;
- ``cost_volume1.mlp2_convs.PointwiseConv_0.BatchNorm_0`` at
  (1, 54, 6, 10): port +1.5e-6, JAX -8.3e-6.

So the activation's derivative there is 1 on one side and 0.1 on the
other, and that one element's cotangent differs tenfold. The two tests
show that nothing else differs:

- Set the port's derivative at those elements to JAX's branch, and every
  leaf is within the plain step's bar of JAX's gradient.
- A second witness runs the port in f64. It puts the first value at
  +2.8e-6 (the port's side) and the second at -2.5e-6 (JAX's side). Set
  the f32 port's branches to the f64 run's, and every leaf is within the
  same bar of the f64 gradient.

So each framework's f32 step takes the wrong branch at one of the two
kinks, and the gradients agree everywhere else.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.train.step import _free_point_loss_fn as jax_loss_fn
from i2pnet_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from i2pnet_tpu_torch.models import I2PNet
from i2pnet_tpu_torch.models import i2pnet as port_i2pnet
from i2pnet_tpu_torch.nn import layers as port_layers
from i2pnet_tpu_torch.nn.layers import PointwiseConv
from i2pnet_tpu_torch.train.step import _free_point_loss_fn
from _torch_util import n
from test_torch_train import ABSORBED, _cfg, _init, _jcfg, _tbatch
from test_train import _synthetic_batch

SEED = 1
SLOPE = 0.1  # flax's leaky_relu slope in f32


@functools.cache
def _setup():
    cfg = _cfg("float32")
    batch = _synthetic_batch(cfg, seed=SEED)
    jm, v = _init(cfg, batch)
    return cfg, batch, jm, v


@functools.cache
def _jax_step():
    """JAX's gradient op by op, its metrics and every BatchNorm output (the
    pre-activations), read through flax's method interception."""
    cfg, batch, jm, v = _setup()
    lf = jax_loss_fn(jm, _jcfg(cfg))

    def loss(params):
        outs = {}

        def record(next_fun, args, kwargs, ctx):
            out = next_fun(*args, **kwargs)
            if ctx.method_name == "__call__" and isinstance(ctx.module, fnn.BatchNorm):
                key = ".".join(ctx.module.scope.path)
                assert key not in outs, key
                outs[key] = out
            return out

        with fnn.intercept_methods(record):
            value, (_, metrics) = lf(params, v["batch_stats"], batch, jax.random.key(0),
                                     jnp.int32(0))
        return value, (metrics, outs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I2PNET_FUSED_TRAIN", "interpret")
        with jax.disable_jit():
            grads, (metrics, outs) = jax.grad(loss, has_aux=True)(v["params"])
    grads = {k: g.numpy() for k, g in flax_to_state_dict({"params": grads}).items()}
    return grads, metrics, {k: np.asarray(o) for k, o in outs.items()}


def _leaky_norms(model):
    """{name: BatchNorm} of every PointwiseConv whose BatchNorm output goes
    through the LeakyReLU."""
    return {f"{name}.BatchNorm_0": m.BatchNorm_0 for name, m in model.named_modules()
            if isinstance(m, PointwiseConv) and m.BatchNorm_0 is not None
            and m.activation == "leaky"}


def _port_step(dtype=torch.float32, branch=None):
    """The port's step: (loss, metrics, gradients, every BatchNorm output).
    ``branch`` {name: bool array}: at the elements where it differs from the
    port's own branch (``x > 0``), the LeakyReLU's derivative is taken on
    ``branch``'s side instead."""
    cfg, batch, _, v = _setup()
    model = load_flax_variables(I2PNet(cfg, device="cpu"), v).train()
    tbatch = _tbatch(batch)
    if dtype == torch.float64:
        model = model.double()
        tbatch = {k: x.double() for k, x in tbatch.items()}
    leaky = _leaky_norms(model)
    outs, handles = {}, []

    def hook(name):
        def h(mod, inp, out):
            assert name not in outs and out.dtype == dtype, name
            outs[name] = out.detach().double().numpy().copy()
            if branch is not None and name in leaky:
                own, want = out.detach() > 0, torch.from_numpy(branch[name])
                # own derivative 1 or SLOPE -> the wanted one
                scale = torch.where(own == want, 1.0, torch.where(want, 1 / SLOPE, SLOPE))
                out.register_hook(lambda g: g * scale.to(g.dtype))
        return h

    for name, m in model.named_modules():
        if isinstance(m, port_layers.BatchNorm):
            handles.append(m.register_forward_hook(hook(name)))
    loss, metrics = _free_point_loss_fn(model, cfg)(tbatch, None)
    loss.backward()
    for h in handles:
        h.remove()
    grads = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    return loss, metrics, grads, outs, set(leaky)


def _assert_gradients_close(got, ref):
    """Every leaf within 1e-3 of its max (the plain f32 step's bar in
    tests/test_torch_train.py; absorbed biases skipped, as there)."""
    assert set(got) == set(ref)
    for name, r in ref.items():
        if ABSORBED.search(name):
            continue
        scale = float(np.max(np.abs(r))) + 1e-12
        np.testing.assert_allclose(got[name] / scale, r / scale, atol=1e-3, err_msg=name)


def _straddlers(outs, ref_outs, ref_positive):
    """{name: mask} of the pre-activations whose port branch (``x > 0``)
    differs from the reference's, every name with one."""
    out = {}
    for name, ref in ref_outs.items():
        mask = (outs[name] > 0) != ref_positive(ref)
        if mask.any():
            out[name] = mask
    return out


def test_seed1_gap_is_two_leaky_relu_kinks():
    """The loss and metrics within 1e-4 of JAX's; the pre-activations whose
    sign differs all feed a LeakyReLU and lie within 1e-4 of their layer's
    max of zero (the forward agrees to that bar, so the sign is noise);
    with the port's derivative there on JAX's branch (``x >= 0``), every
    leaf's gradient within 1e-3 of its max of JAX's."""
    jgrads, jmetrics, jouts = _jax_step()
    _, metrics, _, outs, leaky = _port_step()
    for key in ("loss", "loss_q", "loss_x", "loss_mask", "sx", "sq"):
        np.testing.assert_allclose(n(metrics[key]), n(jmetrics[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    assert set(outs) == set(jouts)
    straddle = _straddlers(outs, jouts, lambda r: r >= 0)
    assert set(straddle) <= leaky, sorted(straddle)
    for name, mask in straddle.items():
        scale = np.abs(jouts[name]).max()
        near = np.maximum(np.abs(outs[name]), np.abs(jouts[name]))[mask]
        assert (near <= 1e-4 * scale).all(), (name, near, scale)
    branch = {name: jouts[name] >= 0 for name in leaky}
    _, _, grads, _, _ = _port_step(branch=branch)
    _assert_gradients_close(grads, jgrads)


def test_seed1_f64_witness(monkeypatch):
    """The port in f64 (its f32 casts made no-ops for f64 tensors): every
    BatchNorm output is f64, and its values are within 1e-4 of their
    layer's max of the f32 run's. With the f32 port's LeakyReLU branches
    set to the f64 run's, every leaf is within 1e-3 of its max of the f64
    gradient; the elements that move are the f32 run's straddlers of zero."""
    _, _, _, outs32, _ = _port_step()
    to_float = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda self, *a, **k:
                        self if self.dtype == torch.float64 else to_float(self, *a, **k))
    bn_forward = port_layers.BatchNorm.forward
    monkeypatch.setattr(port_layers.BatchNorm, "forward", lambda self, x, dtype=None: bn_forward(
        self, x, dtype or (torch.float64 if x.dtype == torch.float64 else None)))
    grid = port_i2pnet.set_id_grid
    monkeypatch.setattr(port_i2pnet, "set_id_grid", lambda *a, **k: grid(*a, **k).double())
    loss64, _, grads64, outs64, leaky = _port_step(torch.float64)
    monkeypatch.undo()
    assert loss64.dtype == torch.float64  # and every BatchNorm output (_port_step)
    for name, o in outs64.items():
        scale = np.abs(o).max()
        np.testing.assert_allclose(outs32[name] / scale, o / scale, atol=1e-4, err_msg=name)
    straddle = _straddlers(outs32, outs64, lambda r: r > 0)
    assert set(straddle) <= leaky, sorted(straddle)
    _, _, grads, _, _ = _port_step(branch={name: outs64[name] > 0 for name in leaky})
    _assert_gradients_close(grads, grads64)

