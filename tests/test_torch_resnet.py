"""The port's ``ResNetEncoder`` and ``BasicBlock`` against the JAX package's
flax modules, with JAX's variables (random running statistics) loaded by
``load_flax_variables(strict=True)``, on the CPU.

Two layouts: one block a stage at widths (8, 8, 16, 16) on (2, 64, 128, 3),
and ResNet-18's stages (2, 2, 2, 2) on (2, 32, 64, 3). Bars: f32 eval
within 1e-5 x max(|ref|, 1); a training-mode forward and the running
statistics it leaves within 1e-4 x max(|ref|, 1); the parameter gradients
of a sum within ``GRAD_TOL`` = 5e-4 of each leaf's scale (its largest
magnitude, at least 1e-2 of the largest leaf's). The gradients pass back
through flax's fast variance, E[x^2] - E[x]^2, in every BatchNorm: on the
ResNet-18 layout JAX's own f32 gradients lie up to 1.3e-4 of a leaf from
its f64 ones, the port's up to 1.9e-4
(``test_train_gradients_against_f64``, ``--run-slow``), so two f32 runs
can be 3.2e-4 apart. bf16 eval within 2e-2 x max|ref| (the convolutions' bf16 roundings
fall at other points)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.nn.resnet import ResNetEncoder as JaxResNetEncoder
from i2pnet_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from i2pnet_tpu_torch.nn import BasicBlock, ResNetEncoder
from _torch_util import n, numpy_tree, randomize_stats, t

LAYOUTS = {
    "one_block": dict(stage_sizes=(1, 1, 1, 1), widths=(8, 8, 16, 16), shape=(2, 64, 128, 3)),
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), widths=(8, 8, 16, 16), shape=(2, 32, 64, 3)),
}
GRAD_TOL = 5e-4


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def setup(request):
    """(layout, input, JAX module, its variables with random statistics)."""
    lay = dict(LAYOUTS[request.param])
    shape = lay.pop("shape")
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jm = JaxResNetEncoder(**lay)
    v = randomize_stats(jm.init(jax.random.key(0), jnp.asarray(x), False),
                        np.random.default_rng(1))
    return lay, x, jm, v


def _port(lay, v, **kw):
    return load_flax_variables(ResNetEncoder(**lay, **kw), v)


def _close(got, ref, rel):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(n(g), np.asarray(r), rtol=0,
                                   atol=rel * max(float(np.abs(np.asarray(r)).max()), 1.0))


def test_eval_f32(setup):
    lay, x, jm, v = setup
    ref = jm.apply(v, jnp.asarray(x), False)
    with torch.no_grad():
        got = _port(lay, v).eval()(t(x))
    assert all(g.dtype == torch.float32 for g in got)
    _close(got, ref, 1e-5)


def test_eval_bf16(setup):
    lay, x, _, v = setup
    ref = JaxResNetEncoder(**lay, dtype=jnp.bfloat16).apply(v, jnp.asarray(x), False)
    with torch.no_grad():
        got = _port(lay, v, dtype=torch.bfloat16).eval()(t(x))
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(n(g), r, rtol=0, atol=2e-2 * np.abs(r).max())


def _cotangents(jm, v, x):
    shapes = [o.shape for o in jax.eval_shape(lambda: jm.apply(v, jnp.asarray(x), False))]
    return [np.random.default_rng(i).normal(size=s).astype(np.float32)
            for i, s in enumerate(shapes)]


def _jax_train(jm, v, x, cots, dtype=jnp.float32):
    """JAX's training-mode outputs, moved statistics and the gradients of
    sum(out * cot), in ``dtype``."""
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v)

    def loss(params):
        outs, state = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                               jnp.asarray(x, dtype), True, mutable=["batch_stats"])
        return sum(jnp.sum(o * jnp.asarray(c, dtype)) for o, c in zip(outs, cots)), (outs, state)

    (_, (outs, state)), grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
    return outs, state, flax_to_state_dict({"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), dict(grads))})


def _port_train(lay, v, x, cots):
    mod = _port(lay, v).train()
    got = mod(t(x))
    sum((o * t(c)).sum() for o, c in zip(got, cots)).backward()
    return mod, got


def _leaf_gaps(got, want):
    """Each leaf's max abs gap over its scale (its largest magnitude, at
    least 1e-2 of the largest leaf's)."""
    floor = 1e-2 * max(float(w.abs().max()) for w in want.values())
    return {k: float((got[k] - w).abs().max()) / max(float(w.abs().max()), floor)
            for k, w in want.items()}


def test_train_step(setup):
    """A training-mode forward (batch statistics), the running statistics it
    moves by flax's momentum rule, and the parameter gradients of
    sum(out * cot) over the three outputs."""
    lay, x, jm, v = setup
    cots = _cotangents(jm, v, x)
    ref, state, want = _jax_train(jm, v, x, cots)
    mod, got = _port_train(lay, v, x, cots)
    _close(got, ref, 1e-4)
    stats = flax_to_state_dict({"batch_stats": numpy_tree(state["batch_stats"])})
    buffers = dict(mod.named_buffers())
    assert set(stats) == set(buffers)
    _close([buffers[k] for k in sorted(stats)], [stats[k].numpy() for k in sorted(stats)], 1e-4)
    grads = {k: p.grad for k, p in mod.named_parameters()}
    assert set(want) == set(grads)
    gaps = _leaf_gaps(grads, want)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_TOL, (worst, gaps[worst])


@pytest.mark.skipif("not config.getoption('--run-slow', default=False)",
                    reason="needs --run-slow")
def test_train_gradients_against_f64(setup):
    """Where GRAD_TOL comes from: both f32 runs' gradients against JAX's in
    f64 (``jax.enable_x64``), each within GRAD_TOL of it, the distances
    printed."""
    lay, x, jm, v = setup
    cots = _cotangents(jm, v, x)
    want32 = _jax_train(jm, v, x, cots)[2]
    with jax.enable_x64(True):
        want64 = _jax_train(jm, v, x, cots, jnp.float64)[2]
    mod, _ = _port_train(lay, v, x, cots)
    port = max(_leaf_gaps({k: p.grad for k, p in mod.named_parameters()}, want64).values())
    jax32 = max(_leaf_gaps(want32, want64).values())
    print(f"{lay}: f32 gradients from JAX's f64 ones, largest gap a leaf: JAX {jax32:.3e}, "
          f"the port {port:.3e}")
    assert max(port, jax32) <= GRAD_TOL


def test_load_strict_maps_every_leaf(setup):
    lay, _, _, v = setup
    sd = flax_to_state_dict(v)
    mod = ResNetEncoder(**lay)
    assert set(sd) == set(mod.state_dict())
    load_flax_variables(mod, v)
    for k, p in mod.state_dict().items():
        assert torch.equal(p, sd[k]), k


@pytest.mark.parametrize("image,lay", [
    ((64, 128), dict(stage_sizes=(1, 1, 1, 1), widths=(8, 8, 16, 16))),
    ((64, 128), dict(stage_sizes=(1, 2, 1, 1), widths=(64, 64, 64, 64))),
    ((32, 8), dict(stage_sizes=(1, 1, 1, 1), widths=(8, 8, 16, 16))),
    ((16, 8), dict(stage_sizes=(1, 1, 1, 1), widths=(8, 8, 16, 16))),
    ((16, 16), dict(stage_sizes=(3, 4, 6, 3), widths=(64, 128, 256, 512))),
])
def test_downsample_as_flax_decides(image, lay):
    """flax builds a block's downsample from a shape test, the port for
    ``cin != width or stride != 1``: the same leaves wherever the maps stay
    larger than a pixel. Where a stride-2 block with equal widths meets a
    1-pixel map (16x8: 1x1 at the last stage), flax builds none, and loading
    its variables raises on the port's extra leaves instead of guessing."""
    x = jnp.zeros((1,) + image + (3,))
    v = jax.eval_shape(lambda: JaxResNetEncoder(**lay).init(jax.random.key(0), x, False))
    v = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), dict(v))
    names = set(flax_to_state_dict(v))
    port_names = set(ResNetEncoder(**lay).state_dict())
    if image != (16, 8):
        assert names == port_names
        load_flax_variables(ResNetEncoder(**lay), v)
        return
    assert port_names - names == {
        f"stage3_block0.downsample_{m}" for m in ("conv.weight", "bn.weight", "bn.bias",
                                                   "bn.running_mean", "bn.running_var")}
    assert names < port_names
    with pytest.raises(RuntimeError, match="Missing key"):
        load_flax_variables(ResNetEncoder(**lay), v)


@pytest.mark.parametrize("cin,width,strides,down", [
    (8, 8, 1, False), (8, 16, 1, True), (8, 8, 2, True), (16, 8, 2, True)])
def test_block_downsample_rule(cin, width, strides, down):
    """The downsample pair exists exactly for ``cin != width or strides !=
    1``, and the block maps (1, 8, 8, cin) to (1, 8 / strides, 8 / strides,
    width)."""
    block = BasicBlock(cin, width, strides).eval()
    assert (block.downsample_conv is not None) == down
    assert (block.downsample_bn is not None) == down
    with torch.no_grad():
        assert block(torch.ones(1, 8, 8, cin)).shape == (1, 8 // strides, 8 // strides, width)
