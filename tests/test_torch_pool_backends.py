"""The port's pool backwards against the JAX package's, on the CPU: ``bn_pool``
on each of its four backends (``I2PNET_POOL_BWD``), the plain versions of
its no-tap forward and recompute backward, ``max_pool_3x3``'s routed
(``I2PNET_POOL_PALLAS=1``) and all-ties (``I2PNET_POOL_ALLTIES=1``)
backwards, and the bf16 ``RGBEncoderStage`` in training on the native chain
(``I2PNET_FUSED_TRAIN=0``), with and without the routed pool.

One environment variable selects the route in both packages, as JAX's own
tests set it. JAX runs its Pallas kernels in interpret mode; the port its
plain versions (the launch counters stay put). Bars are those of
``tests/test_conv_pallas_train.py`` and ``tests/test_layers.py`` unless
stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.nn.layers import RGBEncoderStage as JaxRGBEncoderStage
from i2pnet_tpu.nn.layers import _pool3_allties
from i2pnet_tpu.nn.layers import max_pool_3x3 as jax_max_pool_3x3
from i2pnet_tpu.ops.conv_pallas_train import bn_pool as jax_bn_pool
from i2pnet_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from i2pnet_tpu_torch.nn import layers
from i2pnet_tpu_torch.nn.layers import RGBEncoderStage
from i2pnet_tpu_torch.ops import conv_train_cuda as ct
from i2pnet_tpu_torch.ops import pool_route_cuda
from _torch_util import n, randomize_stats, t

BF = torch.bfloat16


def _bf(a):
    """numpy -> bf16-exact f32 numpy."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _counts():
    return dict(ct.launches), dict(pool_route_cuda.launches)


# tests/test_conv_pallas_train.py::BN_CASES, each with its backend, and
# two tie cases on the native backend: both max trees halve a tie alike
BN_CASES = [
    (2, 16, 32, 8, 1, False, "pallas"),
    (2, 16, 32, 8, 2, False, "pallas"),
    (2, 16, 32, 8, 1, True, "pallas"),
    (2, 16, 32, 8, 2, True, "pallas"),
    (1, 16, 32, 16, 2, False, "pallas"),
    (1, 16, 64, 32, 2, False, "pallas"),
    (2, 16, 32, 8, 1, False, "native"),
    (2, 16, 32, 8, 2, False, "native"),
    (1, 16, 64, 32, 2, False, "native"),
    (2, 16, 32, 8, 1, True, "native"),
    (2, 16, 32, 8, 2, True, "native"),
    (1, 8, 16, 128, 2, False, "pallas"),
    (2, 16, 32, 8, 1, True, "sas"),
    (2, 16, 32, 8, 2, True, "sas"),
    (1, 16, 64, 32, 2, False, "sas"),
    (2, 16, 32, 8, 1, False, "idx"),
    (2, 16, 32, 8, 2, False, "idx"),
    (2, 16, 32, 8, 1, True, "idx"),
    (2, 16, 32, 8, 2, True, "idx"),
    (1, 16, 32, 16, 2, False, "idx"),
    (1, 16, 64, 32, 2, False, "idx"),
    (1, 8, 16, 128, 2, False, "idx"),
]


def _bn_inputs(B, H, W, cout, stride, ties, bwd):
    """The inputs of the JAX test: tie-free windows for native without
    ties (values (h*W + w) mod 19), quarter-halves for ties."""
    rng = np.random.default_rng(1)
    if bwd == "native" and not ties:
        k = np.arange(H * W).reshape(H, W)
        y = np.broadcast_to(((k % 19) * 0.15 - 1.2)[None, :, :, None], (B, H, W, cout)) + np.arange(cout) * 0.003
    elif ties:
        y = np.round(rng.standard_normal((B, H, W, cout)) * 2) / 2
    else:
        y = rng.standard_normal((B, H, W, cout))
    y = _bf(y)
    sc = rng.uniform(0.5, 1.5, (cout,)).astype(np.float32)
    sh = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    g = _bf(rng.standard_normal((B, H // stride, W // stride, cout)))
    return y, sc, sh, g


def _port_bn_pool(y, sc, sh, g, stride, bwd, monkeypatch):
    monkeypatch.setenv("I2PNET_POOL_BWD", bwd)
    yt = t(y).to(BF).requires_grad_()
    sct, sht = t(sc).requires_grad_(), t(sh).requires_grad_()
    out = ct.bn_pool(yt, sct, sht, stride)
    (out.float() * t(g)).sum().backward()
    return out, yt.grad, sct.grad, sht.grad


@pytest.mark.parametrize("B,H,W,cout,stride,ties,bwd", BN_CASES)
def test_bn_pool_backend_matches_jax(B, H, W, cout, stride, ties, bwd, monkeypatch):
    """out exactly; dy exactly on pallas and idx (the same first-max
    routing, summed in tap order in f32), within one bf16 ulp (2**-7
    relative) on native and sas (the same routed terms summed in another
    f32 order); dsc and dsh within 1e-4."""
    _check_bn_pool_against_jax(*_bn_inputs(B, H, W, cout, stride, ties, bwd), stride, bwd,
                               monkeypatch)


# the edge inputs of the card tests of kernel (f): "halo", y < 0 and sh = 3,
# so that a zero-filled halo (bf16(LeakyReLU(sh)) = 3) would win every edge
# window; "zeros", half the y +-0 and sh = -0.0, so that z = -0 (slope 1)
# where a = -0. The card test's subnormal z (slope 0.1 where a = -0 too)
# stays on the card: XLA's CPU backend flushes f32 subnormals to zero.
BN_EDGE_CASES = [
    (2, 16, 32, 8, 1, "halo"),
    (2, 16, 32, 8, 2, "halo"),
    (1, 16, 64, 32, 2, "halo"),
    (2, 16, 32, 8, 1, "zeros"),
    (2, 16, 32, 8, 2, "zeros"),
    (1, 16, 64, 32, 1, "zeros"),
]


@pytest.mark.parametrize("bwd", ["pallas", "idx"])
@pytest.mark.parametrize("B,H,W,cout,stride,kind", BN_EDGE_CASES)
def test_bn_pool_backend_edges_match_jax(B, H, W, cout, stride, kind, bwd, monkeypatch):
    """The first-max backends on the edge inputs, at the bars of
    test_bn_pool_backend_matches_jax: out and dy exactly."""
    y, sc, sh, g = _bn_inputs(B, H, W, cout, stride, False, bwd)
    rng = np.random.default_rng(2)
    if kind == "halo":
        y, sh = _bf(-np.abs(y) - 0.25), np.full(cout, 3.0, np.float32)
    else:
        y = np.where(rng.random(y.shape) < 0.5, np.where(rng.random(y.shape) < 0.5, 0.0, -0.0), y)
        y, sh = y.astype(np.float32), np.full(cout, -0.0, np.float32)
    out = _check_bn_pool_against_jax(y, sc, sh, g, stride, bwd, monkeypatch)
    if kind == "halo":  # every maximum below 3: no halo cell won
        assert float(out.float().max()) < 3.0
    else:  # a = -0 with z = -0 wins windows: the slope trap is exercised
        assert bool(((out == 0) & torch.signbit(out)).any())


def _check_bn_pool_against_jax(y, sc, sh, g, stride, bwd, monkeypatch):
    """out, dy, dsc and dsh of the port's bn_pool on one backend against
    JAX's (interpret mode), and the plain versions of kernels (e) and (f)
    against (c)'s out and (d)'s dz; returns out."""
    B, H, W, cout = y.shape
    ym = jnp.asarray(y.reshape(B, H, W * cout), jnp.bfloat16)
    gm = jnp.asarray(g.reshape(B, H // stride, -1))

    def f(ym_, a, b):
        o = jax_bn_pool(ym_, a, b, H=H, W=W, cout=cout, stride=stride, interpret=True, bwd=bwd)
        return jnp.sum(o.astype(jnp.float32) * gm), o

    (_, out_ref), (dy_ref, dsc_ref, dsh_ref) = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        ym, jnp.asarray(sc), jnp.asarray(sh))

    before = _counts()
    out, dy, dsc, dsh = _port_bn_pool(y, sc, sh, g, stride, bwd, monkeypatch)
    assert _counts() == before  # CPU: the plain versions
    np.testing.assert_array_equal(n(out), n(out_ref).reshape(out.shape))
    dy_ref = n(dy_ref).reshape(B, H, W, cout)
    if bwd in ("pallas", "idx"):
        np.testing.assert_array_equal(n(dy), dy_ref)
        # the other first-max backend of the port gives the same bits
        other = _port_bn_pool(y, sc, sh, g, stride, "idx" if bwd == "pallas" else "pallas", monkeypatch)
        assert torch.equal(other[1], dy)
    else:
        np.testing.assert_allclose(n(dy), dy_ref, rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(n(dsc), np.asarray(dsc_ref), rtol=1e-4)
    np.testing.assert_allclose(n(dsh), np.asarray(dsh_ref), rtol=1e-4)

    # the plain versions of kernels (e) and (f) against (c)'s out and (d)'s dz
    yb, sct, sht, gb = t(y).to(BF), t(sc), t(sh), t(g).to(BF)
    out_idx, taps = ct.bn_pool_fwd_plain(yb, sct, sht, stride)
    assert torch.equal(ct.bn_pool_fwd_notap_plain(yb, sct, sht, stride), out_idx)
    assert torch.equal(ct.bn_pool_bwd_recompute_plain(yb, sct, sht, gb, stride),
                       ct.bn_pool_bwd_plain(yb, sct, sht, taps, gb, stride))
    return out.detach()


@pytest.mark.parametrize("bwd", ["idx", "pallas", "native", "sas"])
def test_bn_pool_without_gradient_runs_the_no_tap_forward(bwd, monkeypatch):
    """Under no_grad, or with no input that needs a gradient, every backend
    runs kernel (e)'s plain version and never (c)'s, as the primal of JAX's
    custom VJP; with a gradient to take, the backend's own forward."""
    calls = {"notap": 0, "idx": 0}
    for name, key in (("bn_pool_fwd_notap_plain", "notap"), ("bn_pool_fwd_plain", "idx")):
        fn = getattr(ct, name)

        def spy(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)

        monkeypatch.setattr(ct, name, spy)
    monkeypatch.setenv("I2PNET_POOL_BWD", bwd)
    y, sc, sh, _ = _bn_inputs(1, 8, 16, 8, 2, False, "idx")
    yb = t(y).to(BF)
    with torch.no_grad():
        ref = ct.bn_pool(yb.requires_grad_(), t(sc), t(sh), 2)
    assert ct.bn_pool(t(y).to(BF), t(sc), t(sh), 2).equal(ref)  # nothing requires a gradient
    assert calls == {"notap": 2, "idx": 0}
    out = ct.bn_pool(t(y).to(BF).requires_grad_(), t(sc), t(sh), 2)
    assert out.equal(ref) and out.requires_grad
    assert calls == ({"notap": 2, "idx": 1} if bwd == "idx" else {"notap": 3, "idx": 0})


# tests/test_layers.py's shapes (H, W, stride): the first two take the
# routed and all-ties backwards, the last two (not 1 or 2 dividing H, W)
# F.max_pool2d's in the port and select-and-scatter in JAX
POOL_SHAPES = [(8, 10, 1), (8, 10, 2), (9, 11, 2), (5, 6, 3)]


def _pool_case(H, W, s, kind, C=3, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "ones":  # every window fully tied
        x = np.ones((1, H, W, C), np.float32)
    elif kind == "quarters":
        x = np.round(rng.normal(size=(2, H, W, C)) * 4) / 4
    else:
        x = rng.normal(size=(2, H, W, C))
    x = x.astype(np.float32)
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
    ct_ = rng.normal(size=(x.shape[0], Ho, Wo, C)).astype(np.float32)
    return x, ct_


def _grads(x, ct_, s, dtype, var, monkeypatch, jax_pool):
    """(port y, port dx, JAX y, JAX dx) with the variable set for both."""
    monkeypatch.setenv(var, "1")
    jdt = jnp.bfloat16 if dtype == BF else jnp.float32
    xj, cj = jnp.asarray(x, jdt), jnp.asarray(ct_, jdt)
    y_ref, pull = jax.vjp(lambda v: jax_pool(v, s), xj)
    (dx_ref,) = pull(cj)
    xt = t(x).to(dtype).requires_grad_()
    y = layers.max_pool_3x3(xt, s)
    y.backward(t(ct_).to(dtype))
    return y, xt.grad, y_ref, dx_ref


@pytest.mark.parametrize("kind", ["normal", "quarters", "ones"])
@pytest.mark.parametrize("H,W,s", POOL_SHAPES)
def test_max_pool_routed_matches_jax(H, W, s, kind, monkeypatch):
    """I2PNET_POOL_PALLAS=1: forward and gradient against JAX's
    max_pool_3x3 under the same variable (its ``_pool3_custom`` on the
    clean shapes, the Pallas route kernel in interpret mode). f32: exact,
    the same routed terms added in the same tap order. bf16: exact as
    well; measured so here, where XLA keeps no excess precision in the
    route kernel's adds. The
    shapes the route does not take run the frameworks' own pool backwards
    (``F.max_pool2d``'s sums in f32 rounded once, select-and-scatter's in
    bf16): there bf16 is held within one bf16 ulp."""
    x, ct_ = _pool_case(H, W, s, kind)
    routed = H % s == 0 and W % s == 0 and s < 3
    for dtype in (torch.float32, BF):
        before = _counts()
        y, dx, y_ref, dx_ref = _grads(x, ct_, s, dtype, "I2PNET_POOL_PALLAS", monkeypatch,
                                      jax_max_pool_3x3)
        assert _counts() == before
        assert dx.dtype == dtype
        np.testing.assert_array_equal(n(y), n(y_ref))
        if routed or dtype == torch.float32:
            np.testing.assert_array_equal(n(dx), n(dx_ref))
        else:
            np.testing.assert_allclose(n(dx), n(dx_ref), rtol=2**-7, atol=0)


@pytest.mark.parametrize("kind", ["normal", "quarters"])
@pytest.mark.parametrize("C", [3, 12])
@pytest.mark.parametrize("s", [1, 2])
def test_max_pool_routed_matches_jax_at_narrow_widths(s, C, kind, monkeypatch):
    """I2PNET_POOL_PALLAS=1 at the widths of the route kernel's narrow
    instances (3 and 12 channels: no 8-channel vector fits), in f32 and
    bf16, at the bars of test_max_pool_routed_matches_jax: exact."""
    x, ct_ = _pool_case(16, 24, s, kind, C=C, seed=C)
    for dtype in (torch.float32, BF):
        before = _counts()
        y, dx, y_ref, dx_ref = _grads(x, ct_, s, dtype, "I2PNET_POOL_PALLAS", monkeypatch,
                                      jax_max_pool_3x3)
        assert _counts() == before
        np.testing.assert_array_equal(n(y), n(y_ref))
        np.testing.assert_array_equal(n(dx), n(dx_ref))


def test_pool_route_plain_routes_each_cotangent_once():
    """Every pooled cell's cotangent lands on its first-max tap and nowhere
    else (argtap 9 routes nothing), against a direct loop; the route kernel
    and its plain version take uint8 argtap."""
    rng = np.random.default_rng(7)
    for s in (1, 2):
        x = torch.from_numpy((np.round(rng.normal(size=(1, 6, 8, 2)) * 2) / 2).astype(np.float32))
        y = layers._pool3_fwd(x, s)
        at = pool_route_cuda.pool3_argtap(x, y, s)
        assert at.dtype == torch.uint8 and int(at.max()) < 9
        at[0, 0, 0, 0] = 9
        ct_ = torch.from_numpy(rng.normal(size=y.shape).astype(np.float32))
        dx = pool_route_cuda.pool_route_plain(at, ct_, s)
        ref = torch.zeros_like(x)
        for (b, m, k, c), o in np.ndenumerate(at.numpy()):
            if o < 9:
                ref[b, m * s + o // 3 - 1, k * s + o % 3 - 1, c] += ct_[b, m, k, c]
        torch.testing.assert_close(dx, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("H,W,s", [(8, 10, 1), (8, 10, 2), (6, 6, 2)])
def test_max_pool_allties_matches_jax(H, W, s, monkeypatch):
    """I2PNET_POOL_ALLTIES=1 against JAX's ``_pool3_allties``
    (tests/test_layers.py's shapes), on random and fully tied inputs:
    exact in f32 and in bf16, the same terms added in JAX's order in the
    cotangent's dtype."""
    for kind in ("normal", "ones"):
        x, ct_ = _pool_case(H, W, s, kind, seed=5)
        for dtype in (torch.float32, BF):
            y, dx, y_ref, dx_ref = _grads(x, ct_, s, dtype, "I2PNET_POOL_ALLTIES", monkeypatch,
                                          _pool3_allties)
            np.testing.assert_array_equal(n(y), n(y_ref))
            np.testing.assert_array_equal(n(dx), n(dx_ref))
    # a constant input: the interior point (1, 1) sits in 9 windows
    x = torch.ones(1, 4, 4, 1, requires_grad=True)
    layers.max_pool_3x3(x, 1).sum().backward()
    assert float(x.grad[0, 1, 1, 0]) == 9.0


@pytest.mark.parametrize("routed", [False, True], ids=["select-and-scatter", "routed"])
def test_rgb_encoder_stage_bf16_native_chain_matches_jax(routed, monkeypatch):
    """I2PNET_FUSED_TRAIN=0: the bf16 stage in training on the native chain
    (conv, BatchNorm with batch statistics applied in bf16, LeakyReLU, the
    bf16 cast, max_pool_3x3), with the routed pool backward when
    I2PNET_POOL_PALLAS=1, against JAX's native chain: out, the running
    statistics and the parameter gradients at the bars of
    test_rgb_encoder_stage_fused_train_integration. No train kernel (and on
    the CPU no kernel at all) runs."""
    rng = np.random.default_rng(3)
    B, H, W, cin = 2, 16, 32, 3
    channels, strides = (8, 16), (2, 1)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    g = rng.standard_normal((B, 8, 16, 16)).astype(np.float32)
    monkeypatch.setenv("I2PNET_FUSED_TRAIN", "0")
    if routed:
        monkeypatch.setenv("I2PNET_POOL_PALLAS", "1")
    jmod = JaxRGBEncoderStage(channels, strides, dtype=jnp.bfloat16, bn_compute_dtype=True)
    v = randomize_stats(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), True), np.random.default_rng(4))

    def loss(params):
        out, upd = jmod.apply({"params": params, "batch_stats": v["batch_stats"]},
                              jnp.asarray(x), True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), (out, upd)

    (l_ref, (out_ref, upd_ref)), grads_ref = jax.value_and_grad(loss, has_aux=True)(v["params"])

    mod = load_flax_variables(RGBEncoderStage(cin, channels, strides, BF, True), v).train()
    calls = {"route": 0}
    route = pool_route_cuda.pool_route_plain

    def spy(*a):
        calls["route"] += 1
        return route(*a)

    monkeypatch.setattr(pool_route_cuda, "pool_route_plain", spy)
    before = _counts()
    out = mod(t(x))
    lt = (out.float() * t(g)).sum()
    lt.backward()
    assert _counts() == before
    assert calls["route"] == (2 if routed else 0)

    assert out.dtype == BF
    assert abs(float(lt.detach()) - float(l_ref)) < 2e-2 * (abs(float(l_ref)) + 1.0)
    np.testing.assert_allclose(n(out), n(out_ref), atol=3e-2)
    for j in range(len(channels)):
        bn = getattr(mod, f"BatchNorm_{j}")
        for key, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
            np.testing.assert_allclose(n(buf), np.asarray(upd_ref["batch_stats"][f"BatchNorm_{j}"][key]),
                                       rtol=2e-2, atol=2e-3, err_msg=f"BatchNorm_{j} {key}")
    ref = flax_to_state_dict({"params": grads_ref})
    got = dict(mod.named_parameters())
    assert set(ref) == set(got)
    for name, gr in ref.items():
        if "Conv" in name and name.endswith("bias"):
            continue  # BN-absorbed; cancellation residue both sides
        gr = gr.numpy()
        scale = float(np.max(np.abs(gr))) + 1e-6
        np.testing.assert_allclose(n(got[name].grad) / scale, gr / scale, atol=5e-2, err_msg=name)
