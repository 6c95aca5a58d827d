"""The plain versions of the port's four train-encoder kernels
(``i2pnet_tpu_torch/ops/conv_train_cuda.py``) against the JAX package's
Pallas kernels in interpret mode (``i2pnet_tpu/ops/conv_pallas_train.py``),
on the CPU: the conv and its two gradients, the BN/pool forward with its
taps and its backward, the fused stage, and the bf16 ``RGBEncoderStage`` in
train mode. On the CPU the port's wrappers take the plain versions: the
launch counters stay put.

Bars are those of ``tests/test_conv_pallas_train.py`` unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.nn.layers import RGBEncoderStage as JaxRGBEncoderStage
from i2pnet_tpu.ops.conv_pallas import _pad_cin
from i2pnet_tpu.ops.conv_pallas_train import (
    _bn_pool_fwd_idx_p,
    bn_pool,
    conv_phase,
    conv_phase_dw,
    flip_transpose_kernel,
    fused_stage_train,
    pack_block_weights,
    unpack_dw,
)
from i2pnet_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from i2pnet_tpu_torch.nn.layers import RGBEncoderStage
from i2pnet_tpu_torch.ops import conv_train_cuda as ct
from _torch_util import n, randomize_stats, t

BF = torch.bfloat16
ULP = 2.0**-8  # one bf16 ulp, relative to the magnitude


def _bf(a):
    """numpy -> bf16-exact f32 numpy."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _merge(a):
    B, H, W, C = a.shape
    return a.reshape(B, H, W * C)


def _counts():
    return dict(ct.launches)


# the cases of tests/test_conv_pallas_train.py::test_conv_phase_fwd_dx_dw
CONV_CASES = [
    (2, 16, 32, 8, 8),
    (2, 16, 32, 8, 16),
    (1, 8, 32, 4, 8),     # the first block's padded width
    (2, 16, 64, 16, 32),
    (1, 16, 32, 32, 16),
    (1, 16, 16, 64, 64),
    (1, 8, 16, 64, 128),
]


@pytest.mark.parametrize("B,H,W,cin,cout", CONV_CASES)
def test_conv_train_matches_pallas(B, H, W, cin, cout):
    rng = np.random.default_rng(0)
    x = _bf(rng.standard_normal((B, H, W, cin)))
    w = _bf(rng.standard_normal((3, 3, cin, cout)) * 0.3)  # HWIO
    b = rng.standard_normal((cout,)).astype(np.float32)
    dy = _bf(rng.standard_normal((B, H, W, cout)))

    # JAX: the kernels the train path runs, bf16 out as there
    P = max(128 // cin, 128 // cout)
    y_ref = conv_phase(
        jnp.asarray(_merge(x), jnp.bfloat16), pack_block_weights(jnp.asarray(w), P=P).astype(jnp.bfloat16),
        jnp.tile(jnp.asarray(b), P)[None, :], H=H, W=W, cin=cin, cout=cout, interpret=True)
    assert _pad_cin(cout) == cout  # every case's cout divides 128
    Pt = max(128 // cout, 128 // cin)
    dx_ref = conv_phase(
        jnp.asarray(_merge(dy), jnp.bfloat16),
        pack_block_weights(flip_transpose_kernel(jnp.asarray(w)), P=Pt).astype(jnp.bfloat16),
        jnp.zeros((1, Pt * cin), jnp.float32), H=H, W=W, cin=cout, cout=cin, P=Pt, interpret=True)
    dw_ref = unpack_dw(conv_phase_dw(
        jnp.asarray(_merge(x), jnp.bfloat16), jnp.asarray(_merge(dy)),
        H=H, W=W, cin=cin, cout=cout, interpret=True), cin, cout)

    # the port: conv_train's forward and backward
    before = _counts()
    xt = t(x).to(BF).requires_grad_()
    wt = t(w.transpose(3, 2, 0, 1)).requires_grad_()  # (cout, cin, 3, 3)
    bt = t(b).requires_grad_()
    y = ct.conv_train(xt, wt, bt)
    y.backward(t(dy).to(BF))
    assert _counts() == before and y.dtype == BF and xt.grad.dtype == BF

    # the JAX test's atol 2e-2 on f32 outputs; both sides round y and dx
    # to bf16 after f32 sums in another order, which may flip one ulp
    ref = n(y_ref).reshape(B, H, W, cout)
    np.testing.assert_allclose(n(y), ref, atol=2e-2, rtol=ULP)
    ref = n(dx_ref).reshape(B, H, W, cin)
    np.testing.assert_allclose(n(xt.grad), ref, atol=2e-2, rtol=ULP)
    ref = np.asarray(dw_ref)
    scale = float(np.max(np.abs(ref))) + 1e-9
    np.testing.assert_allclose(n(wt.grad).transpose(2, 3, 1, 0) / scale, ref / scale, atol=2e-3)
    np.testing.assert_allclose(n(bt.grad), dy.sum((0, 1, 2)), rtol=1e-6)


# the (B, H, W, cout, stride, ties) cases of
# tests/test_conv_pallas_train.py::test_bn_pool_fwd_bwd, ties included
BN_CASES = [
    (2, 16, 32, 8, 1, False),
    (2, 16, 32, 8, 2, False),
    (2, 16, 32, 8, 1, True),
    (2, 16, 32, 8, 2, True),
    (1, 16, 32, 16, 2, False),
    (1, 16, 64, 32, 2, False),
    (1, 8, 16, 128, 2, False),
]


@pytest.mark.parametrize("B,H,W,cout,stride,ties", BN_CASES)
def test_bn_pool_matches_pallas(B, H, W, cout, stride, ties):
    rng = np.random.default_rng(1)
    if ties:
        y = np.round(rng.standard_normal((B, H, W, cout)) * 2) / 2
    else:
        y = rng.standard_normal((B, H, W, cout))
    y = _bf(y)
    sc = rng.uniform(0.5, 1.5, (cout,)).astype(np.float32)
    sh = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    Ho, Wo = H // stride, W // stride
    g = _bf(rng.standard_normal((B, Ho, Wo, cout)))

    ym = jnp.asarray(_merge(y), jnp.bfloat16)
    out_ref, idx_ref = _bn_pool_fwd_idx_p(
        ym, jnp.tile(jnp.asarray(sc), W)[None, :], jnp.tile(jnp.asarray(sh), W)[None, :],
        H=H, W=W, cout=cout, stride=stride, ht_out=16, interpret=True)
    out_ref = n(out_ref).reshape(B, Ho, Wo, cout)
    idx_ref = n(idx_ref).reshape(B, Ho, Wo, cout)

    def f(ym_, a, b):
        o = bn_pool(ym_, a, b, H=H, W=W, cout=cout, stride=stride, interpret=True, bwd="idx")
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(_merge(g)))

    dy_ref, dsc_ref, dsh_ref = jax.grad(f, argnums=(0, 1, 2))(ym, jnp.asarray(sc), jnp.asarray(sh))

    before = _counts()
    out, taps = ct.bn_pool_fwd(t(y).to(BF), t(sc), t(sh), stride)
    yt = t(y).to(BF).requires_grad_()
    sct, sht = t(sc).requires_grad_(), t(sh).requires_grad_()
    o = ct.bn_pool(yt, sct, sht, stride)
    (o.float() * t(g)).sum().backward()
    assert _counts() == before and taps.dtype == torch.uint8
    assert torch.equal(o, out)

    # XLA on the CPU may fuse y*sc+sh into an FMA where the port rounds
    # twice, which can flip a rare bf16 rounding: one ulp of the magnitude
    got = n(out)
    np.testing.assert_allclose(got, out_ref, rtol=ULP, atol=0)
    same = got == out_ref
    assert same.mean() > 0.99
    np.testing.assert_array_equal(taps.numpy()[same], idx_ref[same])
    dy4 = n(dy_ref).reshape(B, H, W, cout)
    np.testing.assert_allclose(n(yt.grad), dy4, rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(n(sct.grad), np.asarray(dsc_ref), rtol=1e-4)
    np.testing.assert_allclose(n(sht.grad), np.asarray(dsh_ref), rtol=1e-4)


def test_bn_pool_plain_odd_sizes_and_first_max():
    """Odd sizes (the pad never wins) and the first-max tap on a tie: the
    plain version against a direct loop over the windows."""
    rng = np.random.default_rng(5)
    B, H, W, C = 1, 7, 9, 8
    y = torch.from_numpy(np.round(rng.standard_normal((B, H, W, C)) * 2) / 2).to(BF)
    sc, sh = torch.ones(C), torch.zeros(C)
    for stride in (1, 2):
        out, taps = ct.bn_pool_fwd_plain(y, sc, sh, stride)
        a = torch.where(y.float() >= 0, y.float(), 0.1 * y.float()).to(BF).float()
        Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        assert out.shape == (B, Ho, Wo, C)
        for oh in range(Ho):
            for ow in range(Wo):
                for c in range(C):
                    vals = [(a[0, oh * stride + k // 3 - 1, ow * stride + k % 3 - 1, c].item(), k)
                            for k in range(9)
                            if 0 <= oh * stride + k // 3 - 1 < H and 0 <= ow * stride + k % 3 - 1 < W]
                    best = max(v for v, _ in vals)
                    first = next(k for v, k in vals if v == best)
                    assert out[0, oh, ow, c].item() == best and taps[0, oh, ow, c].item() == first
        # the backward routes each cotangent to its tap, times the slope
        g = torch.from_numpy(rng.standard_normal((B, Ho, Wo, C)).astype(np.float32)).to(BF)
        dz = ct.bn_pool_bwd_plain(y, sc, sh, taps, g, stride)
        ref = torch.zeros(B, H, W, C)
        for oh in range(Ho):
            for ow in range(Wo):
                for c in range(C):
                    k = int(taps[0, oh, ow, c])
                    ref[0, oh * stride + k // 3 - 1, ow * stride + k % 3 - 1, c] += g[0, oh, ow, c].float()
        ref = ref * torch.where(y.float() >= 0, 1.0, 0.1)
        torch.testing.assert_close(dz, ref, rtol=0, atol=1e-6)


def _stage_inputs(seed=2, B=2, H=16, W=32, cin=3, channels=(8, 16)):
    rng = np.random.default_rng(seed)
    x = _bf(rng.standard_normal((B, H, W, cin)))
    blocks, c = [], cin
    for ch in channels:
        blocks.append((
            _bf(rng.standard_normal((3, 3, c, ch)) * 0.3),
            (rng.standard_normal((ch,)) * 0.1).astype(np.float32),
            rng.uniform(0.5, 1.5, (ch,)).astype(np.float32),
            (rng.standard_normal((ch,)) * 0.1).astype(np.float32),
        ))
        c = ch
    g = _bf(rng.standard_normal((B, H // 4, W // 4, channels[-1])))
    return x, blocks, g


def test_fused_stage_train_matches_pallas():
    B, H, W, cin, channels, strides = 2, 16, 32, 3, (8, 16), (2, 2)
    x, blocks, g = _stage_inputs()

    def loss_jax(blocks_):
        out, stats = fused_stage_train(jnp.asarray(x), blocks_, H=H, W=W, cin=cin,
                                       channels=channels, strides=strides, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), (out, stats)

    jblocks = [tuple(jnp.asarray(a) for a in blk) for blk in blocks]
    (l_ref, (out_ref, stats_ref)), grads_ref = jax.value_and_grad(loss_jax, has_aux=True)(jblocks)

    tblocks = [(t(w.transpose(3, 2, 0, 1)), t(b), t(gm), t(bt)) for w, b, gm, bt in blocks]
    for blk in tblocks:
        for a in blk:
            a.requires_grad_()
    before = _counts()
    out, stats = ct.fused_stage_train(t(x), tblocks, strides)
    loss = (out.float() * t(g)).sum()
    loss.backward()
    assert _counts() == before

    # bf16 conv outputs rounded after f32 sums in another order move the
    # statistics by ~1e-6 and may flip a bf16 rounding of out: out within
    # one ulp of its magnitude where it flips, stats at the JAX test's bar
    np.testing.assert_allclose(n(out), n(out_ref), rtol=2 * ULP, atol=1e-6)
    assert abs(float(loss.detach()) - float(l_ref)) < 1e-3 * abs(float(l_ref)) + 1e-3
    for (m, v), (mr, vr) in zip(stats, stats_ref):
        np.testing.assert_allclose(n(m), n(mr), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(n(v), n(vr), rtol=1e-4, atol=1e-6)
    for j, (blk, gr) in enumerate(zip(tblocks, grads_ref)):
        got = [n(blk[0].grad).transpose(2, 3, 1, 0)] + [n(a.grad) for a in blk[1:]]
        for name, gf, gref in zip(("dw", "db", "dgamma", "dbeta"), got, gr):
            gref = np.asarray(gref)
            if name == "db":  # cancellation residue through train BN, as there
                assert np.max(np.abs(gf)) < 0.1 and np.max(np.abs(gref)) < 0.1
                continue
            # the JAX test's bar against its f32 reference: 1e-2 of the
            # leading magnitude (both sides round cotangents to bf16)
            scale = float(np.max(np.abs(gref))) + 1e-6
            np.testing.assert_allclose(gf / scale, gref / scale, atol=1e-2, err_msg=f"{j} {name}")


def test_rgb_encoder_stage_bf16_train_matches_pallas(monkeypatch):
    """The port's bf16 stage in train mode (plain versions of the four
    kernels) against JAX's with I2PNET_FUSED_TRAIN=interpret: out, the
    running-stat updates and the parameter gradients, at the bars of
    test_rgb_encoder_stage_fused_train_integration."""
    rng = np.random.default_rng(3)
    B, H, W, cin = 2, 16, 32, 3
    channels, strides = (8, 16), (2, 2)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    g = rng.standard_normal((B, 4, 8, 16)).astype(np.float32)

    jmod = JaxRGBEncoderStage(channels, strides, dtype=jnp.bfloat16)
    monkeypatch.setenv("I2PNET_FUSED_TRAIN", "interpret")
    v = randomize_stats(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), True), np.random.default_rng(4))

    def loss(params):
        out, upd = jmod.apply({"params": params, "batch_stats": v["batch_stats"]},
                              jnp.asarray(x), True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), (out, upd)

    (l_ref, (out_ref, upd_ref)), grads_ref = jax.value_and_grad(loss, has_aux=True)(v["params"])

    mod = load_flax_variables(RGBEncoderStage(cin, channels, strides, BF), v).train()
    calls = dict.fromkeys(("conv_fwd_plain", "conv_dx_plain", "conv_dw_plain",
                           "bn_pool_fwd_plain", "bn_pool_bwd_plain"), 0)
    for name in calls:
        fn = getattr(ct, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(ct, name, counted)
    before = _counts()
    out = mod(t(x))
    lt = (out.float() * t(g)).sum()
    lt.backward()
    assert _counts() == before  # no kernel on the CPU
    # every block's plain versions ran: dx skips block 0 (its input is x)
    assert calls == {"conv_fwd_plain": 2, "conv_dx_plain": 1, "conv_dw_plain": 2,
                     "bn_pool_fwd_plain": 2, "bn_pool_bwd_plain": 2}

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
