"""The RGB-encoder route gates and the encoder block's launch plan, on the CPU.

``conv_cuda.stage_supported`` and ``conv_train_cuda.stage_supported_train``
state the port's own kernel limits, as the JAX package's gates of the same
names state its TPU's. ``RGBEncoderStage`` takes the fused kernels only
where they hold and runs the native chain elsewhere, on every device; a
stage off the kernels (cout = 12) is held against the JAX package's bf16
stage, at eval and in training. ``_block_plan`` is what the encoder-block
kernel reads as it is: every pooled pixel of every shipped call in one
block, within the kernel's shared memory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.nn.layers import RGBEncoderStage as JaxRGBEncoderStage
from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
from i2pnet_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from i2pnet_tpu_torch.nn.layers import RGBEncoderStage
from i2pnet_tpu_torch.ops import conv_cuda, conv_train_cuda
from _torch_util import n, randomize_stats, t

BF = torch.bfloat16
# (config, image H, W): the free and proj bench shapes, and the tiny configs
IMAGES = [(I2PNetConfig(), 384, 1280), (I2PNetProjConfig(), 160, 512),
          (I2PNetConfig.tiny(), 64, 128), (I2PNetProjConfig.tiny(), 64, 128)]


def _stages(cfg, H, W):
    """(H, W, cin, channels, strides) of each encoder stage."""
    out = []
    for cin, channels, strides in cfg.rgb_encoder_channels:
        out.append((H, W, cin, channels, strides))
        for s in strides:
            H, W = (H - 1) // s + 1, (W - 1) // s + 1
    return out


@pytest.mark.parametrize("cfg,H,W", IMAGES, ids=["free", "proj", "free-tiny", "proj-tiny"])
def test_gates_take_the_shipped_stages(cfg, H, W):
    for i, (h, w, cin, channels, strides) in enumerate(_stages(cfg, H, W)):
        assert conv_cuda.stage_supported(h, w, cin, channels, strides)
        # the first stage's input is the image, which takes no gradient
        assert conv_train_cuda.stage_supported_train(h, w, cin, channels, strides, input_grad=i > 0)


# (H, W, cin, channels, strides, eval gate, train gate, train gate with an
# input gradient)
GATE_CASES = [
    (16, 24, 3, (12, 16), (2, 1), False, False, False),   # cout 12: not a multiple of 8
    (16, 24, 16, (16, 12), (1, 1), False, False, False),
    (16, 24, 3, (16,), (3,), False, False, False),         # stride 3
    (16, 24, 3, (16, 8), (2, 2), True, True, False),       # dx of a 3-channel input
    (8, 8, 2048, (64,), (1,), False, False, False),        # weights past shared memory
    (8, 8, 384, (64,), (1,), True, False, False),          # kernel (a)'s layout does not fit
    (1, 1, 12, (24,), (2,), True, True, False),            # a 1-pixel image; dx of 12 channels
]


@pytest.mark.parametrize("H,W,cin,channels,strides,ev,tr,tr_dx", GATE_CASES)
def test_gates_refuse_what_the_kernels_cannot_take(H, W, cin, channels, strides, ev, tr, tr_dx):
    assert conv_cuda.stage_supported(H, W, cin, channels, strides) is ev
    assert conv_train_cuda.stage_supported_train(H, W, cin, channels, strides) is tr
    assert conv_train_cuda.stage_supported_train(H, W, cin, channels, strides,
                                                 input_grad=True) is tr_dx


def _calls(cfg, B, H, W):
    """(B, H, W, cin, cout, stride) of every block of the encoder."""
    calls = []
    for cin, channels, strides in cfg.rgb_encoder_channels:
        for cout, s in zip(channels, strides):
            calls.append((B, H, W, cin, cout, s))
            H, W, cin = (H - 1) // s + 1, (W - 1) // s + 1, cout
    return calls


# B=1-4: a rank's rows in the evaluator's fan-out over two ranks (ragged
# tails included)
BLOCK_SHAPES = sorted(set(
    _calls(I2PNetConfig(), 8, 384, 1280) + _calls(I2PNetProjConfig(), 8, 160, 512)
    + [c for b in (1, 2, 3, 4) for c in _calls(I2PNetConfig(), b, 384, 1280)
       + _calls(I2PNetProjConfig(), b, 160, 512)]
    + [(2, 9, 37, 3, 8, 1), (1, 1, 50, 3, 16, 2), (2, 7, 1, 16, 8, 2), (1, 6, 83, 64, 128, 1),
       (1, 13, 29, 12, 24, 1), (1, 17, 260, 16, 16, 2), (1, 4, 9, 256, 8, 1)]))


@pytest.mark.parametrize("B,H,W,cin,cout,stride", BLOCK_SHAPES)
def test_block_plan_covers_every_pooled_pixel_once(B, H, W, cin, cout, stride):
    """The slabs tile the pooled columns exactly (the last one clipped),
    each slab's conv columns fit its 16 mt pixels, the channel tile divides
    cout (all of it up to 32 input channels), and the layout fits. (The launcher cuts the
    rows into strips.)"""
    p = conv_cuda._block_plan(B, H, W, cin, cout, stride)
    assert p is not None
    Wo = (W - 1) // stride + 1
    assert p.slabs * p.pw >= Wo > (p.slabs - 1) * p.pw
    assert (p.pw + 2 if stride == 1 else 2 * p.pw + 1) <= 16 * p.mt <= 128
    assert cout % p.co_t == 0 and p.co_t % 8 == 0
    if cin <= 32:  # stages 1-2: one channel tile, x read once
        assert p.co_t == cout
    elif cin <= 64:  # stage 3: the 64-channel weights beside the rings take two tiles
        assert p.co_t >= min(cout, 32)
    assert conv_cuda._block_smem(cin, p.co_t, p.mt) <= conv_cuda._MAX_SMEM


def _refuse(*names):
    """Replace the fused paths with functions that fail the test if run."""
    def fail(*a, **k):
        raise AssertionError("a stage off the kernels took the fused path")
    return [(mod, name, fail) for mod, name in names]


def test_stage_off_the_kernels_runs_the_native_chain_at_eval(monkeypatch):
    """cout = 12: the bf16 eval stage runs the native chain on the CPU too
    (the gate, not the device, decides), and matches JAX's bf16 stage."""
    rng = np.random.default_rng(5)
    B, H, W, cin = 2, 16, 24, 3
    channels, strides = (12, 16), (2, 1)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    jmod = JaxRGBEncoderStage(channels, strides, dtype=jnp.bfloat16, bn_compute_dtype=True)
    v = randomize_stats(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), False),
                        np.random.default_rng(6), scale=0.5)
    ref = jmod.apply(v, jnp.asarray(x), False)
    mod = load_flax_variables(RGBEncoderStage(cin, channels, strides, BF, True), v).eval()
    for m, name, fn in _refuse((conv_cuda, "fused_conv_block"), (conv_cuda, "conv_block_plain")):
        monkeypatch.setattr(m, name, fn)
    with torch.no_grad():
        got = mod(t(x))
    assert got.dtype == BF and tuple(got.shape) == ref.shape
    m = float(np.max(np.abs(n(ref))))
    # bf16 roundings over the chained blocks: tests/test_torch_fused.py's bar
    assert float(np.max(np.abs(n(got) - n(ref)))) <= 0.02 * max(m, 1.0)


def test_stage_on_the_kernels_takes_the_fused_path_at_eval(monkeypatch):
    """The control: at cout = 16 the same stage takes the fused block (its
    plain version on the CPU), once a block."""
    calls = []
    block = conv_cuda.fused_conv_block

    def spy(*a):
        calls.append(a[0].shape)
        return block(*a)

    monkeypatch.setattr(conv_cuda, "fused_conv_block", spy)
    torch.manual_seed(0)
    mod = RGBEncoderStage(3, (16, 16), (2, 1), BF, True).eval()
    with torch.no_grad():
        mod(torch.randn(2, 16, 24, 3))
    assert len(calls) == 2


def test_stage_off_the_kernels_runs_the_native_chain_in_training(monkeypatch):
    """cout = 12 in bf16 training: the native chain (no train kernel's plain
    version runs), against JAX's bf16 stage: out, the running statistics
    and the parameter gradients at the bars of
    tests/test_torch_pool_backends.py's native-chain test."""
    rng = np.random.default_rng(7)
    B, H, W, cin = 2, 16, 24, 3
    channels, strides = (12, 16), (2, 1)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    g = rng.standard_normal((B, 8, 12, 16)).astype(np.float32)
    jmod = JaxRGBEncoderStage(channels, strides, dtype=jnp.bfloat16, bn_compute_dtype=True)
    v = randomize_stats(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), True),
                        np.random.default_rng(8))

    def loss(params):
        out, upd = jmod.apply({"params": params, "batch_stats": v["batch_stats"]},
                              jnp.asarray(x), True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), (out, upd)

    (l_ref, (out_ref, upd_ref)), grads_ref = jax.value_and_grad(loss, has_aux=True)(v["params"])

    mod = load_flax_variables(RGBEncoderStage(cin, channels, strides, BF, True), v).train()
    for m, name, fn in _refuse((conv_train_cuda, "fused_stage_train"),
                               (conv_train_cuda, "conv_fwd_plain"),
                               (conv_train_cuda, "bn_pool_fwd_plain")):
        monkeypatch.setattr(m, name, fn)
    out = mod(t(x))
    lt = (out.float() * t(g)).sum()
    lt.backward()

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
