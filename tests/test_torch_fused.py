"""The plain versions of the port's fused kernels against the JAX package's
Pallas kernels in interpret mode, on the CPU.

Kernel 2, the fused eval encoder block: block by block, and the bf16
RGBEncoder as a whole. Kernel 3, the fused eval cost volume: the bf16
CostVolume with the kernel routed on both sides. On the CPU the port's
wrappers take the plain versions (the launch counters stay put).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2pnet_tpu.nn.costvolume import CostVolume as JaxCostVolume
from i2pnet_tpu.nn.layers import RGBEncoder as JaxRGBEncoder
from i2pnet_tpu.ops.conv_pallas import _pad_cin, fused_conv_block, pack_block_weights
from i2pnet_tpu_torch.nn.costvolume import CostVolume
from i2pnet_tpu_torch.nn.layers import RGBEncoder
from i2pnet_tpu_torch.ops import conv_cuda, cv_cuda
from _torch_util import n, port, randomize_stats, t

# the cases of tests/test_conv_pallas.py (B, H, W, cin, cout, stride, ht)
CONV_CASES = [
    (2, 16, 32, 16, 16, 1, 8),
    (2, 16, 32, 16, 16, 2, 4),
    (2, 16, 32, 3, 16, 2, 4),
    (2, 16, 32, 16, 32, 2, 4),
    (2, 8, 16, 32, 64, 1, 4),
    (1, 8, 16, 64, 128, 2, 2),
    (2, 12, 32, 16, 16, 1, 4),
]


@pytest.mark.parametrize("B,H,W,cin,cout,stride,ht", CONV_CASES)
def test_conv_block_plain_matches_pallas(B, H, W, cin, cout, stride, ht):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, H, W, cin)).astype(np.float32)
    w = (0.3 * rng.normal(size=(3, 3, cin, cout))).astype(np.float32)
    scale = rng.normal(size=(cout,)).astype(np.float32)
    shift = rng.normal(size=(cout,)).astype(np.float32)

    cin_p = _pad_cin(cin)
    P = 128 // cin_p
    xp = x if cin_p == cin else np.pad(x, ((0, 0), (0, 0), (0, 0), (0, cin_p - cin)))
    ref = fused_conv_block(
        jnp.asarray(xp.reshape(B, H, W * cin_p)), pack_block_weights(jnp.asarray(w)).astype(jnp.bfloat16),
        jnp.tile(scale, P)[None, :], jnp.tile(shift, P)[None, :],
        H=H, W=W, cin=cin_p, cout=cout, stride=stride, ht_out=ht, interpret=True,
    )
    ref = n(ref).reshape(B, H // stride, W // stride, cout)

    before = conv_cuda.launches
    got = conv_cuda.fused_conv_block(t(x).to(torch.bfloat16), t(w), t(scale), t(shift), stride)
    assert conv_cuda.launches == before and got.dtype == torch.bfloat16
    # f32 sums in another order may flip a bf16 rounding: the JAX kernel's
    # own bar against native (tests/test_conv_pallas.py)
    assert float(np.max(np.abs(n(got) - ref))) <= 0.01 * max(float(np.max(np.abs(ref))), 1.0)


def test_rgb_encoder_bf16_matches_jax_fused(monkeypatch):
    stages = ((3, (16, 16, 32), (2, 1, 2)), (32, (32, 64), (1, 2)))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    jenc = JaxRGBEncoder(stages, dtype=jnp.bfloat16, bn_compute_dtype=True)
    v = randomize_stats(jenc.init(jax.random.key(0), x, train=False), rng, scale=0.5)
    monkeypatch.setenv("I2PNET_FUSED_EVAL", "interpret")
    ref = jenc.apply(v, x, train=False)

    enc = port(RGBEncoder(stages, torch.bfloat16, bn_compute_dtype=True), v)
    with torch.no_grad():
        got = enc(t(x))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape and g.dtype == torch.bfloat16
        m = float(np.max(np.abs(n(r))))
        # bf16 roundings compound over the chained blocks: 2% of the
        # activation magnitude (tests/test_conv_pallas.py's bar)
        assert float(np.max(np.abs(n(g) - n(r)))) <= 0.02 * max(m, 1.0)


def _cv_inputs(seed, B=2, N=16, K=32, C=16):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(B, N, 3)).astype(np.float32),
        rng.normal(size=(B, N, C)).astype(np.float32),
        rng.normal(size=(B, K, 3)).astype(np.float32),
        rng.normal(size=(B, K, C)).astype(np.float32),
        rng.uniform(1, 5, size=(B, N, 1)).astype(np.float32),
    )


@pytest.mark.parametrize("bval", [True, False])
def test_cost_volume_bf16_matches_jax_fused(monkeypatch, bval):
    inputs = _cv_inputs(0)
    kw = dict(nsample=4, nsample_q=-1, mlp1=(16, 8, 8), mlp2=(16, 8), backward_validation=bval)
    jcv = JaxCostVolume(dtype=jnp.bfloat16, **kw)
    rng = np.random.default_rng(7)
    v = randomize_stats(jcv.init(jax.random.PRNGKey(0), *inputs), rng, scale=0.3)
    monkeypatch.setenv("I2PNET_FUSED_CV", "interpret")
    ref = jcv.apply(v, *inputs)

    cv = port(CostVolume(in_channels=16, dtype=torch.bfloat16, **kw), v)
    before = cv_cuda.launches
    with torch.no_grad():
        got = cv(*map(t, inputs))
    assert cv_cuda.launches == before
    d = np.abs(n(got) - n(ref))
    # the JAX kernel's bar against native (tests/test_cv_pallas.py)
    assert float(d.max()) <= 3e-2
    assert float(d.mean()) < 5e-3


def test_cost_volume_routes_the_fused_path_only_at_bf16_eval(monkeypatch):
    calls = []
    real = cv_cuda.fused_cv1_eval
    monkeypatch.setattr(cv_cuda, "fused_cv1_eval", lambda *a, **k: calls.append(1) or real(*a, **k))
    inputs = [t(a) for a in _cv_inputs(1)]
    kw = dict(nsample=4, nsample_q=-1, mlp2=(16, 8), in_channels=16, backward_validation=True)
    with torch.no_grad():
        CostVolume(mlp1=(16, 8, 8), **kw).eval()(*inputs)  # f32: native
        CostVolume(mlp1=(16, 8), dtype=torch.bfloat16, **kw).eval()(*inputs)  # depth 2: native
        assert not calls
        CostVolume(mlp1=(16, 8, 8), dtype=torch.bfloat16, **kw).eval()(*inputs)
    assert calls == [1]
    with torch.no_grad():  # the cosine correlation, which JAX does not fuse: native
        CostVolume(mlp1=(16, 8, 8), corr_func="cosine", dtype=torch.bfloat16, **kw).eval()(*inputs)
    assert calls == [1]
