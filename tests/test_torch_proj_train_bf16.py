"""The bf16 proj train step against JAX's jitted step with its Pallas train
kernels in interpret mode, and the bf16 step on the native encoder chain
with the routed pool backward; the shared helpers and the f32 step are in
``test_torch_proj_train.py``."""

import numpy as np
import pytest
import torch

from i2pnet_tpu_torch.ops import conv_train_cuda, pool_route_cuda
from _torch_util import n
from test_torch_proj_train import METRICS, _jax_step, _port_step, check_step_matches_jax


def test_proj_train_step_matches_jax_bf16(monkeypatch):
    check_step_matches_jax("bfloat16", monkeypatch)


def test_proj_train_step_native_chain_routes_the_pool(monkeypatch):
    """I2PNET_FUSED_TRAIN=0 I2PNET_POOL_PALLAS=1: the bf16 step takes the
    native chain (no train kernel's plain version runs) and every pool's
    backward takes the route's plain version, by stride (the tiny encoder
    pools at stride 1 once and at stride 2 five times); the gradients are
    finite and the metrics within the bf16 bars of JAX's fused step."""
    calls = {1: 0, 2: 0}
    route = pool_route_cuda.pool_route_plain

    def spy(argtap, ct, stride):
        calls[stride] += 1
        return route(argtap, ct, stride)

    monkeypatch.setattr(pool_route_cuda, "pool_route_plain", spy)
    fused = dict.fromkeys(("conv_fwd_plain", "bn_pool_fwd_plain", "bn_pool_fwd_notap_plain"), 0)
    for name in fused:
        fn = getattr(conv_train_cuda, name)

        def count(*a, _fn=fn, _name=name):
            fused[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(conv_train_cuda, name, count)
    cfg, _, _, metrics_ref = _jax_step("bfloat16")
    model, metrics = _port_step(cfg, monkeypatch, I2PNET_FUSED_TRAIN="0", I2PNET_POOL_PALLAS="1")
    assert calls == {1: 1, 2: 5}
    assert not any(fused.values()), fused
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    for key in METRICS:
        np.testing.assert_allclose(n(metrics[key]), n(metrics_ref[key]), rtol=5e-3, atol=5e-3,
                                   err_msg=key)
