"""Basic blocks (port of ``i2pnet_tpu/nn/layers.py``), channels-last.

Submodule names follow the flax scopes (``Dense_0``, ``BatchNorm_0``,
``Conv_j``, ``PointwiseConv_i``, ``RGBEncoderStage_i``) so the weight
bridge (``convert.py``) is a mechanical rename.

Compute dtype follows flax: a layer given ``dtype`` casts its input and
parameters to it and returns it; without one, the input and f32 parameters
promote to f32. BatchNorm is flax's ``(x - mean) * (rsqrt(var + eps) *
scale) + bias`` in f32, cast to the requested dtype: at eval with the
running statistics, in training with the batch's (see ``BatchNorm``).

The JAX package's eval-route switches are read at call time with its
values: ``I2PNET_FUSED_EVAL`` (the encoder block here),
``I2PNET_FUSED_CV`` (``nn/costvolume.py``) and ``I2PNET_PROJ_DENSE_EVAL``
(``nn/proj_backbone.py``) through ``eval_route``, and
``I2PNET_PW_BN_F32=1`` in ``PointwiseConv``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from i2pnet_tpu_torch.ops import conv_cuda, conv_train_cuda, pool_route_cuda
from i2pnet_tpu_torch.parallel.mesh import global_means

# flax momentum 0.9 (running = 0.9 * running + 0.1 * batch), eps 1e-5
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def eval_route(env_name: str) -> bool:
    """An eval-route switch, read at call time: ``0`` takes the native
    chain (False); unset, ``auto``, ``1`` and ``interpret`` take the fused
    route (True), which runs the kernel on CUDA tensors and its plain
    version on CPU tensors; any other value raises."""
    mode = os.environ.get(env_name, "auto")
    if mode == "0":
        return False
    if mode in ("auto", "1", "interpret"):
        return True
    raise ValueError(f"{env_name}={mode!r}: expected 0, 1, auto or interpret")


def cat(tensors, dim: int) -> torch.Tensor:
    """Concatenate with jnp.concatenate's dtype promotion."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.cat([t.to(dt) for t in tensors], dim=dim)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jax.nn.softmax's formulation, op by op in x's dtype; like it, no
    gradient flows through the max."""
    u = torch.exp(x - torch.amax(x, dim=dim, keepdim=True).detach())
    return u / torch.sum(u, dim=dim, keepdim=True)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``leaky_relu(x, 0.1)``: JAX rounds the weak-typed slope to x's
    dtype before the product, so in bf16 the slope is 0.10009765625."""
    return F.leaky_relu(x, 0.10009765625 if x.dtype == torch.bfloat16 else 0.1)


class Dense(nn.Linear):
    """flax ``nn.Dense`` over the last axis; weight (out, in)."""

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dt = dtype or torch.promote_types(x.dtype, self.weight.dtype)
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        return y + self.bias.to(dt)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis, f32 arithmetic.

    In training it normalises by the batch's statistics as flax's
    ``_compute_stats`` takes them: in f32, the fast variance ``E[x^2] -
    E[x]^2`` clipped at 0 (biased), and moves the running statistics by
    ``update_running`` with that same biased variance. ``torch.nn.BatchNorm``
    differs on all three points (two-pass variance, an unbiased running
    var, momentum 0.1), so the arithmetic is written out. Under an ambient
    mesh (``parallel/mesh.py``) the moments are the global batch's: the
    f32 sums and the count are all-reduced, differentiably."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if self.training:
            xf = x.float()
            dims = tuple(range(x.dim() - 1))
            moments = global_means([xf, xf * xf], dims)
            if moments is None:
                mean, mean2 = xf.mean(dims), (xf * xf).mean(dims)
            else:
                mean, mean2 = moments
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (x.float() - mean) * mul + self.bias
        return y.to(dtype or torch.float32)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """flax's momentum rule, in flax's order of f32 operations."""
        self.running_mean.copy_(BN_MOMENTUM * self.running_mean + (1 - BN_MOMENTUM) * mean)
        self.running_var.copy_(BN_MOMENTUM * self.running_var + (1 - BN_MOMENTUM) * var)

    def fold(self, dense: Dense):
        """(W (in, out), b) f32 with this eval BN folded into ``dense``."""
        s = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        return dense.weight.t().float() * s[None, :], (dense.bias - self.running_mean) * s + self.bias


class BatchStatsNorm(nn.Module):
    """flax ``BatchStatsNorm`` over the last axis: normalise by the current
    batch's statistics in training and at eval alike (the projection
    family's ``track_running_stats=False``), learned scale and bias, no
    state. The statistics are f32 with the two-pass variance
    ``mean((x - mean)**2)`` (``jnp.var``), not ``BatchNorm``'s clipped fast
    one. Without ``dtype`` the normalisation is f32; with it, it runs in
    that dtype: ``(x - mean) * rsqrt(var + eps)``, then ``* scale + bias``,
    each operand cast to it. Under an ambient mesh the two passes take the
    valid rows of every rank: the sum and the count all-reduced for the
    mean, then the squared deviations' sum."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, f32: bool = False) -> torch.Tensor:
        """f32: normalise in f32 whatever ``dtype`` (``I2PNET_PW_BN_F32``)."""
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        mean = global_means([xf], dims)
        if mean is None:
            mean = xf.mean(dims)
            var = torch.square(xf - mean).mean(dims)
        else:
            mean = mean[0]
            var = global_means([torch.square(xf - mean)], dims)[0]
        rs = torch.rsqrt(var + BN_EPS)
        if self.dtype is not None and not f32:
            dt = self.dtype
            y = (x.to(dt) - mean.to(dt)) * rs.to(dt)
            return y * self.weight.to(dt) + self.bias.to(dt)
        return (xf - mean) * rs * self.weight + self.bias


class PointwiseConv(nn.Module):
    """Dense (+ BN) (+ activation) over the channel axis. ``bn_stats=False``
    takes ``BatchStatsNorm`` (``BatchStatsNorm_0``, as flax names it) in
    place of ``BatchNorm``. With a compute dtype the normalisation's result
    is in it, unless ``I2PNET_PW_BN_F32=1`` (read at call time), which
    applies it in f32, as the JAX package does."""

    def __init__(self, in_features: int, features: int, use_bn: bool = False,
                 activation: Optional[str] = "leaky", dtype: Optional[torch.dtype] = None,
                 bn_stats: bool = True):
        super().__init__()
        self.Dense_0 = Dense(in_features, features)
        self.BatchNorm_0 = BatchNorm(features) if use_bn and bn_stats else None
        self.BatchStatsNorm_0 = BatchStatsNorm(features, dtype) if use_bn and not bn_stats else None
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(x, self.dtype)
        f32 = os.environ.get("I2PNET_PW_BN_F32") == "1"
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x, None if f32 else self.dtype)
        elif self.BatchStatsNorm_0 is not None:
            x = self.BatchStatsNorm_0(x, f32)
        if self.activation == "leaky":
            x = leaky_relu(x)
        elif self.activation == "relu":
            x = F.relu(x)
        return x

    def fold_eval(self):
        """(W (in, out), b) f32 with the eval BatchNorm folded in."""
        return self.BatchNorm_0.fold(self.Dense_0)


class PointwiseMLP(nn.Module):
    """A stack of PointwiseConv layers."""

    def __init__(self, in_features: int, features: Sequence[int], use_bn: bool = True,
                 activation: Optional[str] = "leaky", dtype: Optional[torch.dtype] = None,
                 bn_stats: bool = True):
        super().__init__()
        self.layers = []
        for i, f in enumerate(features):
            layer = PointwiseConv(in_features, f, use_bn, activation, dtype, bn_stats)
            self.add_module(f"PointwiseConv_{i}", layer)
            self.layers.append(layer)
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


def _pool3_fwd(x: torch.Tensor, stride: int) -> torch.Tensor:
    y = F.max_pool2d(x.float().permute(0, 3, 1, 2), 3, stride, 1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


class _Pool3(torch.autograd.Function):
    """The pool, with one of JAX's custom backwards ``bwd(x, y, ct,
    stride)``: the routed one (``_pool3_custom``) or the all-ties one
    (``_pool3_allties``)."""

    @staticmethod
    def forward(ctx, x, stride, bwd):
        y = _pool3_fwd(x, stride)
        ctx.save_for_backward(x, y)
        ctx.stride, ctx.bwd = stride, bwd
        return y

    @staticmethod
    def backward(ctx, ct):
        x, y = ctx.saved_tensors
        return ctx.bwd(x, y, ct.to(y.dtype).contiguous(), ctx.stride), None, None


def _pool3_route_bwd(x, y, ct, s):
    """Each cell's first-max tap (``pool3_argtap``), then the route kernel
    (``ops/pool_route_cuda.py``)."""
    return pool_route_cuda.pool_route(pool_route_cuda.pool3_argtap(x, y, s), ct, s)


def _pool3_allties_bwd(x, y, ct, s):
    """JAX's ``_pool3_allties_bwd``: every window entry equal to the pooled
    value takes the window's cotangent, summed over the covering windows in
    JAX's order, in ct's dtype."""
    if s == 1:
        H, W = x.shape[1:3]
        yp = F.pad(y, (0, 0, 1, 1, 1, 1), value=float("-inf"))
        cp = F.pad(ct, (0, 0, 1, 1, 1, 1))
        dx = None
        for oh in range(3):
            for ow in range(3):
                window = (slice(None), slice(oh, oh + H), slice(ow, ow + W))
                contrib = torch.where(x == yp[window], cp[window], 0)
                dx = contrib if dx is None else dx + contrib
        return dx
    B, Ho, Wo, C = y.shape
    yp = F.pad(y, (0, 0, 0, 1, 0, 1), value=float("-inf"))
    cp = F.pad(ct, (0, 0, 0, 1, 0, 1))
    planes = torch.empty(2, 2, B, Ho, Wo, C, dtype=ct.dtype, device=ct.device)
    for ph in (0, 1):
        for pw in (0, 1):
            xp = x[:, ph::2, pw::2]
            acc = None
            for a in range(ph + 1):  # input row 2m+ph: windows m (and m+1 if odd)
                for b in range(pw + 1):
                    window = (slice(None), slice(a, a + Ho), slice(b, b + Wo))
                    contrib = torch.where(xp == yp[window], cp[window], 0)
                    acc = contrib if acc is None else acc + contrib
            planes[ph, pw] = acc
    return planes.permute(2, 3, 0, 4, 1, 5).reshape(B, 2 * Ho, 2 * Wo, C)


def max_pool_3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 max-pool, stride s, pad 1 (padding never wins) on NHWC.

    The backward follows JAX's ``max_pool_3x3`` switches, read at call
    time, where stride is 1 or 2 and divides H and W: ``I2PNET_POOL_ALLTIES=1``
    takes the all-ties backward (plain PyTorch), else ``I2PNET_POOL_PALLAS=1``
    the routed one (the route kernel; the name is the JAX package's). Every
    other call is ``F.max_pool2d``'s, which, like the routed one and XLA's
    select-and-scatter, sends a tie's cotangent to the first max."""
    H, W = x.shape[1:3]
    clean = stride in (1, 2) and H % stride == 0 and W % stride == 0
    if clean and os.environ.get("I2PNET_POOL_ALLTIES") == "1":
        return _Pool3.apply(x, stride, _pool3_allties_bwd)
    if clean and os.environ.get("I2PNET_POOL_PALLAS") == "1":
        return _Pool3.apply(x, stride, _pool3_route_bwd)
    return _pool3_fwd(x, stride)


class RGBEncoderStage(nn.Module):
    """One encoder stage: per block 3x3 conv -> BN -> LeakyReLU(0.1) -> 3x3
    max-pool at stride s. NHWC.

    In bf16 the blocks take the fused kernels, as the JAX package routes
    them to its Pallas kernels: at eval one kernel per block
    (``ops/conv_cuda.py``, bias and BN folded into an f32 scale/shift); in
    training the train kernels (``ops/conv_train_cuda.py``: conv, batch
    statistics, scale/shift + LeakyReLU + pool, and their gradients), with
    the running statistics moved by flax's momentum rule. As in the JAX
    package, a stage takes them only where every block fits the kernels
    (``conv_cuda.stage_supported``, ``conv_train_cuda.stage_supported_train``:
    the port's own limits, e.g. cout a multiple of 8), and runs the native
    chain elsewhere; the gate decides the route on every device, so a CPU
    run takes the same route as the card. Where only one package's gate
    holds, the two differ in rounding points. ``I2PNET_FUSED_EVAL=0`` takes
    the native chain at eval (``eval_route``), ``I2PNET_FUSED_TRAIN=0``
    (read at call time, as JAX reads it) takes the native chain in bf16
    training too. The native chain (f32 always): conv, BN with batch or
    running statistics, LeakyReLU, ``max_pool_3x3``; with
    ``bn_compute_dtype`` the BN result is in the compute dtype.
    """

    def __init__(self, cin: int, channels: Sequence[int], strides: Sequence[int],
                 dtype: Optional[torch.dtype] = None, bn_compute_dtype: bool = False):
        super().__init__()
        self.channels, self.strides = tuple(channels), tuple(strides)
        self.dtype = dtype
        self.bn_compute_dtype = bn_compute_dtype
        self.blocks = []
        for j, ch in enumerate(channels):
            conv, bn = nn.Conv2d(cin, ch, 3, padding=1), BatchNorm(ch)
            self.add_module(f"Conv_{j}", conv)
            self.add_module(f"BatchNorm_{j}", bn)
            self.blocks.append((conv, bn))
            cin = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.bfloat16:
            B, H, W, cin = x.shape
            if not self.training:
                if eval_route("I2PNET_FUSED_EVAL") and conv_cuda.stage_supported(
                        H, W, cin, self.channels, self.strides):
                    return self._fused_eval(x)
            elif os.environ.get("I2PNET_FUSED_TRAIN") != "0" and \
                    conv_train_cuda.stage_supported_train(
                        H, W, cin, self.channels, self.strides,
                        input_grad=x.requires_grad and torch.is_grad_enabled()):
                return self._fused_train(x)
        bn_dt = self.dtype if self.bn_compute_dtype else None
        for (conv, bn), s in zip(self.blocks, self.strides):
            dt = self.dtype or torch.promote_types(x.dtype, conv.weight.dtype)
            # bf16 operands, f32 accumulation, result rounded to dt (flax Conv)
            y = F.conv2d(
                x.to(dt).float().permute(0, 3, 1, 2), conv.weight.to(dt).float(), padding=1
            ).permute(0, 2, 3, 1).to(dt)
            x = y + conv.bias.to(dt)
            x = bn(x, bn_dt)
            x = leaky_relu(x)
            if self.dtype is not None:
                x = x.to(self.dtype)
            x = max_pool_3x3(x, s)
        return x

    def _fused_eval(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.bfloat16)
        for (conv, bn), s in zip(self.blocks, self.strides):
            scale, shift = conv_cuda.fold_bn_eval(
                conv.bias, bn.running_mean, bn.running_var, bn.weight, bn.bias, BN_EPS
            )
            w = conv.weight.permute(2, 3, 1, 0)  # (3, 3, cin, cout), HWIO
            x = conv_cuda.fused_conv_block(x, w, scale, shift, s)
        return x

    def _fused_train(self, x: torch.Tensor) -> torch.Tensor:
        blocks = [(conv.weight, conv.bias, bn.weight, bn.bias) for conv, bn in self.blocks]
        out, stats = conv_train_cuda.fused_stage_train(x, blocks, self.strides, BN_EPS)
        for (_, bn), (mean, var) in zip(self.blocks, stats):
            bn.update_running(mean, var)
        return out


class RGBEncoder(nn.Module):
    """The three-stage RGB pyramid; returns every stage's output."""

    def __init__(self, stages, dtype: Optional[torch.dtype] = None,
                 bn_compute_dtype: bool = False):
        super().__init__()
        self.stages = []
        for i, (cin, channels, strides) in enumerate(stages):
            stage = RGBEncoderStage(cin, channels, strides, dtype, bn_compute_dtype)
            self.add_module(f"RGBEncoderStage_{i}", stage)
            self.stages.append(stage)

    def forward(self, x: torch.Tensor):
        outs = []
        for stage in self.stages:
            x = stage(x)
            outs.append(x)
        return tuple(outs)
