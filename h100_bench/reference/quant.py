"""The control's precision: the reference's matmul and convolution
operands and every layer's result (``nets.Run``'s ``cast``) rounded to
fp8, one scale per tensor, as fp8 training keeps them (e4m3 forward, e5m2
for the gradient flowing back through the rounding).
The configurations state bf16 compute; fp8 is the step below it that a
later change could be tempted to take."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with a per-tensor scale; its gradient to e5m2."""
    return _Fp8.apply(x)


CASTS = {"fp32": None, "fp8": fp8}
