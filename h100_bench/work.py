"""The yardstick's arithmetic of work: the card's published peaks and the
bytes and operations of a kernel call, computed from its shapes (frozen
copies of the program's own counting, which this file must not follow when
the program changes it).

A call's bound is the larger of its bytes (each input read once, each
output written once) at the memory rate and its operations at the peak of
their type; a kernel's share of its roofline is its calls' bounds over
their device time.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(byte_count: float, ops: float, peak: float) -> float:
    """Seconds one call needs at least: bytes or operations."""
    return max(byte_count / HBM_BYTES_PER_S, ops / peak)


def conv_flops(x, cin: int, cout: int) -> float:
    """A 3x3 convolution at stride 1 over x (B, H, W, *): 2 per multiply-add."""
    B, H, W = x.shape[:3]
    return 2.0 * B * H * W * 9 * cin * cout


def cv1_flops(a) -> float:
    """The fused cost-volume chain's multiply-adds per (point, pixel), times
    2: the correlation's layer, mlp1's second and third, mlp2's two."""
    pn, qn, w1c, w2, w3, v1a, v1b, v2 = a[0], a[3], a[6], a[7], a[9], a[11], a[12], a[14]
    B, N, _ = pn.shape
    K = qn.shape[1]
    per = sum(w.shape[0] * w.shape[1] for w in (w1c, w2, w3, v1a, v1b, v2))
    return 2.0 * B * N * K * per
