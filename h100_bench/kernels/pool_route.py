"""The routed max-pool backward (csrc/pool_route.cu): a compare per
covering cell of every input element, an add per cell."""

from h100_bench.work import F32_FLOPS, bound as _bound, nbytes

MODULE, FUNCTION = "i2pnet_tpu_torch.ops.pool_route_cuda", "pool_route_cuda"


def bound(a, out):
    return _bound(nbytes(a[0], a[1], out), 9.0 * out.numel() + a[1].numel(), F32_FLOPS)
