"""The backward that recomputes the activation (csrc/bn_pool_train.cu,
kernel (f)): once the activation, a 9-tap scan per pooled cell, the gather
and slope per input element."""

from h100_bench.work import F32_FLOPS, bound as _bound, nbytes

MODULE, FUNCTION = "i2pnet_tpu_torch.ops.conv_train_cuda", "bn_pool_bwd_recompute_cuda"


def bound(a, out):
    return _bound(nbytes(a[0], a[1], a[2], a[3], out),
                  4.0 * a[0].numel() + 9.0 * a[3].numel() + 13.0 * out.numel(), F32_FLOPS)
