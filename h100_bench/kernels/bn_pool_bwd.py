"""The backward of BatchNorm, LeakyReLU and the tapped max-pool (csrc/
bn_pool_train.cu, kernel (d))."""

from h100_bench.work import F32_FLOPS, bound as _bound, nbytes

MODULE, FUNCTION = "i2pnet_tpu_torch.ops.conv_train_cuda", "bn_pool_bwd_cuda"


def bound(a, out):
    return _bound(nbytes(a[0], a[1], a[2], a[3], a[4], out), 13.0 * out.numel(), F32_FLOPS)
