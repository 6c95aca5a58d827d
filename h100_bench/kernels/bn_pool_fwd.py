"""BatchNorm, LeakyReLU and max-pool with the pool's taps (csrc/
bn_pool_train.cu, kernel (c)): a few f32 operations per element, far below
the bytes."""

from h100_bench.work import F32_FLOPS, bound as _bound, nbytes

MODULE, FUNCTION = "i2pnet_tpu_torch.ops.conv_train_cuda", "bn_pool_fwd_cuda"


def bound(a, out):
    return _bound(nbytes(a[0], a[1], a[2], *out), 4.0 * a[0].numel() + 9.0 * out[0].numel(),
                  F32_FLOPS)
