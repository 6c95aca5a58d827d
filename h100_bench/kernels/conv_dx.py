"""The train encoder's input gradient (csrc/conv_train.cu): g (B,H,W,cout),
the flipped weight; bf16 operands."""

from h100_bench.work import BF16_FLOPS, bound as _bound, conv_flops, nbytes

MODULE, FUNCTION = "i2pnet_tpu_torch.ops.conv_train_cuda", "conv_dx_cuda"


def bound(a, out):
    return _bound(nbytes(a[0], a[1], out), conv_flops(a[0], a[1].shape[3], a[1].shape[0]),
                  BF16_FLOPS)
