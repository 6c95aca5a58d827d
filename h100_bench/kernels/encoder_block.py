"""The fused eval encoder block (csrc/conv_block.cu): 3x3 convolution,
folded BatchNorm, LeakyReLU and max-pool, bf16 operands; x (B,H,W,cin), w
(3,3,cin,cout), scale, shift."""

from h100_bench.work import BF16_FLOPS, bound as _bound, conv_flops, nbytes

MODULE, FUNCTION = "i2pnet_tpu_torch.ops.conv_cuda", "conv_block_cuda"


def bound(a, out):
    return _bound(nbytes(a[0], a[1], a[2], a[3], out), conv_flops(a[0], a[1].shape[2],
                                                                  a[1].shape[3]), BF16_FLOPS)
