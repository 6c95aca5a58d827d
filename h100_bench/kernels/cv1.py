"""The fused all-pixels cost volume (csrc/cv1.cu), bf16 operands."""

from h100_bench.work import BF16_FLOPS, bound as _bound, cv1_flops, nbytes

MODULE, FUNCTION = "i2pnet_tpu_torch.ops.cv_cuda", "cv1_cuda"


def bound(a, out):
    return _bound(nbytes(*a, out), cv1_flops(a), BF16_FLOPS)
