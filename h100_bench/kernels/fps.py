"""Farthest point sampling (csrc/fps.cu): per step a distance (3 sub, 3
mul, 2 add), a min and a compare over every point, in f32; its serial
chain of npoint steps is the real limit, which no rate bound sees."""

from h100_bench.work import F32_FLOPS, bound as _bound, nbytes

MODULE, FUNCTION = "i2pnet_tpu_torch.ops.fps_cuda", "fps_cuda"


def bound(a, out):
    xyz, npoint = a[0], a[1]
    return _bound(nbytes(xyz, out), 10.0 * xyz.shape[0] * npoint * xyz.shape[1], F32_FLOPS)
