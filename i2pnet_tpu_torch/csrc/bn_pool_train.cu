// The train-mode RGB-encoder block's BN epilogue and pool: kernel (c), its
// forward with the winning taps, and kernel (d), its backward.
//
// Replaces the TPU kernels of i2pnet_tpu/ops/conv_pallas_train.py:
//   (c) _bn_pool_fwd_idx_kernel (:656, launched by _bn_pool_fwd_idx_p :775):
//       z = y * sc + sh in f32 -> LeakyReLU(0.1) -> bf16 -> 3x3 max-pool,
//       stride s, pad 1 (the pad never wins), plus the winning tap 0-8 of
//       each pooled cell: the first max in row-major (kh, kw) order, by a
//       strict >.
//   (d) _bn_pool_bwd_idx_kernel (:801, launched by _bn_pool_bwd_idx_p :922):
//       dz[pixel] = the sum, in tap order k = 0..8, of the pooled cotangents
//       g whose saved tap is this pixel, times the LeakyReLU slope (1 where
//       z >= 0, else 0.1).
// The TPU's lane rolls, row pairing and even-w selection matmuls are not
// carried over.
//
// What bounds them on the H100: bytes (a few operations per element). Each
// thread owns 8 channels of one output (c) or input (d) pixel, so every
// access is a 16-byte vector (8 bf16, 8 taps as 8 bytes, 8 f32 as two);
// neighbouring threads take neighbouring channel groups and pixels. The
// overlapping windows' re-reads hit the caches. (d) gathers, for each input
// pixel, the <= 9 (stride 1) or <= 4 (stride 2) pooled cells that cover it,
// so it needs no atomics and sums in a fixed order.
//
// The affine is spelled with __fmul_rn / __fadd_rn: nvcc would contract it
// into an FMA, and the plain PyTorch version rounds twice. Out and taps are
// then bit-identical to the plain version, and so is dz.

#include "common.cuh"

namespace {

struct Shape {
  int B, H, W, C, stride, Ho, Wo;
};

__device__ __forceinline__ void load_affine(const float* sc, const float* sh, int c, float (&s)[8],
                                            float (&o)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] = sc[c + j];
    o[j] = sh[c + j];
  }
}

__device__ __forceinline__ float affine(float y, float s, float o) {
  return __fadd_rn(__fmul_rn(y, s), o);
}

__global__ void bn_pool_fwd_kernel(const __nv_bfloat16* __restrict__ y,
                                   const float* __restrict__ sc, const float* __restrict__ sh,
                                   __nv_bfloat16* __restrict__ out, uint8_t* __restrict__ taps,
                                   Shape s) {
  const int C8 = s.C / 8;
  const long long total = static_cast<long long>(s.B) * s.Ho * s.Wo * C8;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C8) * 8;
    long long rest = i / C8;
    const int ow = static_cast<int>(rest % s.Wo);
    rest /= s.Wo;
    const int oh = static_cast<int>(rest % s.Ho);
    const int b = static_cast<int>(rest / s.Ho);
    float scv[8], shv[8];
    load_affine(sc, sh, c, scv, shv);
    float best[8];
    __align__(8) uint8_t tap[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      best[j] = -INFINITY;
      tap[j] = 0;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int h = oh * s.stride + k / 3 - 1, w = ow * s.stride + k % 3 - 1;
      if (h < 0 || h >= s.H || w < 0 || w >= s.W) continue;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(y + ((static_cast<size_t>(b) * s.H + h) * s.W + w) * s.C + c);
      const __nv_bfloat16* yv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float z = affine(__bfloat162float(yv[j]), scv[j], shv[j]);
        const float a = bf16_round(z >= 0.f ? z : __fmul_rn(z, 0.1f));
        if (a > best[j]) {
          best[j] = a;
          tap[j] = static_cast<uint8_t>(k);
        }
      }
    }
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(best[j]);
    const size_t at = ((static_cast<size_t>(b) * s.Ho + oh) * s.Wo + ow) * s.C + c;
    *reinterpret_cast<uint4*>(out + at) = *reinterpret_cast<const uint4*>(o);
    *reinterpret_cast<uint2*>(taps + at) = *reinterpret_cast<const uint2*>(tap);
  }
}

__global__ void bn_pool_bwd_kernel(const __nv_bfloat16* __restrict__ y,
                                   const float* __restrict__ sc, const float* __restrict__ sh,
                                   const uint8_t* __restrict__ taps,
                                   const __nv_bfloat16* __restrict__ g, float* __restrict__ dz,
                                   Shape s) {
  const int C8 = s.C / 8;
  const long long total = static_cast<long long>(s.B) * s.H * s.W * C8;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C8) * 8;
    long long rest = i / C8;
    const int w = static_cast<int>(rest % s.W);
    rest /= s.W;
    const int h = static_cast<int>(rest % s.H);
    const int b = static_cast<int>(rest / s.H);
    float acc[8] = {};
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      // the pooled cell whose tap k is this pixel: oh * stride + kh - 1 == h
      const int hn = h + 1 - k / 3, wn = w + 1 - k % 3;
      if (hn < 0 || wn < 0 || hn % s.stride || wn % s.stride) continue;
      const int oh = hn / s.stride, ow = wn / s.stride;
      if (oh >= s.Ho || ow >= s.Wo) continue;
      const size_t at = ((static_cast<size_t>(b) * s.Ho + oh) * s.Wo + ow) * s.C + c;
      const uint2 tv = *reinterpret_cast<const uint2*>(taps + at);
      const uint4 gv = *reinterpret_cast<const uint4*>(g + at);
      const uint8_t* tp = reinterpret_cast<const uint8_t*>(&tv);
      const __nv_bfloat16* gp = reinterpret_cast<const __nv_bfloat16*>(&gv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (tp[j] == k) acc[j] += __bfloat162float(gp[j]);
    }
    float scv[8], shv[8];
    load_affine(sc, sh, c, scv, shv);
    const size_t at = ((static_cast<size_t>(b) * s.H + h) * s.W + w) * s.C + c;
    const uint4 raw = *reinterpret_cast<const uint4*>(y + at);
    const __nv_bfloat16* yv = reinterpret_cast<const __nv_bfloat16*>(&raw);
    __align__(16) float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = affine(__bfloat162float(yv[j]), scv[j], shv[j]) >= 0.f ? acc[j]
                                                                     : __fmul_rn(acc[j], 0.1f);
    float4* dst = reinterpret_cast<float4*>(dz + at);
    dst[0] = *reinterpret_cast<const float4*>(o);
    dst[1] = *reinterpret_cast<const float4*>(o + 4);
  }
}

// enough blocks of 256 threads to fill the card a few times over; the
// kernels stride over the rest
inline int grid_for(long long items) {
  const long long blocks = (items + 255) / 256;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

inline bool valid(const Shape& s) {
  return s.C % 8 == 0 && (s.stride == 1 || s.stride == 2) && s.B > 0 && s.H > 0 && s.W > 0;
}

}  // namespace

// out (B,Ho,Wo,C) bf16 and taps (B,Ho,Wo,C) uint8 from y (B,H,W,C) bf16 and
// sc/sh (C,) f32; Ho = (H-1)/stride + 1. Requires C % 8 == 0.
extern "C" int bn_pool_fwd_launch(const void* y, const void* sc, const void* sh, void* out,
                                  void* taps, int B, int H, int W, int C, int stride,
                                  void* stream) {
  const Shape s{B, H, W, C, stride, (H - 1) / stride + 1, (W - 1) / stride + 1};
  if (!valid(s)) return cudaErrorInvalidValue;
  bn_pool_fwd_kernel<<<grid_for(static_cast<long long>(B) * s.Ho * s.Wo * (C / 8)), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(sc),
      static_cast<const float*>(sh), static_cast<__nv_bfloat16*>(out),
      static_cast<uint8_t*>(taps), s);
  return static_cast<int>(cudaGetLastError());
}

// dz (B,H,W,C) f32 from y, sc, sh, the saved taps and g (B,Ho,Wo,C) bf16.
extern "C" int bn_pool_bwd_launch(const void* y, const void* sc, const void* sh,
                                  const void* taps, const void* g, void* dz, int B, int H, int W,
                                  int C, int stride, void* stream) {
  const Shape s{B, H, W, C, stride, (H - 1) / stride + 1, (W - 1) / stride + 1};
  if (!valid(s)) return cudaErrorInvalidValue;
  bn_pool_bwd_kernel<<<grid_for(static_cast<long long>(B) * H * W * (C / 8)), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(sc),
      static_cast<const float*>(sh), static_cast<const uint8_t*>(taps),
      static_cast<const __nv_bfloat16*>(g), static_cast<float*>(dz), s);
  return static_cast<int>(cudaGetLastError());
}
