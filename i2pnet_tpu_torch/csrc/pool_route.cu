// The routed backward of the native encoder chain's 3x3 max-pool, stride 1
// and stride 2: dx from the winning tap of every pooled cell and its
// cotangent.
//
// Replaces the TPU kernel i2pnet_tpu/nn/layers.py _pool3_route_kernel (:165,
// launched by _pool3_route_pallas at :256 for stride 1 and :271 for stride
// 2): dx[b, h, w, c] = the sum, over the <= 9 pooled cells (<= 4 at stride
// 2) whose window covers (h, w), in tap order o = 0..8, of ct at that cell
// where its argtap names this pixel's tap. The sum is in ct's dtype,
// rounded after every add, as the JAX kernel's `acc + sl`. argtap is uint8,
// 0-8, and 9 where the cell routes nowhere.
//
// The TPU's channel-major tiles, row halos and stride-2 parity planes with
// their transpose are not carried over: one thread per (input pixel,
// channel) gathers its cells directly in NHWC, channel fastest, so
// neighbouring threads read neighbouring bytes and no atomics are needed.
// What bounds it on the H100: bytes (argtap and ct read, dx written; a
// compare per covering cell); the overlapping reads at stride 1 hit the
// caches.

#include "common.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// a + b rounded to T: for bf16 the f32 sum of two bf16 values rounded once
// more is the correctly rounded bf16 sum
__device__ __forceinline__ float add_in(float a, float b, float*) { return a + b; }
__device__ __forceinline__ float add_in(float a, float b, __nv_bfloat16*) {
  return bf16_round(a + b);
}

template <int S, typename T>
__global__ void pool_route_kernel(const uint8_t* __restrict__ argtap, const T* __restrict__ ct,
                                  T* __restrict__ dx, int B, int Ho, int Wo, int C) {
  const int H = Ho * S, W = Wo * S;
  const long long total = static_cast<long long>(B) * H * W * C;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C);
    long long rest = i / C;
    const int w = static_cast<int>(rest % W);
    rest /= W;
    const int h = static_cast<int>(rest % H);
    const int b = static_cast<int>(rest / H);
    float acc = 0.f;
#pragma unroll
    for (int o = 0; o < 9; ++o) {
      // the cell whose tap o is this pixel: m * S + o / 3 - 1 == h
      const int hn = h + 1 - o / 3, wn = w + 1 - o % 3;
      if (hn < 0 || wn < 0 || hn % S || wn % S) continue;
      const int m = hn / S, n = wn / S;
      if (m >= Ho || n >= Wo) continue;
      const size_t at = ((static_cast<size_t>(b) * Ho + m) * Wo + n) * C + c;
      if (argtap[at] == o) acc = add_in(acc, to_f32(ct[at]), dx);
    }
    store(dx + i, acc);
  }
}

inline int grid_for(long long items) {
  const long long blocks = (items + 255) / 256;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

template <typename T>
int launch(const void* argtap, const void* ct, void* dx, int B, int Ho, int Wo, int C,
           int stride, cudaStream_t stream) {
  const long long items = static_cast<long long>(B) * Ho * stride * Wo * stride * C;
  const auto* at = static_cast<const uint8_t*>(argtap);
  const auto* c = static_cast<const T*>(ct);
  auto* d = static_cast<T*>(dx);
  if (stride == 1)
    pool_route_kernel<1, T><<<grid_for(items), 256, 0, stream>>>(at, c, d, B, Ho, Wo, C);
  else
    pool_route_kernel<2, T><<<grid_for(items), 256, 0, stream>>>(at, c, d, B, Ho, Wo, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dx (B, stride*Ho, stride*Wo, C) from argtap (B,Ho,Wo,C) uint8 and ct
// (B,Ho,Wo,C), both in ct's dtype: bf16 when is_bf16, else f32.
extern "C" int pool_route_launch(const void* argtap, const void* ct, void* dx, int B, int Ho,
                                 int Wo, int C, int stride, int is_bf16, void* stream) {
  if ((stride != 1 && stride != 2) || B <= 0 || Ho <= 0 || Wo <= 0 || C <= 0)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(argtap, ct, dx, B, Ho, Wo, C, stride, s)
                 : launch<float>(argtap, ct, dx, B, Ho, Wo, C, stride, s);
}
