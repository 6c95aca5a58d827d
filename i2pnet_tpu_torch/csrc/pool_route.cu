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
// their transpose are not carried over. Kernel (d)'s layout (pool_tile.cuh),
// without the slope: a block owns a tile of input pixels of one batch row
// and CG groups of V channels (V = 8 where C allows, else 4, else 1: one
// template; the most groups, up to 8, that divide C / V), 256 threads.
// - It stages the argtap and ct of the pooled cells that cover the tile,
//   with their 1-cell halo, once, by cp.async (16 bytes a group of 8 bf16,
//   2 x 16 of 8 f32, 8 bytes of 8 taps; plain loads below 4 bytes); zeros
//   outside the pooled grid: tap 0 with a zero cotangent adds +0, which
//   leaves every sum as it is (a sum from +0 is never -0).
// - Stride, V and CG are template parameters, indices 32-bit from blockIdx
//   and threadIdx (a size_t base per batch row). At stride 2 the tile runs
//   in 4 parity passes resolved at compile time, so a pixel visits only its
//   1, 2 or 4 candidate taps, in ascending order.
// - For bf16 with 8 channels (the encoder's case) a tap costs a xor, an add,
//   4 prmt (sign mode: the bytes whose tap differs become 16-bit lane
//   masks), 4 and-nots and 4 bf16x2 adds, each add correctly rounded as
//   add_in's; other widths and f32 compare a channel at a time.
// - A thread writes its V channels of dx as one vector (16 bytes for 8
//   bf16, 2 x 16 for 8 f32), neighbouring lanes on neighbouring addresses.
// What bounds it, as measured (NVIDIA H100 80GB HBM3, 700.00 W,
// tools/torch_kernel_times.py): bytes at the large calls (the first
// free-step call, stride 2, 173 MB, at ~2.7 TB/s; the stride-1 calls at
// 192x640x16, 79 MB, at ~2.2 TB/s); the stages 2-3 calls sit at a launch
// and a round trip (2.8-4.4 us). The gather with a compare a channel was
// issue-bound: 0.236 ms against 0.155 for the 10 stride-1 calls of a free
// step, 0.0755 against 0.0533-0.0564 for a proj step's.

#include "pool_tile.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float& p, float v) { p = v; }
__device__ __forceinline__ void store(__nv_bfloat16& p, float v) { p = __float2bfloat16_rn(v); }

// a + b rounded to T: for bf16 the f32 sum of two bf16 values rounded once
// more is the correctly rounded bf16 sum
__device__ __forceinline__ float add_in(float a, float b, float*) { return a + b; }
__device__ __forceinline__ float add_in(float a, float b, __nv_bfloat16*) {
  return bf16_round(a + b);
}

// a + b of two packed bf16 pairs, each rounded to bf16
__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  const __nv_bfloat162 r = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const unsigned*>(&r);
}

// V channels of one pixel or cell, as one aligned vector
template <typename T, int V>
struct alignas(sizeof(T) * V) Lanes {
  T v[V];
};

// one staged L from global src, zeros where !ok: cp.async in 16-, 8- or
// 4-byte pieces, a plain load below 4 bytes
template <typename L>
__device__ __forceinline__ void stage(L* dst, const L* src, bool ok) {
  constexpr int N = sizeof(L);
  if constexpr (N >= 16) {
#pragma unroll
    for (int k = 0; k < N / 16; ++k)
      cp_async16(reinterpret_cast<uint4*>(dst) + k, reinterpret_cast<const uint4*>(src) + k,
                 ok ? 16 : 0);
  } else if constexpr (N == 8) {
    cp_async8(dst, src, ok ? 8 : 0);
  } else if constexpr (N == 4) {
    cp_async4(dst, src, ok ? 4 : 0);
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint16_t*>(dst) = ok ? *reinterpret_cast<const uint16_t*>(src) : 0;
  } else {
    *reinterpret_cast<uint8_t*>(dst) = ok ? *reinterpret_cast<const uint8_t*>(src) : 0;
  }
}

// the pass rows: 16, halved while the grid has fewer than 1.5 blocks a SM
// at stride 1 and 4 at stride 2 (the measured best of 1, 1.5, 2, 4 and 8:
// a larger tile pays its halo and its load's latency once; at stride 2 the
// halo is thinner and more blocks hide the latency better)
constexpr int kRouteMaxRows = 16;

template <int S, int CG, int V, typename T>
__global__ void __launch_bounds__(kPoolThreads)
pool_route_kernel(const uint8_t* __restrict__ argtap, const T* __restrict__ ct,
                  T* __restrict__ dx, int Ho, int Wo, int C, int rows, int tiles_x, int tiles_y) {
  using P = PoolTile<S, CG>;
  using Cts = Lanes<T, V>;
  using Taps = Lanes<uint8_t, V>;
  constexpr bool kPairs = sizeof(T) == 2 && V == 8;
  extern __shared__ uint4 shared[];
  const int ncell = P::cell_rows(rows) * P::NC * CG;
  Cts* c_s = reinterpret_cast<Cts*>(shared);
  Taps* t_s = reinterpret_cast<Taps*>(c_s + ncell);
  const int H = Ho * S, W = Wo * S;

  const PoolBlock blk(tiles_x, tiles_y, C / (V * CG));
  const int c0 = blk.chunk * CG * V;
  const int h0 = blk.ty * rows * S, w0 = blk.tx * P::TW;
  const int oh0 = P::first_cell(h0), ow0 = P::first_cell(w0);

  const size_t cells = static_cast<size_t>(blk.b) * Ho * Wo * C + c0;
  for (int i = threadIdx.x; i < ncell; i += kPoolThreads) {
    const int gi = i % CG, cell = i / CG;
    const int oh = oh0 + cell / P::NC, ow = ow0 + cell % P::NC;
    const bool ok = oh >= 0 && oh < Ho && ow >= 0 && ow < Wo;
    const size_t at = cells + (ok ? static_cast<size_t>(oh * Wo + ow) * C + gi * V : 0);
    stage(c_s + i, reinterpret_cast<const Cts*>(ct + at), ok);
    stage(t_s + i, reinterpret_cast<const Taps*>(argtap + at), ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // every item of a thread has the same channel group (kPoolThreads % CG == 0)
  const int gi = threadIdx.x % CG;
  T* dxb = dx + static_cast<size_t>(blk.b) * H * W * C + c0 + gi * V;
  const int items = rows * 64 / kPoolThreads;
#pragma unroll
  for (int py = 0; py < S; ++py)
#pragma unroll
    for (int px = 0; px < S; ++px)
#pragma unroll 2
      for (int u = 0; u < items; ++u) {
        const int it = threadIdx.x + u * kPoolThreads;
        const int j = it / CG % P::kPassCols, i = it / (CG * P::kPassCols);
        const int h = h0 + S * i + py, w = w0 + S * j + px;
        if (h >= H || w >= W) continue;
        T* dst = dxb + static_cast<size_t>(h * W + w) * C;
        if constexpr (kPairs) {
          // bf16, 8 channels: the cotangents of the channels whose tap is
          // this pixel's, the others masked to +0, added as bf16 pairs
          // (each add correctly rounded, as add_in's)
          uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int kh = 0; kh < 3; ++kh) {
            if ((py + 1 - kh) % S != 0) continue;
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
              if ((px + 1 - kw) % S != 0) continue;
              const int e = (P::cell_of(i, py, kh) * P::NC + P::cell_of(j, px, kw)) * CG + gi;
              const uint2 tv = *reinterpret_cast<const uint2*>(t_s + e);
              const uint4 cv = *reinterpret_cast<const uint4*>(c_s + e);
              // bit 7 of each byte set where that channel's tap is not this
              // one (taps and o are below 16: no carry between bytes)
              const unsigned o4 = 0x01010101u * (kh * 3 + kw);
              const unsigned n0 = (tv.x ^ o4) + 0x7f7f7f7fu, n1 = (tv.y ^ o4) + 0x7f7f7f7fu;
              acc = make_uint4(add2(acc.x, cv.x & ~sign_lanes(n0, 0x9988)),
                               add2(acc.y, cv.y & ~sign_lanes(n0, 0xbbaa)),
                               add2(acc.z, cv.z & ~sign_lanes(n1, 0x9988)),
                               add2(acc.w, cv.w & ~sign_lanes(n1, 0xbbaa)));
            }
          }
          *reinterpret_cast<uint4*>(dst) = acc;
        } else {
          float acc[V] = {};
#pragma unroll
          for (int kh = 0; kh < 3; ++kh) {
            if ((py + 1 - kh) % S != 0) continue;
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
              if ((px + 1 - kw) % S != 0) continue;
              const int e = (P::cell_of(i, py, kh) * P::NC + P::cell_of(j, px, kw)) * CG + gi;
              const Taps tv = t_s[e];
              const Cts cv = c_s[e];
#pragma unroll
              for (int q = 0; q < V; ++q)
                if (tv.v[q] == kh * 3 + kw) acc[q] = add_in(acc[q], to_f32(cv.v[q]), dx);
            }
          }
          Cts o;
#pragma unroll
          for (int q = 0; q < V; ++q) store(o.v[q], acc[q]);
          *reinterpret_cast<Cts*>(dst) = o;
        }
      }
}

template <int S, int CG, int V, typename T>
cudaError_t launch_route(const uint8_t* argtap, const T* ct, T* dx, int B, int Ho, int Wo, int C,
                         cudaStream_t stream) {
  using P = PoolTile<S, CG>;
  const int tiles_x = (Wo * S + P::TW - 1) / P::TW;
  const long long rows_of_tiles = static_cast<long long>(tiles_x) * B * (C / (V * CG));
  const int rows = pool_pass_rows(kRouteMaxRows, S, Ho * S, rows_of_tiles, S == 1 ? 3 : 8);
  const int tiles_y = (Ho * S + S * rows - 1) / (S * rows);
  const int smem = P::cell_rows(rows) * P::NC * CG * static_cast<int>(sizeof(Lanes<T, V>) + V);
  return launch_pool_tiles(pool_route_kernel<S, CG, V, T>, tiles_y * rows_of_tiles, smem, stream,
                           argtap, ct, dx, Ho, Wo, C, rows, tiles_x, tiles_y);
}

template <int S, int V, typename T>
cudaError_t launch_v(const uint8_t* argtap, const T* ct, T* dx, int B, int Ho, int Wo, int C,
                     cudaStream_t stream) {
  // CG: the most V-channel groups, up to 8, that divide C / V
  const int G = C / V;
  if (G % 8 == 0) return launch_route<S, 8, V>(argtap, ct, dx, B, Ho, Wo, C, stream);
  if (G % 4 == 0) return launch_route<S, 4, V>(argtap, ct, dx, B, Ho, Wo, C, stream);
  if (G % 2 == 0) return launch_route<S, 2, V>(argtap, ct, dx, B, Ho, Wo, C, stream);
  return launch_route<S, 1, V>(argtap, ct, dx, B, Ho, Wo, C, stream);
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int S, typename T>
cudaError_t launch(const void* argtap, const void* ct, void* dx, int B, int Ho, int Wo, int C,
                   cudaStream_t stream) {
  const auto* at = static_cast<const uint8_t*>(argtap);
  const auto* c = static_cast<const T*>(ct);
  auto* d = static_cast<T*>(dx);
  // V: the widest vector that C and the operands' alignment allow
  const auto fits = [&](int v) {
    return C % v == 0 && aligned(at, v) && aligned(c, v * sizeof(T)) && aligned(d, v * sizeof(T));
  };
  if (fits(8)) return launch_v<S, 8>(at, c, d, B, Ho, Wo, C, stream);
  if (fits(4)) return launch_v<S, 4>(at, c, d, B, Ho, Wo, C, stream);
  return launch_v<S, 1>(at, c, d, B, Ho, Wo, C, stream);
}

}  // namespace

// dx (B, stride*Ho, stride*Wo, C) from argtap (B,Ho,Wo,C) uint8 and ct
// (B,Ho,Wo,C), both in ct's dtype: bf16 when is_bf16, else f32.
extern "C" int pool_route_launch(const void* argtap, const void* ct, void* dx, int B, int Ho,
                                 int Wo, int C, int stride, int is_bf16, void* stream) {
  if ((stride != 1 && stride != 2) || B <= 0 || Ho <= 0 || Wo <= 0 || C <= 0)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (stride == 1)
    return is_bf16 ? launch<1, __nv_bfloat16>(argtap, ct, dx, B, Ho, Wo, C, s)
                   : launch<1, float>(argtap, ct, dx, B, Ho, Wo, C, s);
  return is_bf16 ? launch<2, __nv_bfloat16>(argtap, ct, dx, B, Ho, Wo, C, s)
                 : launch<2, float>(argtap, ct, dx, B, Ho, Wo, C, s);
}
