// The fused eval-mode all-pixels cost volume (cost_volume1's pi side).
//
// Replaces the TPU kernel i2pnet_tpu/ops/cv_pallas.py _cv1_kernel (:58,
// built by _make_cv1 :122, launched :139 via fused_cv1_eval :182). Per
// query point n of batch row b, over all K image pixels k:
//   corr = qn[k] * pn[n]                                   (bf16 product)
//   h1 = bf16(leaky(corr @ W1c + t_qi[k] + t_pi[n]))
//   h2 = bf16(leaky(h1 @ W2 + b2))
//   h3 = leaky(h2 @ W3 + b3)          (f32; a bf16 copy feeds mlp2)
//   e  = bf16(leaky(e_qi[k] + e_pi[n]))
//   g1 = bf16(leaky(e @ V1a + bf16(h3) @ V1b + v1))
//   g2 = leaky(g1 @ V2 + v2)          (f32)
//   out[n] = sum_k softmax_k(g2)[k] * h3[k]    (softmax per channel over K)
// Matrix products take bf16 operands and accumulate in f32, as the TPU
// kernel's dot_general(..., preferred_element_type=f32).
//
// What bounds it on the H100: multiply-adds, 53,248 per (n, k) pair: about
// 105 GFLOP per forward at B = 8, N = 256, K = 480 (0.106 ms at the bf16
// peak). Unfused, the (B, N, K, *) intermediates (~0.5 GB each in f32)
// would make it memory-bound instead.
//
// The design, on Hopper's warpgroup MMA (wgmma, sm_90a):
// - A persistent grid of one block a SM, two consumer warpgroups (128
//   threads each). A warpgroup takes one query at a time and walks its K
//   pixels in 64-row tiles (the last masked); the block's two warpgroups
//   work on different queries, so one's epilogue (bias, leaky, rounding,
//   softmax) overlaps the other's products on the tensor cores.
// - The folded weights (106 KB of bf16 at the shipped widths) are copied
//   once per block into shared memory in wgmma's K-major layout with the
//   128-byte swizzle, zero-padded to the instruction's N (128 for W1, V1;
//   64 for W2, W3, V2) and to K in steps of 64 (the swizzle keeps the
//   tensor cores' reads of B free of bank conflicts).
// - Each layer is one asynchronous wgmma group, m64nNk16 with A from
//   registers (the RS form): the f32 accumulator of one layer is, 16
//   columns at a time, exactly the A fragment of the next layer's k16 step,
//   so each slice is finished (bias, leaky, bf16) and packed straight into
//   the next operand -- as FlashAttention-3 feeds P to P.V. Nothing between
//   the layers touches shared or device memory.
// - The per-pixel factors t_qi and e_qi are loaded from device memory (L2)
//   while the previous layer's wgmma group runs, so their latency hides
//   behind the products; qn is read straight into layer 1's A fragments.
// - The softmax over K keeps an online max-and-rescale state per channel
//   and thread (running max m, sum s of exp(g2 - m), sum a of exp(g2 - m)
//   * h3) across the query's tiles; the 8 lanes that share a column merge
//   by shuffles, the warpgroup's 4 warps through shared memory. Against
//   the plain version's two-pass softmax only the exponentials' rounding
//   differs.

#include "common.cuh"

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kWGs = 2;  // consumer warpgroups a block
constexpr int kThreads = 128 * kWGs;
constexpr int kM = 64;        // pixels a tile: the wgmma's M
constexpr int kWide = 128;    // C, H1, G1 at most (and the N of W1, V1)
constexpr int kNarrow = 64;   // H2, H3, E, G2 at most (and the N of W2, W3, V2)

struct Dims {
  int C, H1, H2, H3, E, G1, G2;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

struct Layout {  // byte offsets into dynamic shared memory
  size_t w1, w2, w3, v1a, v1b, v2, b2, b3, v1, v2b, wg, total;
  static constexpr size_t kWgBytes = sizeof(float) * (kWide + kWide + kNarrow + 4 * 3 * kNarrow);
};

__host__ __device__ inline int round64(int k) { return (k + 63) / 64 * 64; }

__host__ __device__ inline Layout layout(const Dims& d) {
  Layout L;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += align16(bytes);
    return at;
  };
  // a B operand starts on a 1024-byte boundary, where its swizzle pattern does
  auto take_b = [&o](int nmax, int k) {
    o = (o + 1023) & ~static_cast<size_t>(1023);
    const size_t at = o;
    o += sizeof(bf16) * nmax * round64(k);
    return at;
  };
  L.w1 = take_b(kWide, d.C);
  L.w2 = take_b(kNarrow, d.H1);
  L.w3 = take_b(kNarrow, d.H2);
  L.v1a = take_b(kWide, d.E);
  L.v1b = take_b(kWide, d.H3);
  L.v2 = take_b(kNarrow, d.G1);
  o = align16(o);
  L.b2 = take(sizeof(float) * kNarrow);
  L.b3 = take(sizeof(float) * kNarrow);
  L.v1 = take(sizeof(float) * kWide);
  L.v2b = take(sizeof(float) * kNarrow);
  L.wg = take(Layout::kWgBytes * kWGs);  // per warpgroup: pn, t_pi, e_pi, merge
  L.total = o;
  return L;
}

// W (K, N) row-major bf16 -> B[n][k] in wgmma's K-major layout with the
// 128-byte swizzle: K in atoms of 64 (zero-padded), atom a holding rows n
// of 128 bytes at a * NMAX * 64 + n * 64 elements, whose 16-byte chunk c
// sits at chunk c ^ (n % 8); rows n in [N, NMAX) zero.
__device__ void copy_b(bf16* dst, const bf16* src, int K, int N, int NMAX) {
  const int Kp = round64(K);
  for (int i = threadIdx.x; i < NMAX * Kp; i += blockDim.x) {
    const int n = i / Kp, k = i % Kp, kk = k & 63;
    dst[(k >> 6) * (NMAX * 64) + n * 64 + (((kk >> 3) ^ (n & 7)) << 3) + (kk & 7)] =
        n < N && k < K ? src[k * N + n] : __float2bfloat16_rn(0.f);
  }
}

__device__ void copy_padded(float* dst, const float* src, int n, int nmax) {
  for (int i = threadIdx.x; i < nmax; i += blockDim.x) dst[i] = i < n ? src[i] : 0.f;
}

// The wgmma descriptor of a B operand of NMAX rows in that layout, at k16
// step ks: the start address (the atom, then 32 bytes a step within its
// rows, which the hardware swizzles), SBO 1024 bytes between groups of 8
// rows (LBO unused), 128-byte swizzle.
template <int NMAX>
__device__ __forceinline__ uint64_t b_desc(const bf16* base, int ks) {
  const uint32_t addr = static_cast<uint32_t>(
      __cvta_generic_to_shared(base + (ks >> 2) * (NMAX * 64) + (ks & 3) * 16));
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma group
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// the A fragments of a group stay live until its wait: the compiler may
// not hand their registers to anything else while the tensor cores read them
template <int R>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 128, this thread's 64 f32) += A (64 x 16 bf16 in registers) @ B (16 x 128,
// descriptor b); d = A @ B when accumulate is 0
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 64, this thread's 32 f32) += A (64 x 16 bf16 in registers) @ B (16 x 64,
// descriptor b); d = A @ B when accumulate is 0
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}


// the warpgroup's own barrier (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
cv1_kernel(const bf16* __restrict__ pn, const float* __restrict__ tpi,
           const float* __restrict__ epi, const bf16* __restrict__ qn,
           const float* __restrict__ tqi, const float* __restrict__ eqi,
           const bf16* __restrict__ w1c, const bf16* __restrict__ w2,
           const float* __restrict__ b2, const bf16* __restrict__ w3,
           const float* __restrict__ b3, const bf16* __restrict__ v1a,
           const bf16* __restrict__ v1b, const float* __restrict__ v1,
           const bf16* __restrict__ v2, const float* __restrict__ v2b, float* __restrict__ out,
           int B, int N, int K, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(d);
  bf16* sW1 = reinterpret_cast<bf16*>(smem + L.w1);
  bf16* sW2 = reinterpret_cast<bf16*>(smem + L.w2);
  bf16* sW3 = reinterpret_cast<bf16*>(smem + L.w3);
  bf16* sV1a = reinterpret_cast<bf16*>(smem + L.v1a);
  bf16* sV1b = reinterpret_cast<bf16*>(smem + L.v1b);
  bf16* sV2 = reinterpret_cast<bf16*>(smem + L.v2);
  const float* s_b2 = reinterpret_cast<const float*>(smem + L.b2);
  const float* s_b3 = reinterpret_cast<const float*>(smem + L.b3);
  const float* s_v1 = reinterpret_cast<const float*>(smem + L.v1);
  const float* s_v2 = reinterpret_cast<const float*>(smem + L.v2b);

  copy_b(sW1, w1c, d.C, d.H1, kWide);
  copy_b(sW2, w2, d.H1, d.H2, kNarrow);
  copy_b(sW3, w3, d.H2, d.H3, kNarrow);
  copy_b(sV1a, v1a, d.E, d.G1, kWide);
  copy_b(sV1b, v1b, d.H3, d.G1, kWide);
  copy_b(sV2, v2, d.G1, d.G2, kNarrow);
  copy_padded(reinterpret_cast<float*>(smem + L.b2), b2, d.H2, kNarrow);
  copy_padded(reinterpret_cast<float*>(smem + L.b3), b3, d.H3, kNarrow);
  copy_padded(reinterpret_cast<float*>(smem + L.v1), v1, d.G1, kWide);
  copy_padded(reinterpret_cast<float*>(smem + L.v2b), v2b, d.G2, kNarrow);
  __syncthreads();

  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const int wwarp = wt >> 5, lane = wt & 31;
  const int g = lane >> 2, t = lane & 3;
  float* s_pn = reinterpret_cast<float*>(smem + L.wg + wg * Layout::kWgBytes);
  float* s_tpi = s_pn + kWide;
  float* s_epi = s_tpi + kWide;
  float* merge = s_epi + kNarrow;  // [4 warps][m, s, a][kNarrow]
  const int ktC = d.C / 16, ktH1 = d.H1 / 16, ktH2 = d.H2 / 16, ktH3 = d.H3 / 16;
  const int ktE = d.E / 16, ktG1 = d.G1 / 16;

  for (int q = blockIdx.x * kWGs + wg; q < B * N; q += gridDim.x * kWGs) {  // flat (b, n)
    const int b = q / N;
    wg_sync(wg);  // the previous query's merge is read
    for (int c = wt; c < kWide; c += 128) {
      s_pn[c] = c < d.C ? __bfloat162float(pn[static_cast<size_t>(q) * d.C + c]) : 0.f;
      s_tpi[c] = c < d.H1 ? tpi[static_cast<size_t>(q) * d.H1 + c] : 0.f;
      if (c < kNarrow) s_epi[c] = c < d.E ? epi[static_cast<size_t>(q) * d.E + c] : 0.f;
    }
    wg_sync(wg);

    float sm_m[kNarrow / 4], sm_s[kNarrow / 4], sm_a[kNarrow / 4];  // column 8 (i / 2) + 2t + i % 2
#pragma unroll
    for (int i = 0; i < kNarrow / 4; ++i) {
      sm_m[i] = -INFINITY;
      sm_s[i] = 0.f;
      sm_a[i] = 0.f;
    }

    for (int k0 = 0; k0 < K; k0 += kM) {
      int rows[2];
      bool valid[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        rows[rr] = k0 + 16 * wwarp + g + 8 * rr;
        valid[rr] = rows[rr] < K;
      }
      const size_t row0 = static_cast<size_t>(b) * K;

      // corr = qn[k] * pn[n] in bf16, straight into layer 1's A fragments
      uint32_t a_x[kWide / 16][4];
#pragma unroll
      for (int ks = 0; ks < kWide / 16; ++ks) {
        if (ks < ktC) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int c = ks * 16 + half * 8 + 2 * t;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              float2 qv = make_float2(0.f, 0.f);
              if (valid[rr])
                qv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(qn + (row0 + rows[rr]) * d.C + c));
              a_x[ks][half * 2 + rr] = pack_bf16(qv.x * s_pn[c], qv.y * s_pn[c + 1]);
            }
          }
        }
      }

      // layer 1: h1 = bf16(leaky(corr @ W1c + t_qi + t_pi)); t_qi is read
      // while the products run
      float acc[kWide / 2] = {};
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWide / 16; ++ks)
        if (ks < ktC) wgmma_n128(acc, a_x[ks], b_desc<kWide>(sW1, ks), ks);
      wgmma_commit();
      float2 fq[kWide / 8][2];
#pragma unroll
      for (int j = 0; j < kWide / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int c = 8 * j + 2 * t;
          fq[j][rr] = valid[rr] && c < d.H1
                          ? __ldg(reinterpret_cast<const float2*>(tqi + (row0 + rows[rr]) * d.H1 + c))
                          : make_float2(0.f, 0.f);
        }
      wgmma_wait_all();
      fence_regs(acc);
      fence_frags(a_x);
#pragma unroll
      for (int j = 0; j < kWide / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int c = 8 * j + 2 * t;
          a_x[j >> 1][(j & 1) * 2 + rr] =
              pack_bf16(leaky01((acc[4 * j + 2 * rr] + fq[j][rr].x) + s_tpi[c]),
                        leaky01((acc[4 * j + 2 * rr + 1] + fq[j][rr].y) + s_tpi[c + 1]));
        }

      // layer 2: h2 = bf16(leaky(h1 @ W2 + b2)); e_qi is read meanwhile
      float acc2[kNarrow / 2] = {};
      fence_regs(acc2);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWide / 16; ++ks)
        if (ks < ktH1) wgmma_n64(acc2, a_x[ks], b_desc<kNarrow>(sW2, ks), ks);
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < kNarrow / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int c = 8 * j + 2 * t;
          fq[j][rr] = valid[rr] && c < d.E
                          ? __ldg(reinterpret_cast<const float2*>(eqi + (row0 + rows[rr]) * d.E + c))
                          : make_float2(0.f, 0.f);
        }
      wgmma_wait_all();
      fence_regs(acc2);
      fence_frags(a_x);
      uint32_t a_h[kNarrow / 16][4];
#pragma unroll
      for (int j = 0; j < kNarrow / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int c = 8 * j + 2 * t;
          a_h[j >> 1][(j & 1) * 2 + rr] = pack_bf16(leaky01(acc2[4 * j + 2 * rr] + s_b2[c]),
                                                    leaky01(acc2[4 * j + 2 * rr + 1] + s_b2[c + 1]));
        }

      // layer 3: h3 = leaky(h2 @ W3 + b3) in f32; meanwhile e = bf16(leaky(e_qi + e_pi))
      float h3[kNarrow / 2] = {};
      fence_regs(h3);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kNarrow / 16; ++ks)
        if (ks < ktH2) wgmma_n64(h3, a_h[ks], b_desc<kNarrow>(sW3, ks), ks);
      wgmma_commit();
      uint32_t a_e[kNarrow / 16][4];
#pragma unroll
      for (int j = 0; j < kNarrow / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int c = 8 * j + 2 * t;
          a_e[j >> 1][(j & 1) * 2 + rr] = pack_bf16(leaky01(fq[j][rr].x + s_epi[c]),
                                                    leaky01(fq[j][rr].y + s_epi[c + 1]));
        }
      wgmma_wait_all();
      fence_regs(h3);
      fence_frags(a_h);
#pragma unroll
      for (int j = 0; j < kNarrow / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int c = 8 * j + 2 * t;
          h3[4 * j + 2 * rr] = leaky01(h3[4 * j + 2 * rr] + s_b3[c]);
          h3[4 * j + 2 * rr + 1] = leaky01(h3[4 * j + 2 * rr + 1] + s_b3[c + 1]);
          a_h[j >> 1][(j & 1) * 2 + rr] = pack_bf16(h3[4 * j + 2 * rr], h3[4 * j + 2 * rr + 1]);
        }

      // layer 4: g1 = bf16(leaky(e @ V1a + h3 @ V1b + v1))
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kNarrow / 16; ++ks)
        if (ks < ktE) wgmma_n128(acc, a_e[ks], b_desc<kWide>(sV1a, ks), ks);
#pragma unroll
      for (int ks = 0; ks < kNarrow / 16; ++ks)
        if (ks < ktH3) wgmma_n128(acc, a_h[ks], b_desc<kWide>(sV1b, ks), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_frags(a_e);
      fence_frags(a_h);
#pragma unroll
      for (int j = 0; j < kWide / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int c = 8 * j + 2 * t;
          a_x[j >> 1][(j & 1) * 2 + rr] = pack_bf16(leaky01(acc[4 * j + 2 * rr] + s_v1[c]),
                                                    leaky01(acc[4 * j + 2 * rr + 1] + s_v1[c + 1]));
        }

      // layer 5: g2 = leaky(g1 @ V2 + v2) in f32, folded into the online softmax
      fence_regs(acc2);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWide / 16; ++ks)
        if (ks < ktG1) wgmma_n64(acc2, a_x[ks], b_desc<kNarrow>(sV2, ks), ks);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc2);
      fence_frags(a_x);
#pragma unroll
      for (int i = 0; i < kNarrow / 2; ++i) {
        const int rr = (i >> 1) & 1;
        if (!valid[rr]) continue;
        const int si = (i >> 2) * 2 + (i & 1);  // the column's state
        const int c = 8 * (i >> 2) + 2 * t + (i & 1);
        const float gv = leaky01(acc2[i] + s_v2[c]);
        const float hv = h3[i];
        if (gv > sm_m[si]) {
          const float f = expf(sm_m[si] - gv);  // 0 while m is -inf
          sm_s[si] = sm_s[si] * f + 1.f;
          sm_a[si] = sm_a[si] * f + hv;
          sm_m[si] = gv;
        } else {
          const float f = expf(gv - sm_m[si]);
          sm_s[si] += f;
          sm_a[si] += f * hv;
        }
      }
    }

    // merge the 8 lanes that share t (they hold the same columns), then the
    // warpgroup's 4 warps
#pragma unroll
    for (int si = 0; si < kNarrow / 4; ++si) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, sm_m[si], off);
        const float s2 = __shfl_xor_sync(0xffffffffu, sm_s[si], off);
        const float a2 = __shfl_xor_sync(0xffffffffu, sm_a[si], off);
        const float M = fmaxf(sm_m[si], m2);
        const float f1 = sm_m[si] == -INFINITY ? 0.f : expf(sm_m[si] - M);
        const float f2 = m2 == -INFINITY ? 0.f : expf(m2 - M);
        sm_s[si] = sm_s[si] * f1 + s2 * f2;
        sm_a[si] = sm_a[si] * f1 + a2 * f2;
        sm_m[si] = M;
      }
      const int c = 8 * (si >> 1) + 2 * t + (si & 1);
      if (g == 0) {
        merge[(wwarp * 3 + 0) * kNarrow + c] = sm_m[si];
        merge[(wwarp * 3 + 1) * kNarrow + c] = sm_s[si];
        merge[(wwarp * 3 + 2) * kNarrow + c] = sm_a[si];
      }
    }
    wg_sync(wg);
    if (wt < d.G2) {
      const int c = wt;
      float M = -INFINITY;
      for (int w = 0; w < 4; ++w) M = fmaxf(M, merge[(w * 3) * kNarrow + c]);
      float S = 0.f, A = 0.f;
      for (int w = 0; w < 4; ++w) {
        const float m = merge[(w * 3) * kNarrow + c];
        const float f = m == -INFINITY ? 0.f : expf(m - M);  // a warp with no rows
        S += merge[(w * 3 + 1) * kNarrow + c] * f;
        A += merge[(w * 3 + 2) * kNarrow + c] * f;
      }
      out[static_cast<size_t>(q) * d.H3 + c] = A / S;
    }
  }
}

}  // namespace

// pn (B,N,C) bf16, t_pi (B,N,H1) f32, e_pi (B,N,E) f32, qn (B,K,C) bf16,
// t_qi (B,K,H1) f32, e_qi (B,K,E) f32; weights bf16 row-major (in, out),
// biases f32; out (B,N,H3) f32. Every width a multiple of 16; C, H1, G1
// <= 128; H2, H3, E, G2 <= 64; G2 == H3.
extern "C" int cv1_launch(const void* pn, const void* tpi, const void* epi, const void* qn,
                          const void* tqi, const void* eqi, const void* w1c, const void* w2,
                          const void* b2, const void* w3, const void* b3, const void* v1a,
                          const void* v1b, const void* v1, const void* v2, const void* v2b,
                          void* out, int B, int N, int K, int C, int H1, int H2, int H3, int E,
                          int G1, int G2, void* stream) {
  const Dims d{C, H1, H2, H3, E, G1, G2};
  for (int v : {C, H1, H2, H3, E, G1, G2})
    if (v <= 0 || v % 16 != 0) return cudaErrorInvalidValue;
  for (int v : {C, H1, G1})
    if (v > kWide) return cudaErrorInvalidValue;
  for (int v : {H2, H3, E, G2})
    if (v > kNarrow) return cudaErrorInvalidValue;
  if (G2 != H3 || B <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const size_t smem = layout(d).total;
  cudaError_t err = cudaFuncSetAttribute(cv1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long wgs = (static_cast<long long>(B) * N + kWGs - 1) / kWGs;
  const int blocks = static_cast<int>(wgs < sm_count() ? wgs : sm_count());
  cv1_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(pn), static_cast<const float*>(tpi),
      static_cast<const float*>(epi), static_cast<const bf16*>(qn),
      static_cast<const float*>(tqi), static_cast<const float*>(eqi),
      static_cast<const bf16*>(w1c), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(w3),
      static_cast<const float*>(b3), static_cast<const bf16*>(v1a),
      static_cast<const bf16*>(v1b), static_cast<const float*>(v1),
      static_cast<const bf16*>(v2), static_cast<const float*>(v2b), static_cast<float*>(out), B,
      N, K, d);
  return static_cast<int>(cudaGetLastError());
}
