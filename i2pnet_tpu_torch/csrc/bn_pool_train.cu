// The train-mode RGB-encoder block's BN epilogue and pool: kernel (c), its
// forward with the winning taps, and kernel (d), its backward; kernel (e),
// the forward without taps, and kernel (f), the backward that recomputes
// the taps.
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
//   (e) _bn_pool_kernel (:302, launched by _bn_pool_fwd_p :375): (c) without
//       the taps, the forward of the pallas/native/sas backends and of every
//       call that needs no gradient. One template of (c)'s kernel.
//   (f) _bn_pool_bwd_kernel (:397, launched by _bn_pool_bwd_p :588): (d)'s dz
//       from y, sc, sh and g alone: (c)'s staging, activation and scan over
//       the pooled cells that cover a tile of input pixels, then (d)'s
//       gather. dz equals (d)'s on (c)'s taps bit for bit.
// The TPU's lane rolls, row pairing and even-w selection matmuls are not
// carried over.
//
// What bounds them on the H100: bytes (a few operations per element). Every
// global access is a 16-byte vector (8 bf16, 8 taps as 8 bytes, 8 f32 as
// two); neighbouring threads take neighbouring channel groups and pixels.
//
// (c) and (e), one template: a block owns a tile of pooled cells of one
// batch row (th x 64/CG; th 32 at stride 1, 16 at stride 2, halved down to
// 4 while the grid would not fill the card) and CG 8-channel groups (the
// most, up to 8, that divide C / 8), 256 threads.
// - Indices are 32-bit, from blockIdx and threadIdx; the stride and CG are
//   template parameters, so every division is by a constant.
// - It stages the input pixels that the tile's windows cover, with the
//   halo, once, by 16-byte cp.async, then activates each staged pixel once
//   in place, a = bf16(LeakyReLU(y * sc + sh)) (each input pixel is
//   activated once a tile, not once for each of the up to 9 windows that
//   hold it), and -inf off the image: the plain version's pad. A zero
//   there would activate to bf16(LeakyReLU(sh)), which can win. sc and sh
//   are loaded once a thread (all of a thread's vectors have its channel
//   group).
// - Each (cell, group) scans its 9 taps from shared memory in row-major
//   order by a strict >, on bf16 pairs (__hgt2_mask: the float compare of
//   the same values), the masks selecting the new maxima and, as byte
//   masks, their taps. No max tree: max() of two equal values (+0, -0)
//   may return the later one and move the tap. At stride 2 a staged row
//   keeps its even columns before its odd ones, so the lanes' taps read
//   consecutive vectors.
// - out is written as 16-byte vectors, taps as 8-byte ones, neighbouring
//   lanes on neighbouring addresses.
// What bounds it, as measured (NVIDIA H100 80GB HBM3, 700.00 W,
// tools/torch_kernel_times.py): the first call (stride 2, 384x1280, 16
// channels, 173 MB) moves ~2.3 TB/s; a copy of the kernel that stages and
// stores but neither activates nor scans is only ~10% faster, so the
// stage-then-store pattern of a block, not its arithmetic, sets that pace.
// The stage 2-3 calls sit at a launch and a round trip (3-9 us). Slower:
// the activation and scan in f32, a compare and two selects a channel
// (0.46 ms a free step against 0.33 on the same tiles), and fixed tiles
// of 16 and 8 rows (0.31 against 0.30).

// (d): a block owns a tile of input pixels of one batch row (16 x 64/CG at
// stride 1, 32 x 128/CG at stride 2) and CG 8-channel groups (the most,
// up to 8, that divide C / 8), 256 threads.
// - It stages once, by 16- and 8-byte cp.async, the cotangents and taps of
//   the pooled cells that cover the tile (with their 1-cell halo), zeros
//   outside the pooled grid: a zero adds +0, which leaves every sum as it
//   is, so no lookup tests the grid. It loads sc and sh once a thread
//   (every item of a thread has the same channel group) and the first
//   pass's y while the cells land.
// - Indices are 32-bit, from blockIdx and threadIdx, divisions by powers
//   of two. At stride 2 the tile runs in 4 parity passes, (row, column)
//   parity resolved at compile time, so a pixel visits only its 1, 2 or 4
//   candidate cells; at stride 1 all 9. The sum runs k = 0..8 ascending, as
//   the plain version's, so dz stays bit-identical.
// - A thread writes its 8 f32 as two float4, neighbouring lanes on
//   neighbouring 32-byte runs of a pixel's channels.
// What bounds it, as measured (NVIDIA H100 80GB HBM3, 700.00 W,
// tools/torch_kernel_times.py): the first call (stride 2, 384x1280, 16
// channels, 425 MB) runs at ~2 TB/s, ~60% of the card's rate; the 24x80
// and 48x160 calls are latency-bound (a launch, one round trip to device
// memory, a few microseconds). Tried and slower: lanes 2k and 2k + 1
// swapping halves so that each float4 store writes whole 32-byte sectors
// (0.682 ms per free step against 0.59); in scratch builds timed together,
// 4 blocks a SM (64 registers: spills) and 128-thread blocks, while 8-row
// passes and streaming cache hints (__stcs, __ldcs) were no faster.

// The affine is spelled with __fmul_rn / __fadd_rn: nvcc would contract it
// into an FMA, and the plain PyTorch version rounds twice. Out and taps are
// then bit-identical to the plain version, and so is dz.

#include "pool_tile.cuh"

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

// (c) and (e): one block per tile of pooled cells of one batch row -- th x
// TW, TW = 64 / CG -- and CG 8-channel groups, kPoolThreads threads; 64
// (cell, group) items a tile row, th / 4 items a thread. th, the tile's
// rows, is halved from kMaxRows while the grid would not fill the card
// (pool_pass_rows), so that the small calls of stages 2-3 fill it.

template <int S, int CG>
struct FwdTile {
  static constexpr int kMaxRows = S == 1 ? 32 : 16;
  static constexpr int TW = 64 / CG;
  // the input columns that the tile's windows cover, with the halo; the
  // rows are (th - 1) * S + 3
  static constexpr int NC = (TW - 1) * S + 3;
  // at stride 2 a staged row holds its even columns, then its odd ones, so
  // that the three taps of a window row read three runs of consecutive
  // cells' vectors: no shared-memory bank conflicts
  static constexpr int NE = (NC + 1) / 2;

  // 16-byte vectors staged for a tile of th rows
  __host__ __device__ static constexpr int vecs(int th) { return ((th - 1) * S + 3) * NC * CG; }

  // the vector of staged (row, column) and channel group gi
  __device__ static __forceinline__ int at(int r, int c, int gi) {
    const int col = S == 1 ? c : (c & 1) * NE + (c >> 1);
    return (r * NC + col) * CG + gi;
  }
};

// a = bf16(LeakyReLU(y * sc + sh)) of two packed bf16 (low half first),
// packed; LeakyReLU(z) = max(z, 0.1 z), which equals the select on z >= 0
// for every z (0.1 z has z's sign, -0 included). Bits j and j + 1 of
// nonneg are set where z >= 0: the LeakyReLU slope, which a cannot give (z
// = -0 and a tiny z < 0 both activate to a = -0)
__device__ __forceinline__ unsigned activate2(unsigned y2, float s0, float o0, float s1, float o1,
                                              int j, unsigned& nonneg) {
  const float z0 = affine(__uint_as_float(y2 << 16), s0, o0);
  const float z1 = affine(__uint_as_float(y2 & 0xffff0000u), s1, o1);
  nonneg |= (z0 >= 0.f ? 1u << j : 0u) | (z1 >= 0.f ? 2u << j : 0u);
  const __nv_bfloat162 a = __floats2bfloat162_rn(fmaxf(z0, __fmul_rn(z0, 0.1f)),
                                                 fmaxf(z1, __fmul_rn(z1, 0.1f)));
  return *reinterpret_cast<const unsigned*>(&a);
}

__device__ __forceinline__ unsigned activate2(unsigned y2, float s0, float o0, float s1, float o1) {
  unsigned unused = 0;
  return activate2(y2, s0, o0, s1, o1, 0, unused);
}

// 0xffff in each half where the bf16 of a is greater than that of b: the
// float compare of the same values (so +0 and -0 are equal, a NaN never wins)
__device__ __forceinline__ unsigned gt_mask(unsigned a, unsigned b) {
  return __hgt2_mask(*reinterpret_cast<const __nv_bfloat162*>(&a),
                     *reinterpret_cast<const __nv_bfloat162*>(&b));
}

// The first max of a pooled cell's 9 taps (tap(k): the activated vector of
// tap k, row-major), by a strict > on bf16 pairs, into best; with kTaps its
// tap a channel into the 8 bytes of tap. The pair masks select the new
// maxima and, as byte masks, their taps. No max tree: max() of two equal
// values (+0, -0) may return the later one and move the tap.
template <bool kTaps, typename Tap>
__device__ __forceinline__ void scan9(Tap tap_of, uint4& best, uint2& tap) {
  best = make_uint4(0xff80ff80u, 0xff80ff80u, 0xff80ff80u, 0xff80ff80u);  // bf16 -inf
  tap = make_uint2(0u, 0u);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const uint4 a = tap_of(k);
    const unsigned m0 = gt_mask(a.x, best.x), m1 = gt_mask(a.y, best.y);
    const unsigned m2 = gt_mask(a.z, best.z), m3 = gt_mask(a.w, best.w);
    best = make_uint4((a.x & m0) | (best.x & ~m0), (a.y & m1) | (best.y & ~m1),
                      (a.z & m2) | (best.z & ~m2), (a.w & m3) | (best.w & ~m3));
    if constexpr (kTaps) {
      // byte j of the mask: channel j's half of m0..m3
      const unsigned b0 = __byte_perm(m0, m1, 0x6420), b1 = __byte_perm(m2, m3, 0x6420);
      const unsigned kk = 0x01010101u * k;
      tap = make_uint2((kk & b0) | (tap.x & ~b0), (kk & b1) | (tap.y & ~b1));
    }
  }
}

// kTaps: (c), which also writes the winning taps; else (e)
template <bool kTaps, int S, int CG>
__global__ void __launch_bounds__(kPoolThreads)
bn_pool_fwd_kernel(const __nv_bfloat16* __restrict__ y, const float* __restrict__ sc,
                   const float* __restrict__ sh, __nv_bfloat16* __restrict__ out,
                   uint8_t* __restrict__ taps, Shape s, int th, int tiles_x, int tiles_y) {
  using T = FwdTile<S, CG>;
  extern __shared__ uint4 a_s[];
  const PoolBlock blk(tiles_x, tiles_y, s.C / (8 * CG));
  const int b = blk.b, c8 = blk.chunk * CG;
  const int oh0 = blk.ty * th, ow0 = blk.tx * T::TW;
  const int h0 = oh0 * S - 1, w0 = ow0 * S - 1;
  const int nvec = T::vecs(th);
  const __nv_bfloat16* yb = y + static_cast<size_t>(b) * s.H * s.W * s.C + c8 * 8;

  // 1. the covering input pixels, one 16-byte cp.async a (pixel, group);
  //    a thread's vectors all have its channel group (kPoolThreads % CG == 0)
  for (int i = threadIdx.x; i < nvec; i += kPoolThreads) {
    const int gi = i % CG, p = i / CG;
    const int r = p / T::NC, c = p % T::NC;
    const int h = h0 + r, w = w0 + c;
    if (h >= 0 && h < s.H && w >= 0 && w < s.W)
      cp_async16(a_s + T::at(r, c, gi), yb + (static_cast<size_t>(h) * s.W + w) * s.C + gi * 8,
                 16);
  }
  cp_async_commit();
  const int gi = threadIdx.x % CG;
  float scv[8], shv[8];
  load_affine(sc, sh, (c8 + gi) * 8, scv, shv);
  cp_async_wait<0>();

  // 2. a once a staged pixel, in place: each thread its own copies, which
  //    the wait made visible to it. -inf off the image, as the plain
  //    version pads: a zero there would activate to bf16(LeakyReLU(sh)),
  //    which can win
  for (int i = threadIdx.x; i < nvec; i += kPoolThreads) {
    const int p = i / CG;
    const int r = p / T::NC, c = p % T::NC;
    const int h = h0 + r, w = w0 + c;
    uint4* v = a_s + T::at(r, c, gi);
    if (h >= 0 && h < s.H && w >= 0 && w < s.W) {
      const uint4 raw = *v;
      *v = make_uint4(activate2(raw.x, scv[0], shv[0], scv[1], shv[1]),
                      activate2(raw.y, scv[2], shv[2], scv[3], shv[3]),
                      activate2(raw.z, scv[4], shv[4], scv[5], shv[5]),
                      activate2(raw.w, scv[6], shv[6], scv[7], shv[7]));
    } else {
      *v = make_uint4(0xff80ff80u, 0xff80ff80u, 0xff80ff80u, 0xff80ff80u);  // bf16 -inf
    }
  }
  __syncthreads();

  // 3. each item (cell, group) scans its 9 taps (scan9): the first max, as
  //    the plain version. Neighbouring lanes take neighbouring groups and cells: 16-byte
  //    shared loads without conflicts, stores on neighbouring addresses.
#pragma unroll 2
  for (int u = 0; u < th / 4; ++u) {
    const int it = threadIdx.x + u * kPoolThreads;
    const int j = it / CG % T::TW, i = it / (CG * T::TW);
    const int oh = oh0 + i, ow = ow0 + j;
    if (oh >= s.Ho || ow >= s.Wo) continue;
    uint4 best;
    uint2 tap;
    scan9<kTaps>([&](int k) { return a_s[T::at(i * S + k / 3, j * S + k % 3, gi)]; }, best, tap);
    const size_t at = ((static_cast<size_t>(b) * s.Ho + oh) * s.Wo + ow) * s.C + (c8 + gi) * 8;
    *reinterpret_cast<uint4*>(out + at) = best;
    if constexpr (kTaps) *reinterpret_cast<uint2*>(taps + at) = tap;
  }
}

template <bool kTaps, int S, int CG>
cudaError_t launch_bn_pool_fwd(const void* y, const void* sc, const void* sh, void* out,
                               void* taps, const Shape& s, cudaStream_t stream) {
  using T = FwdTile<S, CG>;
  const int tiles_x = (s.Wo + T::TW - 1) / T::TW;
  const long long rows_of_tiles = static_cast<long long>(tiles_x) * s.B * (s.C / (8 * CG));
  const int th = pool_pass_rows(T::kMaxRows, 1, s.Ho, rows_of_tiles);
  const int tiles_y = (s.Ho + th - 1) / th;
  return launch_pool_tiles(bn_pool_fwd_kernel<kTaps, S, CG>, tiles_y * rows_of_tiles,
                           T::vecs(th) * 16, stream, static_cast<const __nv_bfloat16*>(y),
                           static_cast<const float*>(sc), static_cast<const float*>(sh),
                           static_cast<__nv_bfloat16*>(out), static_cast<uint8_t*>(taps), s, th,
                           tiles_x, tiles_y);
}

template <bool kTaps, int S>
cudaError_t launch_bn_pool_fwd_s(const void* y, const void* sc, const void* sh, void* out,
                                 void* taps, const Shape& s, cudaStream_t stream) {
  // CG: the most 8-channel groups, up to 8, that divide C / 8
  const int C8 = s.C / 8;
  if (C8 % 8 == 0) return launch_bn_pool_fwd<kTaps, S, 8>(y, sc, sh, out, taps, s, stream);
  if (C8 % 4 == 0) return launch_bn_pool_fwd<kTaps, S, 4>(y, sc, sh, out, taps, s, stream);
  if (C8 % 2 == 0) return launch_bn_pool_fwd<kTaps, S, 2>(y, sc, sh, out, taps, s, stream);
  return launch_bn_pool_fwd<kTaps, S, 1>(y, sc, sh, out, taps, s, stream);
}

// (d): one block per tile of input pixels of one batch row -- TH x TW, in
// S x S parity passes of kPassRows x kPassCols pixels (pool_tile.cuh) --
// and CG 8-channel groups. 1024 (pixel, group) items a pass, 4 a thread.
template <int S, int CG>
struct BwdTile : PoolTile<S, CG> {
  using P = PoolTile<S, CG>;
  static constexpr int kPassRows = 16;
  static constexpr int TH = S * kPassRows;
  static constexpr int kCells = P::cell_rows(kPassRows) * P::NC;
};

template <int S, int CG>
__global__ void __launch_bounds__(kPoolThreads)
bn_pool_bwd_kernel(const __nv_bfloat16* __restrict__ y, const float* __restrict__ sc,
                   const float* __restrict__ sh, const uint8_t* __restrict__ taps,
                   const __nv_bfloat16* __restrict__ g, float* __restrict__ dz, Shape s) {
  using T = BwdTile<S, CG>;
  __shared__ __align__(16) __nv_bfloat16 g_s[T::kCells * CG * 8];
  __shared__ __align__(16) uint8_t t_s[T::kCells * CG * 8];
  const int chunks = s.C / (8 * CG);
  const int b = blockIdx.z / chunks, c8 = blockIdx.z % chunks * CG;
  const int h0 = blockIdx.y * T::TH, w0 = blockIdx.x * T::TW;
  const int oh0 = T::first_cell(h0), ow0 = T::first_cell(w0);

  // the cells' cotangents (16 bytes a group) and taps (8), zeros outside
  // the pooled grid: a zero cotangent adds +0, which leaves every sum as it
  // is (a sum from +0 is never -0), so no lookup below tests the grid
  const __nv_bfloat16* gb = g + static_cast<size_t>(b) * s.Ho * s.Wo * s.C + c8 * 8;
  const uint8_t* tb = taps + static_cast<size_t>(b) * s.Ho * s.Wo * s.C + c8 * 8;
  for (int i = threadIdx.x; i < T::kCells * CG; i += kPoolThreads) {
    const int gi = i % CG, cell = i / CG;
    const int oh = oh0 + cell / T::NC, ow = ow0 + cell % T::NC;
    const bool ok = oh >= 0 && oh < s.Ho && ow >= 0 && ow < s.Wo;
    const long long at = ok ? (static_cast<long long>(oh) * s.Wo + ow) * s.C + gi * 8 : 0;
    cp_async16(g_s + i * 8, gb + at, ok ? 16 : 0);
    cp_async8(t_s + i * 8, tb + at, ok ? 8 : 0);
  }
  cp_async_commit();

  // every item of a thread has the same channel group (kPoolThreads % CG == 0)
  const int gi = threadIdx.x % CG, c = (c8 + gi) * 8;
  float scv[8], shv[8];
  load_affine(sc, sh, c, scv, shv);

  // pass (py, px) takes the pixels (h0 + S i + py, w0 + S j + px): at
  // stride 2 the taps whose cells can route to them are known here, 1, 2
  // or 4 of the 9, in ascending order. A pass's y vectors are loaded before
  // its cells are read (the first pass's while the cells land).
  constexpr int kItems = T::kPassRows * 64 / kPoolThreads;
  uint4 raw[kItems];
  auto load_y = [&](int py, int px) {
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int it = threadIdx.x + u * kPoolThreads;
      const int j = it / CG % T::kPassCols, i = it / (CG * T::kPassCols);
      const int h = h0 + S * i + py, w = w0 + S * j + px;
      if (h < s.H && w < s.W)
        raw[u] = *reinterpret_cast<const uint4*>(
            y + ((static_cast<size_t>(b) * s.H + h) * s.W + w) * s.C + c);
    }
  };
  load_y(0, 0);
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int py = 0; py < S; ++py)
#pragma unroll
    for (int px = 0; px < S; ++px) {
      if (py + px > 0) load_y(py, px);
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const int it = threadIdx.x + u * kPoolThreads;
        const int j = it / CG % T::kPassCols, i = it / (CG * T::kPassCols);
        const int h = h0 + S * i + py, w = w0 + S * j + px;
        if (h >= s.H || w >= s.W) continue;
        float acc[8] = {};
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          if ((py + 1 - kh) % S != 0) continue;
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            if ((px + 1 - kw) % S != 0) continue;
            const int cell = T::cell_of(i, py, kh) * T::NC + T::cell_of(j, px, kw);
            const int e = (cell * CG + gi) * 8;
            const uint2 tv = *reinterpret_cast<const uint2*>(t_s + e);
            const uint4 gv = *reinterpret_cast<const uint4*>(g_s + e);
            const uint8_t* tp = reinterpret_cast<const uint8_t*>(&tv);
            const __nv_bfloat16* gp = reinterpret_cast<const __nv_bfloat16*>(&gv);
#pragma unroll
            for (int q = 0; q < 8; ++q)
              if (tp[q] == kh * 3 + kw) acc[q] += __bfloat162float(gp[q]);
          }
        }
        const __nv_bfloat16* yv = reinterpret_cast<const __nv_bfloat16*>(&raw[u]);
        __align__(16) float o[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          o[q] = affine(__bfloat162float(yv[q]), scv[q], shv[q]) >= 0.f ? acc[q]
                                                                         : __fmul_rn(acc[q], 0.1f);
        float4* dst = reinterpret_cast<float4*>(
            dz + ((static_cast<size_t>(b) * s.H + h) * s.W + w) * s.C + c);
        dst[0] = *reinterpret_cast<const float4*>(o);
        dst[1] = *reinterpret_cast<const float4*>(o + 4);
      }
    }
}

template <int S, int CG>
cudaError_t launch_bn_pool_bwd(const void* y, const void* sc, const void* sh, const void* taps,
                               const void* g, void* dz, const Shape& s, cudaStream_t stream) {
  using T = BwdTile<S, CG>;
  const long long z = static_cast<long long>(s.B) * (s.C / (8 * CG));
  if (z > 65535) return cudaErrorInvalidValue;
  const dim3 grid((s.W + T::TW - 1) / T::TW, (s.H + T::TH - 1) / T::TH, static_cast<unsigned>(z));
  bn_pool_bwd_kernel<S, CG><<<grid, kPoolThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(sc),
      static_cast<const float*>(sh), static_cast<const uint8_t*>(taps),
      static_cast<const __nv_bfloat16*>(g), static_cast<float*>(dz), s);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_bn_pool_bwd_s(const void* y, const void* sc, const void* sh, const void* taps,
                                 const void* g, void* dz, const Shape& s, cudaStream_t stream) {
  // CG: the most 8-channel groups, up to 8, that divide C / 8
  const int C8 = s.C / 8;
  if (C8 % 8 == 0) return launch_bn_pool_bwd<S, 8>(y, sc, sh, taps, g, dz, s, stream);
  if (C8 % 4 == 0) return launch_bn_pool_bwd<S, 4>(y, sc, sh, taps, g, dz, s, stream);
  if (C8 % 2 == 0) return launch_bn_pool_bwd<S, 2>(y, sc, sh, taps, g, dz, s, stream);
  return launch_bn_pool_bwd<S, 1>(y, sc, sh, taps, g, dz, s, stream);
}

// (f): a block owns a tile of input pixels of one batch row and CG 8-channel
// groups (the most, up to 8, that divide C / 8), 256 threads, in the
// geometry of pool_tile.cuh: S x S parity passes of rows x 64 / CG pixels,
// rows 16 at stride 1 and 8 at stride 2, halved down to 4 while the grid
// has fewer than 1.5 blocks a SM at stride 1 (a larger tile pays its halo
// and its phases' latency once) and than the SMs hold at once at stride 2
// (the measured best of 1, 1.5, 2, 4 and 8 blocks a SM).
// - One commit group of 16-byte cp.async stages the raw y of every input
//   pixel that the covering cells' windows read (the tile with a 2-pixel
//   halo at stride 1; 1 before and 2 after at stride 2) and the covering
//   cells' g, zeros outside the pooled grid (as (d)).
// - Each staged pixel is activated once, in place, to bf16 (-inf off the
//   image), as (c) does; its LeakyReLU slope is kept beside it as a bit a
//   channel, from z >= 0 in f32. Not from a: at z = -0 the slope is 1 and
//   a = -0, and a tiny z < 0 (a subnormal) also activates to a = -0, with
//   slope 0.1.
// - Each covering (cell, group) scans its 9 taps with (c)'s scan9 into an
//   8-byte tap vector in shared memory; then each pixel gathers its cells
//   as (d) does (tap order, parity passes at stride 2), but with masks:
//   per tap, the bytes of the tap vector that differ from it (a xor and
//   an add) become 16-bit lane masks (prmt's sign mode) that zero those
//   channels' cotangents, and all 8 are added (+0 leaves a sum as it is),
//   about 30 instructions a tap where a compare a channel took ~40. Then
//   the slope, and 8 f32 written as two float4. y is read once from
//   device memory (the halo from L2), g once, dz written once.
// - Stride and CG are template parameters, indices 32-bit from blockIdx and
//   threadIdx, with a size_t base per batch row; the grid is one dimension,
//   so any B x chunks launches.
// What bounds it, as measured (NVIDIA H100 80GB HBM3, 700.00 W,
// tools/torch_kernel_times.py): the first free-step call (stride 2,
// 384x1280, 16 channels, 409 MB) moves ~2.2 TB/s; the proj step's 15
// calls take 0.170-0.175 ms (bound 0.058), 10 of them small calls at a
// launch and a block's chain of phases (4.6-9 us each). Copies of the
// kernel without the scan, the activation or the 9-tap gather were 9%, 7%
// and 5% faster a free step: no phase dominates; the stage-then-store
// pattern does, as in (c). Slower: the gather with a compare a channel
// (0.654-0.664 ms a free step against 0.598-0.603), channel groups capped
// at 2 (0.645 against 0.602-0.607), one commit group for y and g (0.673-
// 0.684 against 0.661).
template <int S, int CG>
struct RecTile : PoolTile<S, CG> {
  using P = PoolTile<S, CG>;
  static constexpr int kMaxRows = S == 1 ? 16 : 8;
  // the staged input columns: the cells' windows
  static constexpr int YC = (P::NC - 1) * S + 3;
  // at stride 2 a staged row holds its even columns, then its odd ones, so
  // that neighbouring cells' taps read consecutive vectors (as (c)'s)
  static constexpr int NE = (YC + 1) / 2;

  __host__ __device__ static constexpr int staged_rows(int rows) {
    return (P::cell_rows(rows) - 1) * S + 3;
  }
  __host__ __device__ static constexpr int smem(int rows) {
    return staged_rows(rows) * YC * CG * 17 + P::cell_rows(rows) * P::NC * CG * 24;
  }
  // the staged vector of (row, column) and channel group gi
  __device__ static __forceinline__ int at(int r, int c, int gi) {
    const int col = S == 1 ? c : (c & 1) * NE + (c >> 1);
    return (r * YC + col) * CG + gi;
  }
};

// a0, a1 += the two bf16 of w (low half first), as f32
__device__ __forceinline__ void add_pair(float& a0, float& a1, unsigned w) {
  a0 += __uint_as_float(w << 16);
  a1 += __uint_as_float(w & 0xffff0000u);
}

template <int S, int CG>
__global__ void __launch_bounds__(kPoolThreads)
bn_pool_bwd_recompute_kernel(const __nv_bfloat16* __restrict__ y, const float* __restrict__ sc,
                             const float* __restrict__ sh, const __nv_bfloat16* __restrict__ g,
                             float* __restrict__ dz, Shape s, int rows, int tiles_x, int tiles_y) {
  using T = RecTile<S, CG>;
  extern __shared__ uint4 shared[];
  const int nvec = T::staged_rows(rows) * T::YC * CG;
  const int ncell = T::cell_rows(rows) * T::NC * CG;
  uint4* a_s = shared;
  uint4* g_s = a_s + nvec;
  uint2* t_s = reinterpret_cast<uint2*>(g_s + ncell);
  uint8_t* pos_s = reinterpret_cast<uint8_t*>(t_s + ncell);

  const PoolBlock blk(tiles_x, tiles_y, s.C / (8 * CG));
  const int c8 = blk.chunk * CG;
  const int h0 = blk.ty * rows * S, w0 = blk.tx * T::TW;
  const int oh0 = T::first_cell(h0), ow0 = T::first_cell(w0);
  const int yh0 = oh0 * S - 1, yw0 = ow0 * S - 1;  // the first staged pixel

  // 1. two commit groups, 16 bytes a (pixel or cell, group): the raw y of
  //    the cells' windows, then the cells' g, which lands during steps 2-3;
  //    g zero outside the pooled grid: a zero cotangent adds +0, which
  //    leaves every sum as it is (a sum from +0 is never -0), so no lookup
  //    below tests the grid
  const __nv_bfloat16* yb = y + static_cast<size_t>(blk.b) * s.H * s.W * s.C + c8 * 8;
  for (int i = threadIdx.x; i < nvec; i += kPoolThreads) {
    const int gi = i % CG, p = i / CG;
    const int r = p / T::YC, c = p % T::YC;
    const int h = yh0 + r, w = yw0 + c;
    if (h >= 0 && h < s.H && w >= 0 && w < s.W)
      cp_async16(a_s + T::at(r, c, gi), yb + static_cast<size_t>(h * s.W + w) * s.C + gi * 8, 16);
  }
  cp_async_commit();
  const __nv_bfloat16* gb = g + static_cast<size_t>(blk.b) * s.Ho * s.Wo * s.C + c8 * 8;
  for (int i = threadIdx.x; i < ncell; i += kPoolThreads) {
    const int gi = i % CG, cell = i / CG;
    const int oh = oh0 + cell / T::NC, ow = ow0 + cell % T::NC;
    const bool ok = oh >= 0 && oh < s.Ho && ow >= 0 && ow < s.Wo;
    cp_async16(g_s + i, gb + (ok ? static_cast<size_t>(oh * s.Wo + ow) * s.C + gi * 8 : 0),
               ok ? 16 : 0);
  }
  cp_async_commit();
  // every item of a thread has the same channel group (kPoolThreads % CG == 0)
  const int gi = threadIdx.x % CG;
  float scv[8], shv[8];
  load_affine(sc, sh, (c8 + gi) * 8, scv, shv);
  cp_async_wait<1>();

  // 2. a once a staged pixel, in place, and its slope bits (z >= 0, from
  //    z itself); -inf off the image, as the plain version pads
  for (int i = threadIdx.x; i < nvec; i += kPoolThreads) {
    const int p = i / CG;
    const int r = p / T::YC, c = p % T::YC;
    const int h = yh0 + r, w = yw0 + c;
    const int e = T::at(r, c, gi);
    if (h >= 0 && h < s.H && w >= 0 && w < s.W) {
      const uint4 raw = a_s[e];
      unsigned nonneg = 0;
      a_s[e] = make_uint4(activate2(raw.x, scv[0], shv[0], scv[1], shv[1], 0, nonneg),
                          activate2(raw.y, scv[2], shv[2], scv[3], shv[3], 2, nonneg),
                          activate2(raw.z, scv[4], shv[4], scv[5], shv[5], 4, nonneg),
                          activate2(raw.w, scv[6], shv[6], scv[7], shv[7], 6, nonneg));
      pos_s[e] = static_cast<uint8_t>(nonneg);
    } else {
      a_s[e] = make_uint4(0xff80ff80u, 0xff80ff80u, 0xff80ff80u, 0xff80ff80u);  // bf16 -inf
    }
  }
  __syncthreads();

  // 3. each covering (cell, group) scans its 9 taps as (c) does: the taps
  //    (c) would save. Cells outside the grid are scanned too (their windows
  //    lie in the staged rows); their zero g makes their taps harmless
  for (int i = threadIdx.x; i < ncell; i += kPoolThreads) {
    const int cell = i / CG;
    const int r = cell / T::NC * S, c = cell % T::NC * S;
    uint4 best;
    uint2 tap;
    scan9<true>([&](int k) { return a_s[T::at(r + k / 3, c + k % 3, gi)]; }, best, tap);
    t_s[i] = tap;
  }
  cp_async_wait<0>();
  __syncthreads();

  // 4. (d)'s gather: pass (py, px) takes the pixels (h0 + S i + py, w0 + S j
  //    + px), each the cells whose tap it is, in tap order k = 0..8, times
  //    the slope; 8 f32 as two float4
  float* dzb = dz + static_cast<size_t>(blk.b) * s.H * s.W * s.C + (c8 + gi) * 8;
  const int items = rows * 64 / kPoolThreads;
#pragma unroll
  for (int py = 0; py < S; ++py)
#pragma unroll
    for (int px = 0; px < S; ++px)
#pragma unroll 2
      for (int u = 0; u < items; ++u) {
        const int it = threadIdx.x + u * kPoolThreads;
        const int j = it / CG % T::kPassCols, i = it / (CG * T::kPassCols);
        const int h = h0 + S * i + py, w = w0 + S * j + px;
        if (h >= s.H || w >= s.W) continue;
        float acc[8] = {};
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          if ((py + 1 - kh) % S != 0) continue;
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            if ((px + 1 - kw) % S != 0) continue;
            const int e = (T::cell_of(i, py, kh) * T::NC + T::cell_of(j, px, kw)) * CG + gi;
            // the cotangents of the channels whose tap is this pixel's, the
            // others masked to +0 (bit 7 of a byte of n: that channel's tap
            // is not this one; taps and k are below 16, so no carry)
            const uint2 tv = t_s[e];
            const uint4 gv = g_s[e];
            const unsigned k4 = 0x01010101u * (kh * 3 + kw);
            const unsigned n0 = (tv.x ^ k4) + 0x7f7f7f7fu, n1 = (tv.y ^ k4) + 0x7f7f7f7fu;
            add_pair(acc[0], acc[1], gv.x & ~sign_lanes(n0, 0x9988));
            add_pair(acc[2], acc[3], gv.y & ~sign_lanes(n0, 0xbbaa));
            add_pair(acc[4], acc[5], gv.z & ~sign_lanes(n1, 0x9988));
            add_pair(acc[6], acc[7], gv.w & ~sign_lanes(n1, 0xbbaa));
          }
        }
        const unsigned nonneg = pos_s[T::at(h - yh0, w - yw0, gi)];
        __align__(16) float o[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) o[q] = nonneg >> q & 1u ? acc[q] : __fmul_rn(acc[q], 0.1f);
        float4* dst = reinterpret_cast<float4*>(dzb + static_cast<size_t>(h * s.W + w) * s.C);
        dst[0] = *reinterpret_cast<const float4*>(o);
        dst[1] = *reinterpret_cast<const float4*>(o + 4);
      }
}

template <int S, int CG>
cudaError_t launch_bn_pool_bwd_recompute(const void* y, const void* sc, const void* sh,
                                         const void* g, void* dz, const Shape& s,
                                         cudaStream_t stream) {
  using T = RecTile<S, CG>;
  const int tiles_x = (s.W + T::TW - 1) / T::TW;
  const long long rows_of_tiles = static_cast<long long>(tiles_x) * s.B * (s.C / (8 * CG));
  const int rows = pool_pass_rows(T::kMaxRows, S, s.H, rows_of_tiles, S == 1 ? 3 : 16);
  const int tiles_y = (s.H + S * rows - 1) / (S * rows);
  return launch_pool_tiles(bn_pool_bwd_recompute_kernel<S, CG>, tiles_y * rows_of_tiles,
                           T::smem(rows), stream, static_cast<const __nv_bfloat16*>(y),
                           static_cast<const float*>(sc), static_cast<const float*>(sh),
                           static_cast<const __nv_bfloat16*>(g), static_cast<float*>(dz), s,
                           rows, tiles_x, tiles_y);
}

template <int S>
cudaError_t launch_bn_pool_bwd_recompute_s(const void* y, const void* sc, const void* sh,
                                           const void* g, void* dz, const Shape& s,
                                           cudaStream_t stream) {
  // CG: the most 8-channel groups, up to 8, that divide C / 8
  const int C8 = s.C / 8;
  if (C8 % 8 == 0) return launch_bn_pool_bwd_recompute<S, 8>(y, sc, sh, g, dz, s, stream);
  if (C8 % 4 == 0) return launch_bn_pool_bwd_recompute<S, 4>(y, sc, sh, g, dz, s, stream);
  if (C8 % 2 == 0) return launch_bn_pool_bwd_recompute<S, 2>(y, sc, sh, g, dz, s, stream);
  return launch_bn_pool_bwd_recompute<S, 1>(y, sc, sh, g, dz, s, stream);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return stride == 1 ? launch_bn_pool_fwd_s<true, 1>(y, sc, sh, out, taps, s, st)
                     : launch_bn_pool_fwd_s<true, 2>(y, sc, sh, out, taps, s, st);
}

// (e): out alone, as bn_pool_fwd_launch's out.
extern "C" int bn_pool_fwd_notap_launch(const void* y, const void* sc, const void* sh, void* out,
                                        int B, int H, int W, int C, int stride, void* stream) {
  const Shape s{B, H, W, C, stride, (H - 1) / stride + 1, (W - 1) / stride + 1};
  if (!valid(s)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return stride == 1 ? launch_bn_pool_fwd_s<false, 1>(y, sc, sh, out, nullptr, s, st)
                     : launch_bn_pool_fwd_s<false, 2>(y, sc, sh, out, nullptr, s, st);
}

// dz (B,H,W,C) f32 from y, sc, sh, the saved taps and g (B,Ho,Wo,C) bf16.
extern "C" int bn_pool_bwd_launch(const void* y, const void* sc, const void* sh,
                                  const void* taps, const void* g, void* dz, int B, int H, int W,
                                  int C, int stride, void* stream) {
  const Shape s{B, H, W, C, stride, (H - 1) / stride + 1, (W - 1) / stride + 1};
  if (!valid(s)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return stride == 1 ? launch_bn_pool_bwd_s<1>(y, sc, sh, taps, g, dz, s, st)
                     : launch_bn_pool_bwd_s<2>(y, sc, sh, taps, g, dz, s, st);
}

// (f): dz (B,H,W,C) f32 from y, sc, sh and g (B,Ho,Wo,C) bf16, as
// bn_pool_bwd_launch with the taps (c) would save.
extern "C" int bn_pool_bwd_recompute_launch(const void* y, const void* sc, const void* sh,
                                            const void* g, void* dz, int B, int H, int W, int C,
                                            int stride, void* stream) {
  const Shape s{B, H, W, C, stride, (H - 1) / stride + 1, (W - 1) / stride + 1};
  if (!valid(s)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return stride == 1 ? launch_bn_pool_bwd_recompute_s<1>(y, sc, sh, g, dz, s, st)
                     : launch_bn_pool_bwd_recompute_s<2>(y, sc, sh, g, dz, s, st);
}
