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
//       from y, sc, sh and g alone. A block stages a = bf16(LeakyReLU(y * sc
//       + sh)) for an 8x8 tile of input pixels with a 2-pixel halo in shared
//       memory, finds the first-max tap of every pooled cell that covers the
//       tile (the same strict-> scan as (c)), then each pixel gathers its
//       <= 9 cells as (d) does. dz equals (d)'s bit for bit.
// The TPU's lane rolls, row pairing and even-w selection matmuls are not
// carried over.
//
// What bounds them on the H100: bytes (a few operations per element). Every
// global access is a 16-byte vector (8 bf16, 8 taps as 8 bytes, 8 f32 as
// two); neighbouring threads take neighbouring channel groups and pixels.
// (f) reads y once per tile with its halo (12x12 staged for 8x8 pixels)
// and recomputes each cell's 9-tap scan from shared memory: about 9
// compares per pooled cell and channel, still below the bytes.
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

// (c) and (e): one block per tile of pooled cells of one batch row -- th x
// TW, TW = 64 / CG -- and CG 8-channel groups, 256 threads; kFwdRow
// (cell, group) items a tile row, th / 4 items a thread. th, the tile's
// rows, is halved from kMaxRows (at least to kFwdMinRows) while the grid
// has fewer blocks than the SMs hold at once, so that the small calls of
// stages 2-3 fill the card.
constexpr int kFwdThreads = 256;
constexpr int kFwdRow = 64;
constexpr int kFwdMinRows = 4;
constexpr int kFwdBlocksPerSm = 2048 / kFwdThreads;

template <int S, int CG>
struct FwdTile {
  static constexpr int kMaxRows = S == 1 ? 32 : 16;
  static constexpr int TW = kFwdRow / CG;
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
// for every z (0.1 z has z's sign, -0 included)
__device__ __forceinline__ unsigned activate2(unsigned y2, float s0, float o0, float s1, float o1) {
  const float z0 = affine(__uint_as_float(y2 << 16), s0, o0);
  const float z1 = affine(__uint_as_float(y2 & 0xffff0000u), s1, o1);
  const __nv_bfloat162 a = __floats2bfloat162_rn(fmaxf(z0, __fmul_rn(z0, 0.1f)),
                                                 fmaxf(z1, __fmul_rn(z1, 0.1f)));
  return *reinterpret_cast<const unsigned*>(&a);
}

// 0xffff in each half where the bf16 of a is greater than that of b: the
// float compare of the same values (so +0 and -0 are equal, a NaN never wins)
__device__ __forceinline__ unsigned gt_mask(unsigned a, unsigned b) {
  return __hgt2_mask(*reinterpret_cast<const __nv_bfloat162*>(&a),
                     *reinterpret_cast<const __nv_bfloat162*>(&b));
}

// kTaps: (c), which also writes the winning taps; else (e)
template <bool kTaps, int S, int CG>
__global__ void __launch_bounds__(kFwdThreads)
bn_pool_fwd_kernel(const __nv_bfloat16* __restrict__ y, const float* __restrict__ sc,
                   const float* __restrict__ sh, __nv_bfloat16* __restrict__ out,
                   uint8_t* __restrict__ taps, Shape s, int th, int tiles_x, int tiles_y) {
  using T = FwdTile<S, CG>;
  extern __shared__ uint4 a_s[];
  // the block: column tile fastest, so that neighbouring blocks share
  // their halo rows in L2; then row tile, channel chunk, batch row
  const int chunks = s.C / (8 * CG);
  int blk = blockIdx.x;
  const int tx = blk % tiles_x;
  blk /= tiles_x;
  const int ty = blk % tiles_y;
  blk /= tiles_y;
  const int b = blk / chunks, c8 = blk % chunks * CG;
  const int oh0 = ty * th, ow0 = tx * T::TW;
  const int h0 = oh0 * S - 1, w0 = ow0 * S - 1;
  const int nvec = T::vecs(th);
  const __nv_bfloat16* yb = y + static_cast<size_t>(b) * s.H * s.W * s.C + c8 * 8;

  // 1. the covering input pixels, one 16-byte cp.async a (pixel, group);
  //    a thread's vectors all have its channel group (kFwdThreads % CG == 0)
  for (int i = threadIdx.x; i < nvec; i += kFwdThreads) {
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
  for (int i = threadIdx.x; i < nvec; i += kFwdThreads) {
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

  // 3. each item (cell, group) scans its 9 taps in row-major order by a
  //    strict >, on bf16 pairs: the first max, as the plain version. The
  //    pair masks select the new maxima and, as byte masks, their taps.
  //    Neighbouring lanes take neighbouring groups and cells: 16-byte
  //    shared loads without conflicts, stores on neighbouring addresses.
#pragma unroll 2
  for (int u = 0; u < th / 4; ++u) {
    const int it = threadIdx.x + u * kFwdThreads;
    const int j = it / CG % T::TW, i = it / (CG * T::TW);
    const int oh = oh0 + i, ow = ow0 + j;
    if (oh >= s.Ho || ow >= s.Wo) continue;
    uint4 best = make_uint4(0xff80ff80u, 0xff80ff80u, 0xff80ff80u, 0xff80ff80u);
    uint2 tap = make_uint2(0u, 0u);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const uint4 a = a_s[T::at(i * S + k / 3, j * S + k % 3, gi)];
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
  const long long resident = static_cast<long long>(kFwdBlocksPerSm) * sm_count();
  int th = T::kMaxRows;
  while (th > kFwdMinRows && (s.Ho + th - 1) / th * rows_of_tiles < resident) th /= 2;
  const int tiles_y = (s.Ho + th - 1) / th;
  const long long blocks = tiles_y * rows_of_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = T::vecs(th) * 16;
  auto kern = bn_pool_fwd_kernel<kTaps, S, CG>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(blocks), kFwdThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(sc),
      static_cast<const float*>(sh), static_cast<__nv_bfloat16*>(out),
      static_cast<uint8_t*>(taps), s, th, tiles_x, tiles_y);
  return cudaGetLastError();
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
// S x S parity passes of kPassRows x kPassCols pixels -- and CG 8-channel
// groups. kPass (pixel, group) items a pass, 4 a thread.
constexpr int kBwdThreads = 256;
constexpr int kPass = 1024;
constexpr int kPassRows = 16;

template <int S, int CG>
struct BwdTile {
  static constexpr int kPassCols = kPass / (kPassRows * CG);  // 64 / CG
  static constexpr int TH = S * kPassRows, TW = S * kPassCols;
  // the pooled cells that cover the tile: with a 1-cell halo on each side
  // at stride 1; at stride 2 (TH, TW even) one more row and column
  static constexpr int NR = S == 1 ? TH + 2 : kPassRows + 1;
  static constexpr int NC = S == 1 ? TW + 2 : kPassCols + 1;
  static constexpr int kCells = NR * NC;
};

template <int S, int CG>
__global__ void __launch_bounds__(kBwdThreads)
bn_pool_bwd_kernel(const __nv_bfloat16* __restrict__ y, const float* __restrict__ sc,
                   const float* __restrict__ sh, const uint8_t* __restrict__ taps,
                   const __nv_bfloat16* __restrict__ g, float* __restrict__ dz, Shape s) {
  using T = BwdTile<S, CG>;
  __shared__ __align__(16) __nv_bfloat16 g_s[T::kCells * CG * 8];
  __shared__ __align__(16) uint8_t t_s[T::kCells * CG * 8];
  const int chunks = s.C / (8 * CG);
  const int b = blockIdx.z / chunks, c8 = blockIdx.z % chunks * CG;
  const int h0 = blockIdx.y * T::TH, w0 = blockIdx.x * T::TW;
  const int oh0 = S == 1 ? h0 - 1 : h0 / 2, ow0 = S == 1 ? w0 - 1 : w0 / 2;

  // the cells' cotangents (16 bytes a group) and taps (8), zeros outside
  // the pooled grid: a zero cotangent adds +0, which leaves every sum as it
  // is (a sum from +0 is never -0), so no lookup below tests the grid
  const __nv_bfloat16* gb = g + static_cast<size_t>(b) * s.Ho * s.Wo * s.C + c8 * 8;
  const uint8_t* tb = taps + static_cast<size_t>(b) * s.Ho * s.Wo * s.C + c8 * 8;
  for (int i = threadIdx.x; i < T::kCells * CG; i += kBwdThreads) {
    const int gi = i % CG, cell = i / CG;
    const int oh = oh0 + cell / T::NC, ow = ow0 + cell % T::NC;
    const bool ok = oh >= 0 && oh < s.Ho && ow >= 0 && ow < s.Wo;
    const long long at = ok ? (static_cast<long long>(oh) * s.Wo + ow) * s.C + gi * 8 : 0;
    cp_async16(g_s + i * 8, gb + at, ok ? 16 : 0);
    cp_async8(t_s + i * 8, tb + at, ok ? 8 : 0);
  }
  cp_async_commit();

  // every item of a thread has the same channel group (kBwdThreads % CG == 0)
  const int gi = threadIdx.x % CG, c = (c8 + gi) * 8;
  float scv[8], shv[8];
  load_affine(sc, sh, c, scv, shv);

  // pass (py, px) takes the pixels (h0 + S i + py, w0 + S j + px): at
  // stride 2 the taps whose cells can route to them are known here, 1, 2
  // or 4 of the 9, in ascending order. A pass's y vectors are loaded before
  // its cells are read (the first pass's while the cells land).
  constexpr int kItems = kPass / kBwdThreads;
  uint4 raw[kItems];
  auto load_y = [&](int py, int px) {
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int it = threadIdx.x + u * kBwdThreads;
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
        const int it = threadIdx.x + u * kBwdThreads;
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
            // the cell (oh, ow) with oh * S + kh - 1 == h, in staged coordinates
            const int cr = S == 1 ? i + 2 - kh : i + (py + 1 - kh) / 2;
            const int cc = S == 1 ? j + 2 - kw : j + (px + 1 - kw) / 2;
            const int e = ((cr * T::NC + cc) * CG + gi) * 8;
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
  bn_pool_bwd_kernel<S, CG><<<grid, kBwdThreads, 0, stream>>>(
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

// (f): one block per 8x8 tile of input pixels, one batch row and up to
// kGroups 8-channel groups; a thread per (pixel, group).
constexpr int kTile = 8;
constexpr int kHalo = kTile + 4;   // rows (and columns) of staged a
constexpr int kCells = kTile + 2;  // pooled cells a side that cover a tile
constexpr int kGroups = 4;

__global__ void bn_pool_bwd_recompute_kernel(const __nv_bfloat16* __restrict__ y,
                                             const float* __restrict__ sc,
                                             const float* __restrict__ sh,
                                             const __nv_bfloat16* __restrict__ g,
                                             float* __restrict__ dz, Shape s, int groups) {
  __shared__ float sa[kHalo * kHalo * kGroups * 8];                // 18,432 bytes
  __shared__ __align__(8) uint8_t st[kCells * kCells * kGroups * 8];  // 3,200 bytes
  const int C8 = s.C / 8;
  const int w0 = blockIdx.x * kTile, h0 = blockIdx.y * kTile;
  const int chunks = (C8 + groups - 1) / groups;
  const int b = blockIdx.z / chunks, g0 = (blockIdx.z % chunks) * groups;

  // 1. a on rows [h0-2, h0+kTile+2) x columns [w0-2, w0+kTile+2); -inf off
  //    the image, so the pad never wins
  for (int i = threadIdx.x; i < kHalo * kHalo * groups; i += blockDim.x) {
    const int gi = i % groups, p = i / groups;
    const int h = h0 - 2 + p / kHalo, w = w0 - 2 + p % kHalo;
    float* dst = sa + i * 8;
    if (g0 + gi < C8 && h >= 0 && h < s.H && w >= 0 && w < s.W) {
      const int c = (g0 + gi) * 8;
      float scv[8], shv[8];
      load_affine(sc, sh, c, scv, shv);
      const uint4 raw =
          *reinterpret_cast<const uint4*>(y + ((static_cast<size_t>(b) * s.H + h) * s.W + w) * s.C + c);
      const __nv_bfloat16* yv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float z = affine(__bfloat162float(yv[j]), scv[j], shv[j]);
        dst[j] = bf16_round(z >= 0.f ? z : __fmul_rn(z, 0.1f));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = -INFINITY;
    }
  }
  __syncthreads();

  // 2. the first-max tap of every pooled cell (oh, ow) with oh*s in
  //    [h0-1, h0+kTile] and ow*s in [w0-1, w0+kTile]: the cells that cover a
  //    pixel of the tile; their windows lie inside the staged rows
  const int oh_lo = max(0, (h0 - 1 + s.stride - 1) / s.stride);
  const int ow_lo = max(0, (w0 - 1 + s.stride - 1) / s.stride);
  const int nch = min(s.Ho - 1, (h0 + kTile) / s.stride) - oh_lo + 1;
  const int ncw = min(s.Wo - 1, (w0 + kTile) / s.stride) - ow_lo + 1;
  for (int i = threadIdx.x; i < nch * ncw * groups; i += blockDim.x) {
    const int gi = i % groups, cell = i / groups;
    const int r0 = (oh_lo + cell / ncw) * s.stride - h0 + 1;  // the window's first staged row
    const int c0 = (ow_lo + cell % ncw) * s.stride - w0 + 1;
    float best[8];
    __align__(8) uint8_t tap[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      best[j] = -INFINITY;
      tap[j] = 0;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float* src = sa + (((r0 + k / 3) * kHalo + c0 + k % 3) * groups + gi) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (src[j] > best[j]) {
          best[j] = src[j];
          tap[j] = static_cast<uint8_t>(k);
        }
      }
    }
    *reinterpret_cast<uint2*>(st + i * 8) = *reinterpret_cast<const uint2*>(tap);
  }
  __syncthreads();

  // 3. each pixel sums the cotangents of the cells whose tap it is, in tap
  //    order, times the LeakyReLU slope: (d) with the recomputed taps
  const int gi = threadIdx.x % groups, p = threadIdx.x / groups;
  const int h = h0 + p / kTile, w = w0 + p % kTile;
  if (g0 + gi >= C8 || h >= s.H || w >= s.W) return;
  const int c = (g0 + gi) * 8;
  float acc[8] = {};
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int hn = h + 1 - k / 3, wn = w + 1 - k % 3;
    if (hn < 0 || wn < 0 || hn % s.stride || wn % s.stride) continue;
    const int oh = hn / s.stride, ow = wn / s.stride;
    if (oh >= s.Ho || ow >= s.Wo) continue;
    const uint2 tv = *reinterpret_cast<const uint2*>(
        st + (((oh - oh_lo) * ncw + ow - ow_lo) * groups + gi) * 8);
    const uint4 gv =
        *reinterpret_cast<const uint4*>(g + ((static_cast<size_t>(b) * s.Ho + oh) * s.Wo + ow) * s.C + c);
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
  const int C8 = C / 8, groups = C8 < kGroups ? C8 : kGroups;
  const long long z = static_cast<long long>(B) * ((C8 + groups - 1) / groups);
  if (z > 65535) return cudaErrorInvalidValue;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, static_cast<unsigned>(z));
  bn_pool_bwd_recompute_kernel<<<grid, kTile * kTile * groups, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(sc),
      static_cast<const float*>(sh), static_cast<const __nv_bfloat16*>(g),
      static_cast<float*>(dz), s, groups);
  return static_cast<int>(cudaGetLastError());
}
