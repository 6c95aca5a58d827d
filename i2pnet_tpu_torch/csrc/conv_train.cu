// The train-mode RGB-encoder conv: kernel (a), the 3x3 conv + bias used for
// the forward and for the input gradient, and kernel (b), the weight
// gradient, with its fixed-order sum over tiles.
//
// Replaces the TPU kernels of i2pnet_tpu/ops/conv_pallas_train.py:
//   (a) _conv_kernel (:103, launched by conv_phase :184). The forward is
//       conv + bias; dL/dx is the same conv of the bf16 cotangent with the
//       flipped-transposed weights (flip_transpose_kernel :203) and no bias.
//   (b) _dw_kernel (:212, launched by conv_phase_dw :285, unpacked by
//       unpack_dw :1277): dW[kh,kw,ci,co] = sum over b,h,w of
//       x[b, h+kh-1, w+kw-1, ci] * g[b, h, w, co].
// The TPU's phase packing, lane rolls and merged (B, H, W*C) rows are not
// carried over: NHWC here has the merged layout's memory.
//
// What bounds them on the H100: bytes. At the main path's shapes (B = 8,
// 384x1280 down to 24x80, 3..128 channels) a forward moves ~0.5 GB for
// ~43 GFLOP, about 90 FLOP a byte, under the card's ~295. The design
// therefore reads each input tile once per block and writes each output
// once, and keeps the arithmetic on bf16 tensor cores (mma.sync.m16n8k16,
// f32 accumulate) so that it stays off the critical path.
//
// (a): one block per (batch row, 16x16 output tile, co_t output channels).
// The block stages the 18x18 input tile (zero outside the image, channels
// zero-padded to a multiple of 16, so cin = 3 takes the same path) and the
// co_t weight rows in shared memory, as conv_block.cu does; it is that
// kernel's implicit GEMM without the pool. Each warp owns two output rows
// of 16 pixels (m16 tiles); the epilogue adds the bias in f32 and rounds to
// bf16, as the TPU kernel rounds its output.
//
// (b): dW = sum over pixels of X_window^T . dY, an implicit GEMM with M =
// (tap, input channel), N = output channels, K = pixels. It moves ~522 MB
// for ~43 GFLOP per free train step (~82 FLOP a byte): bytes bound it, so
// the design streams each operand once at the rate of HBM, and mma.sync
// (bf16, f32 sums) is not what limits it -- wgmma would not move it.
// - A block owns all 9 taps x a tile of input channels (all of cin up to
//   64) x a tile of 16 or 32 output channels (all of cout up to 32), so at
//   the heavy stage-1 calls x and g are read once, not once per channel
//   tile. It walks a chunk: a run of image rows of one batch row, in a
//   column slab of at most 128 pixels (plus a 1-pixel halo), top to bottom.
// - The rows go through a ring of 6 shared-memory slots filled by cp.async
//   (16-byte, zero-filled outside the image): x row r + 1 and g row r land
//   while the tensor cores work on row r - 1, one barrier per row.
// - The operands stay NHWC in shared memory (a pitch of 8 extra channels
//   keeps ldmatrix free of bank conflicts); ldmatrix.trans forms both
//   fragments, so a tap's column shift is a row address per lane and odd
//   shifts cost nothing.
// - cin <= 5 (the image's 3 channels): the x row is copied raw, as one run
//   of 16-byte words; for each kh, A[m = kw * cin + ci][k = pixel] is then
//   a strided view of it (element pixel * cin + m - cin), so each lane loads
//   its fragment's 16-bit elements directly: M = 3 x 16 rows, 27 used, and
//   no im2col pass (a first version built one and was instruction-bound).
// - The staging and fragment addresses use compile-time channel pitches,
//   and per-lane constants are set once, outside the row loop: per-row
//   index arithmetic would otherwise cost more than the row's copies.
// - One launch: blocks of 8 consecutive chunks form a thread-block
//   cluster; each block of it adds one eighth of the tile over the 8
//   blocks' sums through distributed shared memory, so a cluster writes one
//   partial, not 8. The last cluster of a tile to finish (found with a
//   counter after __threadfence) adds the partials in cluster order into
//   dw, each of its blocks one eighth, and leaves the counter zero.
//   The orders are fixed by the shape: a repeated call is bit-identical.
// Measured on the H100 (chip_smoke.py, the 15 calls of a free train step):
// 0.558 ms against conv2d_weight's 1.241 and a byte bound of 0.156. The
// earlier design -- a block per 16 input x 8-16 output channels, 8x16-pixel
// tiles staged by transposing 16-bit stores, load then compute, a second
// launch for the sum -- read x once per output-channel tile and took 1.33
// ms. Also slower: an im2col pass for cin = 3 (0.41 ms for that call alone,
// now 0.125) and a serial last-block sum of every chunk partial (0.14 ms a
// call at 24x80). The 24x80 and 48x160 calls stay at 0.024-0.031 ms,
// about the library's time: a block's fixed cost (first loads, sums) and
// the 64-channel tiles' mma.sync issue bound them, not bytes.

#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;

// ---- (a) the 3x3 conv ----------------------------------------------------

constexpr int kTile = 16;          // output tile: kTile x kTile pixels
constexpr int kHalo = kTile + 2;   // input tile with the conv's halo

struct ConvSmem {  // byte offsets; cinp = cin rounded up to 16
  size_t w, in, total;
  int cinp, ps, ws;  // padded channels; pixel stride and weight-row stride (bf16)
};

__host__ __device__ inline ConvSmem conv_smem(int cin, int co_t) {
  ConvSmem s;
  s.cinp = (cin + 15) / 16 * 16;
  s.ps = s.cinp + 8;
  s.ws = 9 * s.cinp + 8;
  s.w = 0;
  s.in = (sizeof(__nv_bfloat16) * co_t * s.ws + 15) / 16 * 16;
  s.total = s.in + sizeof(__nv_bfloat16) * kHalo * kHalo * s.ps;
  return s;
}

template <int NT>  // output channels per block: co_t = 8 * NT
__global__ void __launch_bounds__(kWarps * 32)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int H, int W,
               int cin, int cout) {
  constexpr int co_t = 8 * NT;
  const ConvSmem S = conv_smem(cin, co_t);
  const int nchunk = cout / co_t;
  const int b = blockIdx.z / nchunk;
  const int co0 = (blockIdx.z % nchunk) * co_t;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;  // first output pixel
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem + S.w);    // [co_t][9][cinp]
  __nv_bfloat16* in_s = reinterpret_cast<__nv_bfloat16*>(smem + S.in);  // [kHalo][kHalo][cinp]

  const int groups = S.cinp / 8;
  const bool vec = cin % 8 == 0;
  for (int i = threadIdx.x; i < co_t * 9 * groups; i += blockDim.x) {
    const int grp = i % groups, row = i / groups;  // row = co * 9 + tap
    const __nv_bfloat16* src = w + (static_cast<size_t>(co0) * 9 + row) * cin + grp * 8;
    *reinterpret_cast<uint4*>(w_s + (row / 9) * S.ws + (row % 9) * S.cinp + grp * 8) =
        load8(src, vec, cin - grp * 8);
  }
  for (int i = threadIdx.x; i < kHalo * kHalo * groups; i += blockDim.x) {
    const int grp = i % groups, p = i / groups;
    const int gr = r0 - 1 + p / kHalo, gc = c0 - 1 + p % kHalo;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      v = load8(x + ((static_cast<size_t>(b) * H + gr) * W + gc) * cin + grp * 8, vec,
                cin - grp * 8);
    *reinterpret_cast<uint4*>(in_s + p * S.ps + grp * 8) = v;
  }
  __syncthreads();

  // warp w computes output rows w and w + 8 of the tile; an m16 tile is one
  // row of 16 pixels, lane rows g and g + 8 its pixels g and g + 8
  for (int m = warp; m < kTile; m += kWarps) {
    float acc[NT][4] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap % 3;
      for (int k0 = 0; k0 < S.cinp; k0 += 16) {
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const __nv_bfloat16* ip = in_s + ((m + kh) * kHalo + g + 8 * r + kw) * S.ps + k0 + 2 * t;
          a[r] = *reinterpret_cast<const uint32_t*>(ip);
          a[2 + r] = *reinterpret_cast<const uint32_t*>(ip + 8);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* wp = w_s + (nt * 8 + g) * S.ws + tap * S.cinp + k0 + 2 * t;
          mma_bf16(acc[nt], a, *reinterpret_cast<const uint32_t*>(wp),
                   *reinterpret_cast<const uint32_t*>(wp + 8));
        }
      }
    }
    const int gr = r0 + m;
    if (gr >= H) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int co = co0 + nt * 8 + 2 * t;
      const float b0 = bias ? bias[co] : 0.f, b1 = bias ? bias[co + 1] : 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // pixel g, then pixel g + 8
        const int gc = c0 + g + 8 * e;
        if (gc >= W) continue;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(__fadd_rn(acc[nt][2 * e], b0), __fadd_rn(acc[nt][2 * e + 1], b1));
        *reinterpret_cast<__nv_bfloat162*>(y + ((static_cast<size_t>(b) * H + gr) * W + gc) * cout +
                                           co) = v;
      }
    }
  }
}

template <int NT>
cudaError_t launch_conv3x3(const void* x, const void* w, const void* bias, void* y, int B, int H,
                           int W, int cin, int cout, cudaStream_t stream) {
  const size_t smem = conv_smem(cin, 8 * NT).total;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B * (cout / (8 * NT)));
  conv3x3_kernel<NT><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), H, W, cin, cout);
  return cudaGetLastError();
}

// ---- (b) the weight gradient ----------------------------------------------

constexpr int kDwStages = 6;     // ring slots: 3 rows in use, 1 being refilled, 2 in flight
constexpr int kDwMaxSlab = 128;  // pixels a slab is wide at most
constexpr int kDwRawCin = 5;     // cin up to this takes the raw-row path
constexpr int kDwXRaw = 672;     // bf16 of one raw x row: (128 + 2) * 5 + 2 * 7, rounded up
constexpr int kThreads = kWarps * 32;
constexpr int kDwCluster = 8;    // blocks (consecutive chunks) of a cluster

struct DwArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* g;
  float* work;    // per tile: one partial sum per cluster of kDwCluster chunks
  int* counters;  // per tile: an arrival counter, zero between calls
  float* dw;
  int B, H, W, cin, cout;
  int ci_t, co_t;  // the block's channel tile: rows of M (9 * ci_t, or 48 raw) x co_t
  int sw, slabs, rows, rowchunks, nchunks;
};

// One ring slot, in bf16: the NHWC path's x row of the slab with its halo,
// [sw + 2][ci_t + 8], or the raw path's x row [kDwXRaw]; then the g row,
// [sw][co_t + 8]. The pitch of 8 extra channels puts the 8 rows of an
// ldmatrix on 8 different 16-byte bank groups. The block's [M][co_t] f32
// sum reuses the ring at the end.
__host__ __device__ constexpr int dw_slot(bool raw, int sw, int ci_t, int co_t) {
  return ((raw ? kDwXRaw : (sw + 2) * (ci_t + 8)) + sw * (co_t + 8) + 7) / 8 * 8;
}

__host__ __device__ constexpr size_t dw_smem_bytes(bool raw, int sw, int ci_t, int co_t) {
  const size_t ring = sizeof(__nv_bfloat16) * kDwStages * dw_slot(raw, sw, ci_t, co_t);
  // a copy of the [M][co_t] sum for each group of warps along the pixels:
  // kWarps of them (raw), or kWarps / (ci_t / 16 * co_t / 16) of 9 ci_t co_t
  const size_t red = sizeof(float) * kWarps * (raw ? ci_t * co_t : 9 * 256);
  return ring > red ? ring : red;
}

// store(i, rows[0][i] + rows[1][i] + ... + rows[n - 1][i]) for the elements
// i in [lo, lo + count), count <= EB * kThreads, the rows added in order. The
// rows were written by other blocks, so they are read through L2; a thread
// keeps EB x KB loads in flight (~32), so the sum pays a few L2 round trips.
template <int EB, typename Store>
__device__ __forceinline__ void sum_rows(const float* rows, int n, int len, int lo, int count,
                                         Store store) {
  constexpr int KB = EB >= 32 ? 1 : 32 / EB;
  float acc[EB];
  for (int k0 = 0; k0 < n; k0 += KB) {
    float v[KB][EB];
#pragma unroll
    for (int u = 0; u < KB; ++u)
#pragma unroll
      for (int e = 0; e < EB; ++e) {
        const int i = threadIdx.x + e * kThreads;
        v[u][e] = k0 + u < n && i < count
                      ? __ldcg(rows + static_cast<size_t>(k0 + u) * len + lo + i)
                      : 0.f;
      }
#pragma unroll
    for (int u = 0; u < KB; ++u)
#pragma unroll
      for (int e = 0; e < EB; ++e)
        if (k0 + u < n) acc[e] = k0 + u == 0 ? v[u][e] : acc[e] + v[u][e];
  }
#pragma unroll
  for (int e = 0; e < EB; ++e)
    if (threadIdx.x + e * kThreads < count) store(lo + threadIdx.x + e * kThreads, acc[e]);
}

// Block (chunk, ci tile, co tile) sums dW over its chunk -- a run of image
// rows of one batch row, one column slab -- streaming the rows through the
// ring, then adds the chunk partials of its tile in a fixed order.
//
// NHWC path (RAW false): warps split into CI16 x CO16 tiles of (16 input, 16
// output channels), each holding all 9 taps, and kKw groups along the
// pixels. A[m = ci][k = pixel] is the x row kh shifted by kw -- a row
// address per lane of ldmatrix -- and B[k = pixel][n = co] the g row.
//
// Raw path (RAW, cin <= 5): for each kh, A_kh[m][k] = x[row + kh - 1][px_k
// + kw - 1][ci] with m = kw * cin + ci < 16 is the raw row's element
// px_k * cin + m - cin: a strided view, so each lane loads its fragment's
// 16-bit elements directly (no im2col, no unaligned ldmatrix). M = 3 x 16.
template <bool RAW, int CI16, int CO16>
__global__ void __launch_bounds__(kThreads, 2) conv_dw_kernel(const DwArgs a) {
  constexpr int kCi = RAW ? 48 : 16 * CI16;  // the tile's ci_t
  constexpr int kCo = 16 * CO16;
  constexpr int kXs = kCi + 8, kGs = kCo + 8;  // pixel pitches (NHWC x, g)
  constexpr int kUnits = RAW ? 1 : CI16 * CO16;
  constexpr int kKw = kWarps / kUnits;  // warps along the pixels
  constexpr int kMt = RAW ? 3 : 9;      // m16 tiles a warp holds (kh, or taps)
  constexpr int kNt = RAW ? 2 * CO16 : 2;
  constexpr int n_tile = (RAW ? kCi : 9 * kCi) * kCo;
  constexpr int kSlice = n_tile / kDwCluster;  // the tile elements a block of a cluster sums
  constexpr int kEB = (kSlice + kThreads - 1) / kThreads;
  const int slot = dw_slot(RAW, a.sw, kCi, kCo);
  const int g_at = RAW ? kDwXRaw : (a.sw + 2) * kXs;  // the g row within a slot
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int c = blockIdx.x;
  const int b = c / (a.slabs * a.rowchunks);
  const int c0 = (c / a.rowchunks) % a.slabs * a.sw;
  const int r_begin = c % a.rowchunks * a.rows;
  // the grid is rounded up to whole clusters: chunks past nchunks are empty
  const int nrows = c < a.nchunks ? max(0, min(a.H, r_begin + a.rows) - r_begin) : 0;
  const int ci0 = blockIdx.y * kCi, co0 = blockIdx.z * kCo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kidx = warp % kKw, unit = warp / kKw;
  const int cu = unit % CI16, ou = unit / CI16;  // NHWC: the warp's ci and co tiles
  const int gq = lane >> 2, t = lane & 3;
  const bool vec = a.cin % 8 == 0;
  const long long img = static_cast<long long>(a.W) * a.cin;  // x elements a row

  // the raw path's copy of x row xr starts at the 16-byte word holding
  // pixel max(c0 - 1, 0); pixel p of the row sits at rel + p * cin in it
  auto raw_rel = [&](int xr, long long& start) {
    const long long row = (static_cast<long long>(b) * a.H + xr) * img;
    start = (row + static_cast<long long>(c0 > 0 ? c0 - 1 : 0) * a.cin) / 8 * 8;
    return static_cast<int>(row - start);
  };

  // raw path: x row r + kh - 1's element (m, pixel p) sits in its slot at
  // raw_at[slot] + p * cin + m - cin (set when the row is issued)
  __shared__ int raw_at[kDwStages];

  // group j: x row r_begin - 1 + j and, from j = 2, g row r_begin + j - 2,
  // into slot j % kDwStages; every thread commits every group, even empty
  auto issue = [&](int j) {
    if (nrows > 0 && j < nrows + 2) {
      __nv_bfloat16* xs = ring + (j % kDwStages) * slot;
      const int xr = r_begin - 1 + j;
      const bool row_ok = xr >= 0 && xr < a.H;
      if constexpr (RAW) {
        if (row_ok) {
          long long start;
          const int rel = raw_rel(xr, start);
          if (threadIdx.x == 0) raw_at[j % kDwStages] = (j % kDwStages) * slot + rel;
          const long long end = start + rel + static_cast<long long>(min(c0 + a.sw + 1, a.W)) * a.cin;
          const int n = static_cast<int>((end - start + 7) / 8);
          for (int k = threadIdx.x; k < n; k += kThreads) {
            const long long e = start + 8LL * k;
            cp_async16(xs + 8 * k, a.x + e, static_cast<int>(min(8LL, end - e)) * 2);
          }
        } else {  // a row outside the image reads as zeros
          if (threadIdx.x == 0)
            raw_at[j % kDwStages] = (j % kDwStages) * slot - (c0 > 0 ? c0 - 1 : 0) * a.cin;
          for (int k = threadIdx.x; k < kDwXRaw / 8; k += kThreads)
            reinterpret_cast<uint4*>(xs)[k] = make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
        constexpr int kQ = kCi / 8;  // 16-byte words of a pixel's channels
        const __nv_bfloat16* xrow = a.x + (static_cast<long long>(b) * a.H + (row_ok ? xr : 0)) * img;
        for (int i = threadIdx.x; i < (a.sw + 2) * kQ; i += kThreads) {
          const int p = i / kQ, ch = ci0 + i % kQ * 8, gc = c0 - 1 + p;
          const bool ok = row_ok && gc >= 0 && gc < a.W && ch < a.cin;
          const __nv_bfloat16* src = ok ? xrow + gc * a.cin + ch : a.x;
          __nv_bfloat16* dst = xs + p * kXs + i % kQ * 8;
          if (vec) {
            cp_async16(dst, src, ok ? 16 : 0);
          } else {  // rows not 16-byte aligned: scalar loads
            *reinterpret_cast<uint4*>(dst) = ok ? load8(src, false, a.cin - ch)
                                                : make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
      if (j >= 2) {
        constexpr int kQ = kCo / 8;
        const __nv_bfloat16* grow =
            a.g + (static_cast<long long>(b) * a.H + r_begin + j - 2) * a.W * a.cout;
        __nv_bfloat16* gs = xs + g_at;
        for (int i = threadIdx.x; i < a.sw * kQ; i += kThreads) {
          const int p = i / kQ, co = co0 + i % kQ * 8, gc = c0 + p;
          const bool ok = gc < a.W && co < a.cout;
          cp_async16(gs + p * kGs + i % kQ * 8, ok ? grow + gc * a.cout + co : a.g, ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };

  // raw path: a warp has at most one k-step (sw <= 16 * kWarps). This
  // lane's fragments hold A rows m = gq and gq + 8 of every kh tile and
  // pixels px + {0, 1, 8, 9}; bit (4 hi + q) of ok says whether element
  // (row, pixel q) lies in the image (and the row exists, m < 3 * cin)
  const int px = c0 + 16 * kidx + 2 * t;
  unsigned ok = 0;
  if constexpr (RAW) {
    const int kw_lo = gq / a.cin, kw_hi = (gq + 8) / a.cin;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = px + (q & 1) + 8 * (q >> 1);
      const int lo = p + kw_lo - 1, hi = p + kw_hi - 1;
      ok |= (gq < 3 * a.cin && lo >= 0 && lo < a.W ? 1u : 0u) << q;
      ok |= (gq + 8 < 3 * a.cin && hi >= 0 && hi < a.W ? 1u : 0u) << (4 + q);
    }
  }

  float acc[kMt][kNt][4] = {};
  for (int j = 0; j < kDwStages - 1; ++j) issue(j);
  for (int i = 0; i < nrows; ++i) {
    cp_async_wait<kDwStages - 4>();  // groups <= i + 2 have landed
    __syncthreads();                  // ... for every thread; row i - 1 is done
    issue(i + kDwStages - 1);         // into the slot of group i - 1
    const __nv_bfloat16* gs = ring + ((i + 2) % kDwStages) * slot + g_at;
    for (int s = kidx; s < a.sw / 16; s += kKw) {
      if constexpr (RAW) {
        uint32_t bq[CO16][4];
#pragma unroll
        for (int u = 0; u < CO16; ++u)
          ldmatrix_x4_trans(bq[u], gs + (16 * s + (lane & 7) + 8 * ((lane >> 3) & 1)) * kGs +
                                       16 * u + 8 * (lane >> 4));
        const uint16_t* r16 = reinterpret_cast<const uint16_t*>(ring);
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          // element (m = gq, pixel px) of x row kh
          const int base = raw_at[(i + kh) % kDwStages] + (px - 1) * a.cin + gq;
          uint32_t af[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // a0: (gq, 2t..), a1: (gq+8, 2t..), a2/a3: pixels + 8
            const int hi = r & 1, q0 = 2 * (r >> 1);
            uint32_t v = 0;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int q = q0 + e;
              const int p = (q & 1) + 8 * (q >> 1);
              if (ok >> (4 * hi + q) & 1u)
                v |= static_cast<uint32_t>(r16[base + p * a.cin + 8 * hi]) << (16 * e);
            }
            af[r] = v;
          }
#pragma unroll
          for (int u = 0; u < CO16; ++u) {
            mma_bf16(acc[kh][2 * u], af, bq[u][0], bq[u][1]);
            mma_bf16(acc[kh][2 * u + 1], af, bq[u][2], bq[u][3]);
          }
        }
      } else {
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, gs + (16 * s + (lane & 7) + 8 * ((lane >> 3) & 1)) * kGs +
                                  16 * ou + 8 * (lane >> 4));
        const int ap = 16 * s + (lane & 7) + 8 * (lane >> 4);
        const int ac = 16 * cu + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const __nv_bfloat16* xs = ring + ((i + kh) % kDwStages) * slot + ap * kXs + ac;
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            uint32_t af[4];
            ldmatrix_x4_trans(af, xs + kw * kXs);
            mma_bf16(acc[kh * 3 + kw][0], af, bq[0], bq[1]);
            mma_bf16(acc[kh * 3 + kw][1], af, bq[2], bq[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's sum [M][co_t]: each pixel-warp group writes its own copy,
  // then the copies are added in group order into the first
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < kMt; ++mi)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (RAW ? 16 * mi : mi * kCi + 16 * cu) + gq + 8 * (e >> 1);
        const int co = (RAW ? 8 * nt : 16 * ou + 8 * nt) + 2 * t + (e & 1);
        red[kidx * n_tile + row * kCo + co] = acc[mi][nt][e];
      }
  __syncthreads();
  if constexpr (kKw > 1) {
    for (int i = threadIdx.x; i < n_tile; i += kThreads) {
      float s = red[i];
#pragma unroll
      for (int kk = 1; kk < kKw; ++kk) s += red[kk * n_tile + i];
      red[i] = s;
    }
    __syncthreads();
  }

  // The cluster's blocks add their sums: block rank r adds slice r of the
  // tile over the cluster's blocks in rank order (distributed shared
  // memory) into the cluster's partial. The last cluster of the tile to
  // finish, found with a counter after __threadfence, then adds the
  // clusters' partials in cluster order into dw, each block its slice, and
  // leaves the counter zero. Fixed orders: bit-identical repeats.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nclusters = gridDim.x / kDwCluster;
  const int tile = blockIdx.y * gridDim.z + blockIdx.z;
  float* tw = a.work + static_cast<size_t>(tile) * nclusters * n_tile;
  for (int i = threadIdx.x; i < kSlice; i += kThreads) {
    const int idx = rank * kSlice + i;
    float s = *cluster.map_shared_rank(red + idx, 0);
#pragma unroll
    for (int r = 1; r < kDwCluster; ++r) s += *cluster.map_shared_rank(red + idx, r);
    tw[static_cast<size_t>(blockIdx.x / kDwCluster) * n_tile + idx] = s;
  }
  __threadfence();
  cluster.sync();  // every slice written; no block reads another's shared memory after this
  __shared__ int last;
  if (rank == 0 && threadIdx.x == 0) {
    const int v = atomicAdd(&a.counters[tile], 1) == nclusters - 1;
    for (int r = 0; r < kDwCluster; ++r) *cluster.map_shared_rank(&last, r) = v;
  }
  cluster.sync();
  if (!last) return;
  if (rank == 0 && threadIdx.x == 0) a.counters[tile] = 0;
  sum_rows<kEB>(tw, nclusters, n_tile, rank * kSlice, kSlice, [&](int i, float s) {
    const int row = i / kCo, co = co0 + i % kCo;
    int tap, ci;
    if (RAW) {  // row = kh * 16 + kw * cin + ci
      const int m = row % 16;
      tap = m < 3 * a.cin ? row / 16 * 3 + m / a.cin : 9;
      ci = m % a.cin;
    } else {  // row = tap * ci_t + ci
      tap = row / kCi;
      ci = ci0 + row % kCi;
    }
    if (tap < 9 && ci < a.cin && co < a.cout) a.dw[(tap * a.cin + ci) * a.cout + co] = s;
  });
}

template <bool RAW, int CI16, int CO16>
cudaError_t launch_conv_dw(const DwArgs& a, int citiles, int cotiles, cudaStream_t stream) {
  const size_t smem = dw_smem_bytes(RAW, a.sw, a.ci_t, a.co_t);
  cudaError_t err = cudaFuncSetAttribute(conv_dw_kernel<RAW, CI16, CO16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.nchunks + kDwCluster - 1) / kDwCluster * kDwCluster, citiles, cotiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kDwCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, conv_dw_kernel<RAW, CI16, CO16>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool RAW, int CI16>
cudaError_t launch_conv_dw_co(const DwArgs& a, int citiles, int cotiles, cudaStream_t stream) {
  return a.co_t == 16 ? launch_conv_dw<RAW, CI16, 1>(a, citiles, cotiles, stream)
                      : launch_conv_dw<RAW, CI16, 2>(a, citiles, cotiles, stream);
}

}  // namespace

// y (B,H,W,cout) bf16 = conv3x3(x (B,H,W,cin) bf16, w (cout,3,3,cin) bf16)
// + bias (cout,) f32, or no bias when bias is null. Requires cout % 8 == 0
// (checked by the wrapper too).
extern "C" int conv3x3_launch(const void* x, const void* w, const void* bias, void* y, int B,
                              int H, int W, int cin, int cout, void* stream) {
  if (cout % 8 != 0 || cin <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout % 32 == 0) return launch_conv3x3<4>(x, w, bias, y, B, H, W, cin, cout, s);
  if (cout % 16 == 0) return launch_conv3x3<2>(x, w, bias, y, B, H, W, cin, cout, s);
  return launch_conv3x3<1>(x, w, bias, y, B, H, W, cin, cout, s);
}


// dw (3,3,cin,cout) f32 from x (B,H,W,cin) bf16 and g (B,H,W,cout) bf16, in
// one launch of grid (nchunks, ci tiles, co tiles). The split is made by
// ops/conv_train_cuda.py _dw_plan: chunk c covers batch row c / (slabs *
// rowchunks), the columns [s * sw, (s + 1) * sw) with s = c / rowchunks %
// slabs, and the rows [rc * rows, (rc + 1) * rows) with rc = c % rowchunks,
// each clipped to the image; ci_t x co_t is a block's channel tile (for cin
// <= 5, the raw path, ci_t = 48 rows of (kh, kw, ci), one ci tile);
// the grid's first dimension is nchunks rounded up to clusters of 8. work
// holds tiles * ceil(nchunks / 8) * M * co_t f32 (M = 9 * ci_t, or 48 on the
// raw path), counters one int32 a tile, zero before the call and after it.
// Requires cout % 8 == 0.
extern "C" int conv_dw_launch(const void* x, const void* g, void* work, void* counters, void* dw,
                              int B, int H, int W, int cin, int cout, int ci_t, int co_t, int sw,
                              int slabs, int rows, int rowchunks, int nchunks, void* stream) {
  const bool raw = cin <= kDwRawCin;
  const bool ci_ok = raw ? ci_t == 48 : ci_t == 16 || ci_t == 32 || ci_t == 64;
  if (cout % 8 != 0 || cin <= 0 || !ci_ok || (co_t != 16 && co_t != 32) || sw % 16 != 0 ||
      sw < 16 || sw > kDwMaxSlab || slabs * sw < W || rows * rowchunks < H ||
      nchunks != B * slabs * rowchunks)
    return cudaErrorInvalidValue;
  const DwArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
                 static_cast<float*>(work), static_cast<int*>(counters), static_cast<float*>(dw),
                 B, H, W, cin, cout, ci_t, co_t, sw, slabs, rows, rowchunks, nchunks};
  const int citiles = raw ? 1 : (cin + ci_t - 1) / ci_t, cotiles = (cout + co_t - 1) / co_t;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (raw) return launch_conv_dw_co<true, 1>(a, citiles, cotiles, s);
  if (ci_t == 16) return launch_conv_dw_co<false, 1>(a, citiles, cotiles, s);
  if (ci_t == 32) return launch_conv_dw_co<false, 2>(a, citiles, cotiles, s);
  return launch_conv_dw_co<false, 4>(a, citiles, cotiles, s);
}
