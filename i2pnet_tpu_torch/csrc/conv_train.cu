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
// therefore reads each input row once per channel tile and writes each
// output once, and keeps the arithmetic on bf16 tensor cores
// (mma.sync.m16n8k16, f32 accumulate), whose rate is not the limit, so
// wgmma would not move it.
//
// (a): a block owns a strip of output rows of one batch row, in a column
// slab of at most 128 output pixels, and a tile of output channels -- all
// of cout up to 64 where its weights fit, so each input row is read once.
// - The input rows stream through a ring of shared-memory slots filled by
//   16-byte cp.async (zero-filled outside the image), NHWC with a pitch of
//   8 extra channels; A and B fragments come by ldmatrix, a tap's column
//   shift being a row address per lane. The weights arrive by cp.async
//   with the first rows.
// - An iteration computes 4 output rows from the 6 input rows that cover
//   them, behind one barrier. A warp item is two output rows x two m16
//   tiles x two n8 tiles: each input row's A fragment (per kw) feeds both
//   output rows, each B fragment both tiles and, kept a row, both output
//   rows -- 8 independent mma.sync chains an item.
// - cin <= 5 (the image): the raw rows are copied as runs of 16-byte words
//   and each iteration expands the next iteration's 4 rows to 4 channels a
//   pixel (8 for cin = 5), so a kh row's 9 (kw, channel) pairs are one k16
//   step: 3 steps where the earlier kernel ran 9 on channels padded to 16.
// - The epilogue adds the bias in f32 (__fadd_rn) and rounds to bf16 once,
//   into the item's own part of 4 staged output rows; the warp then writes
//   that part as 16-byte vectors, consecutive lanes on consecutive vectors
//   -- no barrier, since no other warp reads it.
// - The launch plan (conv_plan, mirrored in ops/conv_train_cuda.py) takes
//   the widest channel tile that fits, the widest slab that lets 3 blocks
//   share a SM (at most 85 registers a thread), else 2, else 1, halves the
//   channel tile where a small image would leave SMs empty, and cuts the
//   rows into strips that fill one wave. conv3x3_launch_plan runs any
//   other plan, for timing and for the card tests.
// What bounds it, as measured (NVIDIA H100 80GB HBM3, 700.00 W,
// tools/torch_kernel_times.py): not device memory -- the 3 -> 16 call at
// 384x1280 moves 150 MB in ~0.13 ms, about 1.1 TB/s -- but each
// iteration's chain of copies issued, fragment loads, mma chains and
// stores, overlapped only by the 2-3 blocks a SM holds: builds with one of
// those parts removed (a scratch ablation, each timed alone) each ran
// faster, none by half, the mma chains and their fragment loads the most.
// Tried and slower or no faster: 1-3 iterations of rows in flight
// (the same times: the copies are in before they are needed); a plan that
// preferred 8 items an iteration over a wide channel tile (the 32 -> 16 dx
// call at 192x640 read its input twice and took 0.153 ms against 0.088);
// a barrier after each iteration's staged rows, with all threads storing
// them (slower by about a tenth on the free step); 2 blocks a SM at up to
// 128 registers a thread, or 4 at 64 (scratch builds, timed over the free
// step's calls together: both slower, by a fifth or more).

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

using bf16 = __nv_bfloat16;
constexpr int kConvRows = 4;  // output rows an iteration computes
// input rows issued before the first iteration: the 6 it reads (NHWC); on
// the raw path also the next iteration's 4, which each iteration expands
// for the next one
__host__ __device__ constexpr int conv_ahead(bool raw) { return raw ? 10 : 6; }
// input-row ring slots: those, and 4 for the rows issued as an iteration starts
__host__ __device__ constexpr int conv_stages(bool raw) { return conv_ahead(raw) + kConvRows; }
constexpr int kConvRawCin = 5;                       // cin up to this takes the raw-row path
constexpr int kConvExpSlots = 10;  // raw path: expanded rows, the 6 in use and the next 4
constexpr int kConvThreads = kWarps * 32;

struct ConvArgs {
  const bf16* x;
  const bf16* w;
  const float* bias;  // null: no bias (dx)
  bf16* y;
  int B, H, W, cin, cout;
  int co_t, mt;         // channel tile; m16 tiles of a slab row (16 mt output pixels)
  int sw, slabs;        // output columns a slab; slabs a row
  int rows, rowchunks;  // output rows a strip; strips an image
};

// Shared-memory layout (bytes, 16-aligned sections), mirrored by
// ops/conv_train_cuda.py _conv_smem.
struct ConvLayout {
  int c4, kh16;    // raw path: channels of an expanded pixel (4, 8); K of a kh row
  int eslot;       // raw path: elements of an expanded row
  int kp, wpitch;  // K padded to k16 steps; weight-row pitch (bf16)
  int xpitch;      // NHWC: pixel pitch of an input row (bf16)
  int xslot;       // elements of an input slot
  int spitch;      // pixel pitch of a staged output row (bf16)
  size_t w, in, ex, st, bs, total;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ __device__ inline ConvLayout conv_layout(int cin, int co_t, int mt) {
  ConvLayout L;
  const bool raw = cin <= kConvRawCin;
  const int cw = 16 * mt, cinp = round_up(cin, 16);
  L.c4 = cin <= 4 ? 4 : 8;
  L.kh16 = round_up(3 * L.c4, 16);
  L.eslot = raw ? (cw + L.kh16 / L.c4 + 1) * L.c4 : 0;
  L.kp = raw ? 3 * L.kh16 : 9 * cinp;
  L.wpitch = L.kp + 8;
  L.xpitch = cinp + 8;
  // raw: the row's elements from a 16-byte word at most 7 before the first
  // needed one, in whole words
  L.xslot = raw ? round_up((cw + 2) * cin + 14, 8) : (cw + 2) * L.xpitch;
  L.spitch = co_t + 8;
  size_t o = 0;
  L.w = o;
  o += round_up(round_up(co_t, 16) * L.wpitch * 2, 16);  // rows padded to 16 for ldmatrix.x4
  L.in = o;
  o += static_cast<size_t>(conv_stages(raw)) * L.xslot * 2;
  L.ex = o;
  o += static_cast<size_t>(raw ? kConvExpSlots : 0) * L.eslot * 2;
  L.st = o;
  o += static_cast<size_t>(kConvRows) * cw * L.spitch * 2;
  L.bs = o;
  o += co_t * sizeof(float);
  L.total = o;
  return L;
}

// Block (batch row, slab, strip, channel tile), RAW for cin <= 5; KC
// 16-channel chunks of the input (NHWC path; 0: as many as cin takes, a
// loop), or on the raw path the channels of an expanded pixel (4 or 8).
//
// An iteration computes kConvRows = 4 output rows from the 6 input rows
// that cover them. A warp item is two output rows x two m16 tiles (32
// pixels) x two n8 tiles (16 channels): each of the item's 4 input rows is
// loaded once per kw (NHWC; once on the raw path) and feeds both output
// rows -- row q0 at kh = jj, row q0 + 1 at kh = jj - 1 --, and each B
// fragment feeds both tiles and, kept for the next input row, both output
// rows: 8 independent accumulator chains an item.
template <bool RAW, int KC>
__global__ void __launch_bounds__(kConvThreads, 3) conv3x3_kernel(const ConvArgs a) {
  constexpr int kConvAhead = conv_ahead(RAW), kConvStages = conv_stages(RAW);
  extern __shared__ __align__(16) unsigned char smem[];
  const ConvLayout L = conv_layout(a.cin, a.co_t, a.mt);
  bf16* w_s = reinterpret_cast<bf16*>(smem + L.w);
  bf16* in_s = reinterpret_cast<bf16*>(smem + L.in);
  bf16* ex_s = reinterpret_cast<bf16*>(smem + L.ex);
  bf16* st_s = reinterpret_cast<bf16*>(smem + L.st);
  float* bias_s = reinterpret_cast<float*>(smem + L.bs);
  __shared__ int raw_at[conv_stages(true)];  // raw path: pixel p of a slot's row at raw_at + p * cin

  const int cotiles = a.cout / a.co_t;
  int idx = blockIdx.x;
  const int ct = idx % cotiles;
  idx /= cotiles;
  const int rc = idx % a.rowchunks;
  idx /= a.rowchunks;
  const int sl = idx % a.slabs;
  const int b = idx / a.slabs;
  const int co0 = ct * a.co_t;
  const int c0 = sl * a.sw;  // the column of the slab's output pixel 0
  const int sw_n = min(a.sw, a.W - c0);
  const int r_begin = rc * a.rows, r_end = min(a.H, r_begin + a.rows);
  if (sw_n <= 0 || r_begin >= r_end) return;  // uniform over the block
  const int nrows = r_end - r_begin;
  const int cw = 16 * a.mt;
  const int cin = a.cin, cinp = round_up(cin, 16);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = cin % 8 == 0;
  const long long rowlen = static_cast<long long>(a.W) * cin;  // x elements a row

  // the tile's weights, [co][k] (k = tap * cinp + ci, or the raw path's
  // kh * kh16 + kw * c4 + ci), zeros past cin, past 3 c4 and past co_t; by
  // cp.async where the rows are 16-byte aligned (committed with the first
  // input row), so a block's first loads are all in flight together
  const int co_rows = round_up(a.co_t, 16);
  for (int i = threadIdx.x; i < co_rows * (L.kp / 8); i += kConvThreads) {
    const int co = i / (L.kp / 8), k8 = i % (L.kp / 8) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (!RAW && vec) {
      const int tap = k8 / cinp, ci = k8 % cinp;
      const bool ok = co < a.co_t && ci < cin;
      cp_async16(w_s + co * L.wpitch + k8,
                 ok ? a.w + (static_cast<size_t>(co0 + co) * 9 + tap) * cin + ci : a.w, ok ? 16 : 0);
      continue;
    }
    if (co < a.co_t) {
      if constexpr (RAW) {
        __align__(16) bf16 e[8];
        for (int j = 0; j < 8; ++j) {
          const int kh = (k8 + j) / L.kh16, kk = (k8 + j) % L.kh16;
          const int kw = kk / L.c4, ci = kk % L.c4;
          e[j] = kw < 3 && ci < cin
                     ? a.w[(static_cast<size_t>(co0 + co) * 9 + kh * 3 + kw) * cin + ci]
                     : __float2bfloat16_rn(0.f);
        }
        v = *reinterpret_cast<const uint4*>(e);
      } else {
        const int tap = k8 / cinp, ci = k8 % cinp;
        v = load8(a.w + (static_cast<size_t>(co0 + co) * 9 + tap) * cin + ci, vec, cin - ci);
      }
    }
    *reinterpret_cast<uint4*>(w_s + co * L.wpitch + k8) = v;
  }
  for (int i = threadIdx.x; i < a.co_t; i += kConvThreads)
    bias_s[i] = a.bias ? a.bias[co0 + i] : 0.f;

  // group j: input row r_begin - 1 + j into slot j % kConvStages (while j <
  // nrows + 2); every thread commits every group, even empty
  auto issue = [&](int j) {
    if (j < nrows + 2) {
      bf16* xs = in_s + (j % kConvStages) * L.xslot;
      const int xr = r_begin - 1 + j;
      if (xr >= 0 && xr < a.H) {
        const long long rowbase = (static_cast<long long>(b) * a.H + xr) * rowlen;
        if constexpr (RAW) {
          const int pf = max(c0 - 1, 0), pl = min(c0 + cw + 1, a.W);
          const long long start = (rowbase + static_cast<long long>(pf) * cin) / 8 * 8;
          const long long end = rowbase + static_cast<long long>(pl) * cin;
          if (threadIdx.x == 0)
            raw_at[j % kConvStages] =
                (j % kConvStages) * L.xslot + static_cast<int>(rowbase - start);
          const int n = static_cast<int>((end - start + 7) / 8);
          for (int k = threadIdx.x; k < n; k += kConvThreads) {
            const long long e = start + 8LL * k;
            cp_async16(xs + 8 * k, a.x + e, static_cast<int>(min(8LL, end - e)) * 2);
          }
        } else {
          const int q8 = KC > 0 ? 2 * KC : cinp / 8;
          for (int i = threadIdx.x; i < (cw + 2) * q8; i += kConvThreads) {
            const int p = i / q8, ch = i % q8 * 8, gc = c0 - 1 + p;
            const bool ok = gc >= 0 && gc < a.W && ch < cin;
            const bf16* src = ok ? a.x + rowbase + static_cast<long long>(gc) * cin + ch : a.x;
            bf16* dst = xs + p * L.xpitch + ch;
            if (vec) {
              cp_async16(dst, src, ok ? 16 : 0);
            } else {  // rows not 16-byte aligned: scalar loads
              *reinterpret_cast<uint4*>(dst) = ok ? load8(src, false, cin - ch)
                                                  : make_uint4(0u, 0u, 0u, 0u);
            }
          }
        }
      } else if (!RAW) {  // a row outside the image reads as zeros (raw: masked)
        for (int i = threadIdx.x; i < L.xslot / 8; i += kConvThreads)
          reinterpret_cast<uint4*>(xs)[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  // raw path: group j's row, expanded to c4 channels a pixel (zeros past
  // cin and outside the image), pixel p = input column c0 - 1 + p
  auto expand = [&](int j) {
    bf16* e = ex_s + (j % kConvExpSlots) * L.eslot;
    const int xr = r_begin - 1 + j;
    const bool row_ok = xr >= 0 && xr < a.H;
    const uint16_t* r16 = reinterpret_cast<const uint16_t*>(in_s) + raw_at[j % kConvStages];
    for (int p = threadIdx.x; p < L.eslot / L.c4; p += kConvThreads) {
      const int gc = c0 - 1 + p;  // past the copied columns (read by zero weights): zeros
      const bool ok = row_ok && gc >= 0 && gc < a.W && gc <= c0 + cw;
      uint16_t v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = ok && c < cin ? r16[gc * cin + c] : 0;
      uint32_t* d = reinterpret_cast<uint32_t*>(e + p * L.c4);
#pragma unroll
      for (int c = 0; c < 8; c += 2)
        if (c < L.c4) d[c / 2] = v[c] | static_cast<uint32_t>(v[c + 1]) << 16;
    }
  };

  const int NT = a.co_t / 8;         // n8 tiles of the channel tile
  const int ngroups = (NT + 1) / 2;  // an item's two n8 tiles
  const int mp = (a.mt + 1) / 2;     // pairs of m16 tiles
  const int items = (kConvRows / 2) * mp * ngroups;
  const int kcs = KC > 0 ? KC : cinp / 16;
  // ldmatrix row addresses: A (pixel, channel) and B (n, k) within a k16 step
  const int a_px = (lane & 7) + 8 * ((lane >> 3) & 1), a_ch = 8 * (lane >> 4);
  const int b_n = (lane & 7) + 8 * (lane >> 4), b_k = 8 * ((lane >> 3) & 1);
  for (int j = 0; j < kConvAhead; ++j) issue(j);
  if constexpr (RAW) {  // the first iteration's 6 rows, expanded
    cp_async_wait<kConvAhead - 6>();
    __syncthreads();
    for (int j = 0; j < min(6, nrows + 2); ++j) expand(j);
  }
  for (int i0 = 0; i0 < nrows; i0 += kConvRows) {  // output rows r_begin + i0 ..
    // every group issued has landed (NHWC: the iteration's rows; raw: also
    // the next iteration's) and, after the barrier, every thread's; the
    // last iteration's reads of the slots refilled now are done
    cp_async_wait<0>();
    __syncthreads();
    for (int k = 0; k < kConvRows; ++k) issue(i0 + kConvAhead + k);
    if constexpr (RAW)  // the next iteration's new rows (read after its barrier)
      for (int j = i0 + 6; j < min(i0 + 10, nrows + 2); ++j) expand(j);

    for (int item = warp; item < items; item += kWarps) {
      const int pi = item % mp, rp = item / mp % (kConvRows / 2);
      const int nt0 = item / (mp * (kConvRows / 2)) * 2;
      const int q0 = 2 * rp;  // the item's output rows: i0 + q0, i0 + q0 + 1
      if (i0 + q0 >= nrows) continue;      // uniform over the warp
      const bool two = 2 * pi + 1 < a.mt;  // the pair's second tile
      const bool hi = nt0 + 1 < NT;        // the item's second n8 tile
      float acc[2][2][2][4] = {};          // [output row][m16 tile][n8 tile]
      // acc[q][tile] += A_tile @ B for the item's n8 tiles (bq: both, ldmatrix.x4)
      auto mma2 = [&](int q, const uint32_t (&a0)[4], const uint32_t (&a1)[4],
                      const uint32_t (&bq)[4]) {
        mma_bf16(acc[q][0][0], a0, bq[0], bq[1]);
        if (hi) mma_bf16(acc[q][0][1], a0, bq[2], bq[3]);
        if (two) {
          mma_bf16(acc[q][1][0], a1, bq[0], bq[1]);
          if (hi) mma_bf16(acc[q][1][1], a1, bq[2], bq[3]);
        }
      };
      const bf16* wrow = w_s + (nt0 * 8 + b_n) * L.wpitch + b_k;
      if constexpr (RAW) {
        // A[m][k] of an input row at k = kw * c4 + ci is the expanded row's
        // element (m + kw) * c4 + ci = m * c4 + k: 32-bit words, k even
        // (past 3 c4 the weights are zero)
        auto raw_frag = [&](uint32_t (&af)[4], const bf16* e, int mi, int kq) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              af[rr + 2 * h] = *reinterpret_cast<const uint32_t*>(
                  e + (mi * 16 + g + 8 * rr) * KC + 16 * kq + 2 * t + 8 * h);
        };
        constexpr int kKq = (3 * KC + 15) / 16;
#pragma unroll
        for (int kq = 0; kq < kKq; ++kq) {
          uint32_t bprev[4] = {};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const bf16* e = ex_s + ((i0 + q0 + jj) % kConvExpSlots) * L.eslot;
            uint32_t a0[4], a1[4] = {}, bcur[4] = {};
            raw_frag(a0, e, 2 * pi, kq);
            if (two) raw_frag(a1, e, 2 * pi + 1, kq);
            if (jj < 3) {
              ldmatrix_x4(bcur, wrow + jj * (kKq * 16) + 16 * kq);
              mma2(0, a0, a1, bcur);
            }
            if (jj > 0) mma2(1, a0, a1, bprev);
#pragma unroll
            for (int r = 0; r < 4; ++r) bprev[r] = bcur[r];
          }
        }
      } else {
#pragma unroll
        for (int cc = 0; cc < (KC > 0 ? KC : 1); ++cc) {
          for (int c2 = 0; c2 < (KC > 0 ? 1 : kcs); ++c2) {
            const int ch = 16 * (cc + c2);
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
              uint32_t bprev[4] = {};
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                const bf16* xs = in_s + ((i0 + q0 + jj) % kConvStages) * L.xslot +
                                 (32 * pi + a_px + kw) * L.xpitch + a_ch + ch;
                uint32_t a0[4], a1[4] = {}, bcur[4] = {};
                ldmatrix_x4(a0, xs);
                if (two) ldmatrix_x4(a1, xs + 16 * L.xpitch);
                if (jj < 3) {
                  ldmatrix_x4(bcur, wrow + (jj * 3 + kw) * cinp + ch);
                  mma2(0, a0, a1, bcur);
                }
                if (jj > 0) mma2(1, a0, a1, bprev);
#pragma unroll
                for (int r = 0; r < 4; ++r) bprev[r] = bcur[r];
              }
            }
          }
        }
      }
      // epilogue: the bias added in f32, one rounding to bf16, into the
      // item's own part of the staged rows; then the warp writes that part
      // as 16-byte vectors, consecutive lanes on consecutive vectors (no
      // barrier: no other warp reads it, and the warp's next item writes
      // after these reads)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        bf16* srow = st_s + (q0 + q) * cw * L.spitch;
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          if (tt == 1 && !two) break;
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            if (jn == 1 && !hi) break;
            const int co = (nt0 + jn) * 8 + 2 * t;
            const float b0 = bias_s[co], b1 = bias_s[co + 1];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int m = (2 * pi + tt) * 16 + g + 8 * rr;
              *reinterpret_cast<uint32_t*>(srow + m * L.spitch + co) =
                  pack_bf16(__fadd_rn(acc[q][tt][jn][2 * rr], b0),
                            __fadd_rn(acc[q][tt][jn][2 * rr + 1], b1));
            }
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // (row, pixel, 8-channel half) of the item
        const int v = lane + 32 * k;
        const int q = v >> 6, m = 32 * pi + ((v >> 1) & 31), half = v & 1;
        if (i0 + q0 + q >= nrows || m >= sw_n || (half && !hi)) continue;
        const int co = nt0 * 8 + 8 * half;
        const uint4 val =
            *reinterpret_cast<const uint4*>(st_s + ((q0 + q) * cw + m) * L.spitch + co);
        *reinterpret_cast<uint4*>(
            a.y + ((static_cast<long long>(b) * a.H + r_begin + i0 + q0 + q) * a.W + c0 + m) *
                      a.cout + co0 + co) = val;
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
}

using ConvKern = void (*)(const ConvArgs);

// the kernel instance: the raw path by the channels of an expanded pixel;
// the NHWC path unrolled over cin's 16-channel chunks where it can be
ConvKern pick_conv(int cin) {
  if (cin <= kConvRawCin) return cin <= 4 ? conv3x3_kernel<true, 4> : conv3x3_kernel<true, 8>;
  switch ((cin + 15) / 16) {
    case 1: return conv3x3_kernel<false, 1>;
    case 2: return conv3x3_kernel<false, 2>;
    case 4: return conv3x3_kernel<false, 4>;
    default: return conv3x3_kernel<false, 0>;
  }
}

constexpr int kSmPerSm = 233472;        // shared memory of a SM (228 KB)
constexpr int kBlockReserve = 1024 + 128;  // per block: the runtime's 1 KB and raw_at
constexpr int kMaxConvSmem = 232448 - 128;  // dynamic shared memory a block may take
constexpr int kConvStartRows = 12;  // a block's start (weights, first 6 rows), in rows of work

// Kernel (a)'s launch plan, a function of the shape and the SM count,
// mirrored by ops/conv_train_cuda.py _conv_plan (chosen from the times of
// the encoder's calls on other plans, tools/torch_kernel_times.py sweep):
// - the widest channel tile (a multiple of 8 dividing cout, <= 64) whose
//   layout fits a block at all: each input row is then read the fewest
//   times;
// - the widest slab (at most 128 output pixels, 16 mt) whose layout lets 3
//   blocks share a SM, if it is at least 4 m16 tiles wide; else the widest
//   that lets 2 share one; else the widest that fits;
// - where even one block per strip of 4 rows would leave SMs empty, the
//   channel tile halved (small images);
// - the output rows cut into strips, multiples of the 4 rows an iteration
//   computes, for one wave of the blocks the SMs hold, or two where that
//   spreads the rows more evenly (the 3 -> 16 call at 384x1280: 320 blocks
//   for 396 places left some SMs 3 blocks and others 2).
struct ConvPlan {
  int co_t, mt, sw, slabs, rows, rowchunks;
};

// the widest slab of W output columns (mt <= mt_cap) whose layout fits budget
bool conv_slab(int W, int cin, int co_t, int budget, ConvPlan& p) {
  for (int mt_cap = 8; mt_cap >= 1; --mt_cap) {
    const int slabs = (W + 16 * mt_cap - 1) / (16 * mt_cap);
    const int sw = (W + slabs - 1) / slabs, mt = (sw + 15) / 16;
    if (conv_layout(cin, co_t, mt).total <= static_cast<size_t>(budget)) {
      p = ConvPlan{co_t, mt, sw, slabs, 0, 0};
      return true;
    }
  }
  return false;
}

bool conv_plan(int B, int H, int W, int cin, int cout, int sms, ConvPlan& p) {
  if (cout % 8 != 0 || cin <= 0 || B <= 0 || H <= 0 || W <= 0 || sms <= 0) return false;
  int co_t = 0;
  for (int d = (cout < 64 ? cout : 64) / 8 * 8; d >= 8 && co_t == 0; d -= 8)
    if (cout % d == 0 && conv_layout(cin, d, 1).total <= static_cast<size_t>(kMaxConvSmem)) co_t = d;
  if (co_t == 0) return false;
  if (!(conv_slab(W, cin, co_t, kSmPerSm / 3 - kBlockReserve, p) && p.mt >= 4) &&
      !conv_slab(W, cin, co_t, kSmPerSm / 2 - kBlockReserve, p))
    conv_slab(W, cin, co_t, kMaxConvSmem, p);
  const int maxrc = (H + kConvRows - 1) / kConvRows;
  while (static_cast<long long>(B) * p.slabs * (cout / p.co_t) * maxrc < sms && p.co_t % 16 == 0)
    p.co_t /= 2;
  // strips for one wave of the blocks the SMs hold, or for two where that
  // spreads the rows more evenly: the fewer (blocks a SM) x (rows + a
  // block's start, worth about 12 rows), ties to one wave
  const long long strips = static_cast<long long>(B) * p.slabs * (cout / p.co_t);
  const int smem = static_cast<int>(conv_layout(cin, p.co_t, p.mt).total);
  const int per_sm = kSmPerSm / (smem + kBlockReserve) < 3 ? kSmPerSm / (smem + kBlockReserve) : 3;
  const long long fill = static_cast<long long>(per_sm) * sms / strips;
  const int rc1 = fill < 1 ? 1 : fill < maxrc ? static_cast<int>(fill) : maxrc;
  long long best = -1;
  for (int waves = 1; waves <= 2; ++waves) {
    const int rc = rc1 * waves < maxrc ? rc1 * waves : maxrc;
    const int rows = round_up((H + rc - 1) / rc, kConvRows);
    const long long blocks = strips * ((H + rows - 1) / rows);
    const long long cost = (blocks + sms - 1) / sms * (rows + kConvStartRows);
    if (best < 0 || cost < best) {
      best = cost;
      p.rows = rows;
    }
  }
  p.rowchunks = (H + p.rows - 1) / p.rows;
  return strips * p.rowchunks <= 0x7fffffffLL;
}

cudaError_t launch_conv3x3(const ConvArgs& a, cudaStream_t stream) {
  const size_t smem = conv_layout(a.cin, a.co_t, a.mt).total;
  if (smem > static_cast<size_t>(kMaxConvSmem)) return cudaErrorInvalidValue;
  const ConvKern kern = pick_conv(a.cin);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory, so that as many blocks
  // as fit stay resident
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(a.B) * a.slabs * a.rowchunks * (a.cout / a.co_t);
  kern<<<static_cast<int>(blocks), kConvThreads, smem, stream>>>(a);
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
// + bias (cout,) f32, or no bias when bias is null, on the launch plan of
// conv_plan for this card's SM count. Requires cout % 8 == 0 and x, w
// 16-byte aligned (checked by the wrapper too).
extern "C" int conv3x3_launch(const void* x, const void* w, const void* bias, void* y, int B,
                              int H, int W, int cin, int cout, void* stream) {
  ConvPlan p;
  if (!conv_plan(B, H, W, cin, cout, sm_count(), p)) return cudaErrorInvalidValue;
  const ConvArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                   static_cast<const float*>(bias), static_cast<bf16*>(y), B, H, W, cin, cout,
                   p.co_t, p.mt, p.sw, p.slabs, p.rows, p.rowchunks};
  return launch_conv3x3(a, static_cast<cudaStream_t>(stream));
}

// conv3x3_launch on a given plan (co_t a multiple of 8 dividing cout, <= 64;
// 1 <= mt <= 8; sw <= 16 mt; slabs * sw >= W; rows * rowchunks >= H; the
// layout within a block's shared memory): for timing other plans.
extern "C" int conv3x3_launch_plan(const void* x, const void* w, const void* bias, void* y, int B,
                                   int H, int W, int cin, int cout, int co_t, int mt, int sw,
                                   int slabs, int rows, int rowchunks, void* stream) {
  if (cout % 8 != 0 || cin <= 0 || co_t <= 0 || co_t % 8 != 0 || co_t > 64 || cout % co_t != 0 ||
      mt < 1 || mt > 8 || sw < 1 || sw > 16 * mt || static_cast<long long>(slabs) * sw < W ||
      rows < 1 || static_cast<long long>(rows) * rowchunks < H || B <= 0)
    return cudaErrorInvalidValue;
  const ConvArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                   static_cast<const float*>(bias), static_cast<bf16*>(y), B, H, W, cin, cout,
                   co_t, mt, sw, slabs, rows, rowchunks};
  return launch_conv3x3(a, static_cast<cudaStream_t>(stream));
}

// The plan conv3x3_launch takes for a shape on `sms` SMs, into out[6]:
// co_t, mt, sw, slabs, rows, rowchunks; returns 0, or an error where no
// plan fits.
extern "C" int conv3x3_plan(int B, int H, int W, int cin, int cout, int sms, int* out) {
  ConvPlan p;
  if (!conv_plan(B, H, W, cin, cout, sms, p)) return cudaErrorInvalidValue;
  const int v[6] = {p.co_t, p.mt, p.sw, p.slabs, p.rows, p.rowchunks};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
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
