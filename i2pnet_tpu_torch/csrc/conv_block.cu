// One eval-mode RGB-encoder block, fused: 3x3 conv (stride 1, pad 1, bf16
// inputs, f32 accumulation) -> y * scale + shift (conv bias and eval BN
// folded, f32) -> LeakyReLU(0.1) -> bf16 -> 3x3 max-pool (stride s, pad 1).
// NHWC in and out: x (B, H, W, cin) bf16, w (cout, 3, 3, cin) bf16 (OHWI),
// scale/shift (cout,) f32, out (B, Ho, Wo, cout) bf16, Ho = (H-1)/s + 1.
//
// Replaces the TPU kernel i2pnet_tpu/ops/conv_pallas.py _block_kernel (:150,
// launched by fused_conv_block :305). Its phase packing, merged (B, H, W*C)
// rows and even-w selection matmul serve the TPU's 128 lanes and are not
// carried over.
//
// What bounds it on the H100: bytes. The free forward's 15 calls (B = 8,
// 384x1280 down to 24x80) read x and write the pooled output once each,
// ~366 MB, about 0.11 ms at 3.35 TB/s; their ~50 GFLOP of bf16 products
// take ~0.05 ms on the tensor cores. Unfused, the full-resolution conv
// output would cross device memory three more times.
//
// The design: a block owns a strip of pooled output rows of one batch row,
// in a column slab of at most 128 conv pixels, and a tile of up to 64
// output channels -- all of cout in stages 1-2, so their calls read x once
// (the 64-channel calls take tiles of 32: their weights would not fit
// beside the rings otherwise).
// - The block's weights, [co][k] with k = (tap, channel), sit in shared
//   memory for the whole strip; B fragments come by ldmatrix.
// - The input rows stream through a ring of 8 shared-memory slots filled by
//   cp.async (16-byte words, zero-filled outside the image), NHWC with a
//   pitch of 8 extra channels so ldmatrix is free of bank conflicts: 4 rows
//   land while the tensor cores work on the 4 that 2 conv rows read. A
//   fragments come by ldmatrix; a tap's column shift is a row address per
//   lane. A warp item is two m16 tiles of one conv row (two independent
//   accumulator chains sharing each B fragment) by 1-4 n8 tiles.
// - cin <= 5 (the image): the ring holds the raw rows, and each iteration
//   expands the batch's new rows to 4 channels a pixel (8 for cin = 5) in
//   a ring of 4 rows. For each kh, the A row of conv pixel m at k = kw * 4
//   + ci is then the expanded row's 16 elements from 4 m: the 9 (kw, ci)
//   pairs of a kh row in one k16 step, three steps in place of nine, each
//   lane reading its fragment as 32-bit words (the windows overlap, so
//   they are not the 16-byte rows ldmatrix takes). No im2col.
// - Each conv row lands as bf16 in a ring of 4 shared-memory rows (the plain
//   version rounds to bf16 before the pool, so this is exact), -inf at
//   columns outside the image. An iteration computes 2 conv rows, then
//   pools every pooled row whose 3 conv rows are in: a thread takes 8
//   channels of a run of pooled columns (4 at stride 1, 1 at stride 2) and
//   writes 16-byte channel vectors. Two barriers an iteration (three on the
//   raw path); no row halo is computed twice within a strip.
// - The launcher cuts the rows into as many strips as fill one wave of the
//   blocks a SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// - cin not a multiple of 8 (and > 5) stages its rows by scalar loads.
// The rounding points are the plain version's: __fmul_rn, __fadd_rn,
// LeakyReLU, bf16, then the max.
//
// What bounds it in practice on the H100 (tools/torch_kernel_times.py,
// with the ring depth, the strips and the blocks a SM varied): not device
// memory -- a deeper ring changed nothing -- but each iteration's chain of
// copies issued, mma chains, barriers and pool, overlapped only by the 2-3
// other blocks a SM holds (3 at most 85 registers a thread), and the
// shared-memory traffic of the A and B fragments and the pool's reads
// (~700 bytes per conv pixel at 16 channels, against 64 of device memory).

#include "common.cuh"

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 2;       // conv rows an iteration computes
constexpr int kAhead = 6;      // input rows issued ahead of the first one in use
constexpr int kStages = kAhead + kRows;  // input-row ring: 4 rows in use, 4 in flight
constexpr int kConvSlots = kRows + 2;    // conv-row ring: the batch and the 2 rows before it
constexpr int kRawCin = 5;     // cin up to this takes the raw-row path
constexpr int kExpSlots = 4;   // raw path: expanded rows, the batch's 4 input rows
constexpr int kMaxSmem = 232448 - 128;  // dynamic shared memory a block may take

struct Args {
  const bf16* x;
  const bf16* w;
  const float* scale;
  const float* shift;
  bf16* out;
  int B, H, W, cin, cout, stride;
  int co_t, mt;        // channel tile; m16 tiles of a conv row (cw = 16 mt conv pixels)
  int pw, slabs;       // pooled columns a slab; slabs a row
  int rows, rowchunks; // pooled rows a strip; strips an image
};

// Shared-memory layout (bytes, 16-aligned sections), mirrored by
// ops/conv_cuda.py _block_smem.
struct Layout {
  int c4, kh16;      // raw path: channels of an expanded pixel (4, 8); K of a kh row
  int eslot;         // raw path: elements of an expanded row
  int kp, wpitch;    // K padded to k16 steps; weight-row pitch (bf16)
  int xpitch;        // NHWC: pixel pitch (bf16)
  int xslot, cslot;  // elements of an input slot and a conv slot
  int cpitch;        // conv-row pixel pitch (bf16)
  size_t w, in, ex, cv, ss, total;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ __device__ inline Layout layout(int cin, int co_t, int mt) {
  Layout L;
  const bool raw = cin <= kRawCin;
  const int cw = 16 * mt;
  const int cinp = round_up(cin, 16);
  L.c4 = cin <= 4 ? 4 : 8;
  L.kh16 = round_up(3 * L.c4, 16);
  L.eslot = raw ? (cw + L.kh16 / L.c4 + 1) * L.c4 : 0;
  L.kp = raw ? 3 * L.kh16 : 9 * cinp;
  L.wpitch = L.kp + 8;
  L.xpitch = cinp + 8;
  // raw: the row's elements from a 16-byte word at most 7 before the first
  // needed one, in whole words
  L.xslot = raw ? round_up((cw + 2) * cin + 14, 8) : (cw + 2) * L.xpitch;
  L.cpitch = co_t + 8;
  L.cslot = cw * L.cpitch;
  size_t o = 0;
  L.w = o;
  o += round_up(round_up(co_t, 16) * L.wpitch * 2, 16);  // rows padded to 16 for ldmatrix.x4
  L.in = o;
  o += static_cast<size_t>(kStages) * L.xslot * 2;
  L.ex = o;
  o += static_cast<size_t>(raw ? kExpSlots : 0) * L.eslot * 2;
  L.cv = o;
  o += static_cast<size_t>(kConvSlots) * L.cslot * 2;
  L.ss = o;
  o += 2 * co_t * sizeof(float);
  L.total = o;
  return L;
}

__device__ __forceinline__ uint32_t hmax2u(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Pooled row o of a slab from the conv ring: each thread takes a run of
// pooled columns of one 8-channel group -- 4 at stride 1, reading the 6
// conv columns their windows cover once per conv row; 1 at stride 2, where
// the runs measured slower (fewer threads busy for little reuse) -- and
// writes 16-byte channel vectors. Rows outside the image and the -inf
// columns never win.
template <int S>
__device__ __forceinline__ void pool_row(const bf16* cv_s, const Layout& L, int o, int r_lo, int H,
                                         int pw_n, int co_t, int cout, bf16* dst) {
  constexpr int kRun = S == 1 ? 4 : 1, kCols = S * (kRun - 1) + 3;
  const int g8s = co_t / 8;
  for (int it = threadIdx.x; it < (pw_n + kRun - 1) / kRun * g8s; it += kThreads) {
    const int j0 = it / g8s * kRun, ch = it % g8s * 8;
    const int nj = min(kRun, pw_n - j0);
    uint4 m[kRun];
#pragma unroll
    for (int q = 0; q < kRun; ++q) m[q] = make_uint4(0xff80ff80u, 0xff80ff80u, 0xff80ff80u, 0xff80ff80u);
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int cr = S * o - 1 + kh;
      if (cr < 0 || cr >= H) continue;
      const bf16* cp = cv_s + ((cr - r_lo) % kConvSlots) * L.cslot + (S * j0) * L.cpitch + ch;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (k > S * (nj - 1) + 2) break;
        const uint4 v = *reinterpret_cast<const uint4*>(cp + k * L.cpitch);
#pragma unroll
        for (int q = 0; q < kRun; ++q) {
          if (k >= S * q && k <= S * q + 2) {
            m[q].x = hmax2u(m[q].x, v.x);
            m[q].y = hmax2u(m[q].y, v.y);
            m[q].z = hmax2u(m[q].z, v.z);
            m[q].w = hmax2u(m[q].w, v.w);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRun; ++q)
      if (q < nj) *reinterpret_cast<uint4*>(dst + static_cast<size_t>(j0 + q) * cout + ch) = m[q];
  }
}

// Block (batch row, slab, strip, channel tile), RAW for cin <= 5; NGW n8
// tiles of output channels per warp item; KC 16-channel chunks of the
// input (NHWC path; 0: as many as cin takes, a loop), or on the raw path
// the channels of an expanded pixel (4 for cin <= 4, 8 for cin = 5).
template <bool RAW, int NGW, int KC>
__global__ void __launch_bounds__(kThreads, 3) conv_block_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(a.cin, a.co_t, a.mt);
  bf16* w_s = reinterpret_cast<bf16*>(smem + L.w);
  bf16* in_s = reinterpret_cast<bf16*>(smem + L.in);
  bf16* ex_s = reinterpret_cast<bf16*>(smem + L.ex);
  bf16* cv_s = reinterpret_cast<bf16*>(smem + L.cv);
  float* sc_s = reinterpret_cast<float*>(smem + L.ss);
  float* sh_s = sc_s + a.co_t;
  __shared__ int raw_at[kStages];  // raw path: pixel p of a slot's row at raw_at + p * cin

  const int cotiles = a.cout / a.co_t;
  int idx = blockIdx.x;
  const int ct = idx % cotiles;
  idx /= cotiles;
  const int rc = idx % a.rowchunks;
  idx /= a.rowchunks;
  const int sl = idx % a.slabs;
  const int b = idx / a.slabs;
  const int s = a.stride;
  const int Ho = (a.H - 1) / s + 1, Wo = (a.W - 1) / s + 1;
  const int co0 = ct * a.co_t;
  const int p0 = sl * a.pw;
  const int pw_n = min(a.pw, Wo - p0);
  const int o_begin = rc * a.rows, o_end = min(Ho, o_begin + a.rows);
  if (pw_n <= 0 || o_begin >= o_end) return;  // uniform over the block
  const int c0 = s * p0 - 1;  // the conv column of slab pixel 0
  const int cw = 16 * a.mt;
  const int r_lo = max(0, s * o_begin - 1), r_hi = min(a.H - 1, s * (o_end - 1) + 1);
  const int nconv = r_hi - r_lo + 1;
  const int cin = a.cin, cinp = round_up(cin, 16);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = cin % 8 == 0;
  const long long rowlen = static_cast<long long>(a.W) * cin;  // x elements a row

  // the weights of the tile, [co][k] (k = tap * cinp + ci, or the raw
  // path's kh * kh16 + kw * c4 + ci), zeros past cin and past 3 c4
  for (int i = threadIdx.x; i < a.co_t * (L.kp / 8); i += kThreads) {
    const int co = i / (L.kp / 8), k8 = i % (L.kp / 8) * 8;
    uint4 v;
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
    *reinterpret_cast<uint4*>(w_s + co * L.wpitch + k8) = v;
  }
  for (int i = threadIdx.x; i < a.co_t; i += kThreads) {
    sc_s[i] = a.scale[co0 + i];
    sh_s[i] = a.shift[co0 + i];
  }

  // group j: input row r_lo - 1 + j into slot j % kStages (while j < nconv +
  // 2); every thread commits every group, even empty
  auto issue = [&](int j) {
    if (j < nconv + 2) {
      bf16* xs = in_s + (j % kStages) * L.xslot;
      const int xr = r_lo - 1 + j;
      if (xr >= 0 && xr < a.H) {
        const long long rowbase = (static_cast<long long>(b) * a.H + xr) * rowlen;
        if constexpr (RAW) {
          const int pf = max(c0 - 1, 0), pl = min(c0 + cw + 1, a.W);
          const long long start = (rowbase + static_cast<long long>(pf) * cin) / 8 * 8;
          const long long end = rowbase + static_cast<long long>(pl) * cin;
          if (threadIdx.x == 0)
            raw_at[j % kStages] = (j % kStages) * L.xslot + static_cast<int>(rowbase - start);
          const int n = static_cast<int>((end - start + 7) / 8);
          for (int k = threadIdx.x; k < n; k += kThreads) {
            const long long e = start + 8LL * k;
            cp_async16(xs + 8 * k, a.x + e, static_cast<int>(min(8LL, end - e)) * 2);
          }
        } else {
          const int q8 = KC > 0 ? 2 * KC : cinp / 8;
          for (int i = threadIdx.x; i < (cw + 2) * q8; i += kThreads) {
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
        for (int i = threadIdx.x; i < L.xslot / 8; i += kThreads)
          reinterpret_cast<uint4*>(xs)[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  // raw path: group j's row, expanded to c4 channels a pixel (zeros past
  // cin and outside the image), pixel p = input column c0 - 1 + p
  auto expand = [&](int j) {
    bf16* e = ex_s + (j % kExpSlots) * L.eslot;
    const int xr = r_lo - 1 + j;
    const bool row_ok = xr >= 0 && xr < a.H;
    const uint16_t* r16 = reinterpret_cast<const uint16_t*>(in_s) + raw_at[j % kStages];
    for (int p = threadIdx.x; p < L.eslot / L.c4; p += kThreads) {
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

  const int NT = a.co_t / 8;  // n8 tiles of the channel tile
  const int ngroups = (NT + NGW - 1) / NGW;
  const int mp = (a.mt + 1) / 2;  // pairs of m16 tiles: a warp item's two tiles share B
  const int items = kRows * mp * ngroups;
  const int kcs = KC > 0 ? KC : cinp / 16;
  // ldmatrix row addresses: A (pixel, channel) and B (n, k) within a k16 step
  const int a_px = (lane & 7) + 8 * ((lane >> 3) & 1), a_ch = 8 * (lane >> 4);
  const int b_n = (lane & 7) + 8 * (lane >> 4), b_k = 8 * ((lane >> 3) & 1);
  int o_next = o_begin;  // the next pooled row to form

  for (int j = 0; j < kAhead; ++j) issue(j);
  for (int i0 = 0; i0 < nconv; i0 += kRows) {  // conv rows r_lo + i0 ..
    cp_async_wait<kAhead - kRows - 2>();  // groups <= i0 + kRows + 1 have landed
    __syncthreads();                      // ... for every thread; the last pool is done
    for (int k = 0; k < kRows; ++k) issue(i0 + kAhead + k);  // into the slots of the last batch
    if constexpr (RAW) {  // the batch's new input rows (those that were issued), expanded
      for (int j = i0 == 0 ? 0 : i0 + 2; j < min(i0 + kRows, nconv) + 2; ++j) expand(j);
      __syncthreads();
    }

    for (int item = warp; item < items; item += kWarps) {
      const int pi = item % mp, ri = i0 + item / mp % kRows, nt0 = item / (mp * kRows) * NGW;
      if (ri >= nconv) continue;  // uniform over the warp
      const bool two = 2 * pi + 1 < a.mt;  // the pair's second tile
      float acc[2][NGW][4] = {};
      // acc[t] += A_t @ B over the item's n8 tiles, B from the weights at k0
      auto mma_step = [&](const uint32_t (&a0)[4], const uint32_t (&a1)[4], int k0) {
#pragma unroll
        for (int jp = 0; jp < NGW; jp += 2) {
          if (nt0 + jp >= NT) continue;
          const bf16* wp = w_s + ((nt0 + jp) * 8 + b_n) * L.wpitch + k0 + b_k;
          if constexpr (NGW == 1) {
            uint32_t bq[2];
            ldmatrix_x2(bq, wp);
            mma_bf16(acc[0][jp], a0, bq[0], bq[1]);
            if (two) mma_bf16(acc[1][jp], a1, bq[0], bq[1]);
          } else {
            uint32_t bq[4];
            ldmatrix_x4(bq, wp);
            const bool hi = nt0 + jp + 1 < NT;
            mma_bf16(acc[0][jp], a0, bq[0], bq[1]);
            if (hi) mma_bf16(acc[0][jp + 1], a0, bq[2], bq[3]);
            if (two) {
              mma_bf16(acc[1][jp], a1, bq[0], bq[1]);
              if (hi) mma_bf16(acc[1][jp + 1], a1, bq[2], bq[3]);
            }
          }
        }
      };
      if constexpr (RAW) {
        // A[m][k] of kh row kh at k = kw * c4 + ci is the expanded row's
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
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const bf16* e = ex_s + ((ri + kh) % kExpSlots) * L.eslot;
#pragma unroll
          for (int kq = 0; kq < (3 * KC + 15) / 16; ++kq) {
            uint32_t a0[4], a1[4] = {};
            raw_frag(a0, e, 2 * pi, kq);
            if (two) raw_frag(a1, e, 2 * pi + 1, kq);
            mma_step(a0, a1, kh * ((3 * KC + 15) / 16 * 16) + 16 * kq);
          }
        }
      } else {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const bf16* xs =
              in_s + ((ri + kh) % kStages) * L.xslot + (32 * pi + a_px) * L.xpitch + a_ch;
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
            for (int cc = 0; cc < (KC > 0 ? KC : 1); ++cc) {
              for (int c2 = 0; c2 < (KC > 0 ? 1 : kcs); ++c2) {
                const int ch = 16 * (cc + c2);
                uint32_t a0[4], a1[4] = {};
                ldmatrix_x4(a0, xs + kw * L.xpitch + ch);
                if (two) ldmatrix_x4(a1, xs + (16 + kw) * L.xpitch + ch);
                mma_step(a0, a1, (kh * 3 + kw) * cinp + ch);
              }
            }
          }
        }
      }
      // epilogue: scale/shift, LeakyReLU, bf16 into the conv row's slot; -inf
      // at columns outside the image
      bf16* crow = cv_s + (ri % kConvSlots) * L.cslot;
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        if (tt == 1 && !two) break;
#pragma unroll
        for (int jn = 0; jn < NGW; ++jn) {
          const int nt = nt0 + jn;
          if (nt >= NT) continue;
          const int co = nt * 8 + 2 * t;
          const float sc0 = sc_s[co], sc1 = sc_s[co + 1], sh0 = sh_s[co], sh1 = sh_s[co + 1];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int m = (2 * pi + tt) * 16 + g + 8 * rr;
            const int gc = c0 + m;
            uint32_t v = 0xff80ff80u;
            if (gc >= 0 && gc < a.W)
              v = pack_bf16(leaky01(__fadd_rn(__fmul_rn(acc[tt][jn][2 * rr], sc0), sh0)),
                            leaky01(__fadd_rn(__fmul_rn(acc[tt][jn][2 * rr + 1], sc1), sh1)));
            *reinterpret_cast<uint32_t*>(crow + m * L.cpitch + co) = v;
          }
        }
      }
    }
    __syncthreads();  // the batch's conv rows are in

    // pool every pooled row whose last conv row is now in
    const int rl = r_lo + min(i0 + kRows, nconv) - 1;
    while (o_next < o_end && min(s * o_next + 1, a.H - 1) <= rl) {
      const int o = o_next++;
      bf16* dst = a.out + ((static_cast<size_t>(b) * Ho + o) * Wo + p0) * a.cout + co0;
      if (s == 1)
        pool_row<1>(cv_s, L, o, r_lo, a.H, pw_n, a.co_t, a.cout, dst);
      else
        pool_row<2>(cv_s, L, o, r_lo, a.H, pw_n, a.co_t, a.cout, dst);
    }
  }
  cp_async_wait<0>();
}

using Kern = void (*)(const Args);

// the kernel instance for the path (raw rows or NHWC), the n8 tiles per
// item and kc: the NHWC path's unrolled 16-channel chunks (0: a loop), or
// the raw path's channels of an expanded pixel
Kern pick(bool raw, int ngw, int kc) {
#define I2P_NGW(RAW, KC)                                                     \
  (ngw == 4 ? conv_block_kernel<RAW, 4, KC>                                  \
            : ngw == 2 ? conv_block_kernel<RAW, 2, KC> : conv_block_kernel<RAW, 1, KC>)
  if (raw) return kc == 4 ? I2P_NGW(true, 4) : I2P_NGW(true, 8);
  switch (kc) {
    case 1: return I2P_NGW(false, 1);
    case 2: return I2P_NGW(false, 2);
    case 4: return I2P_NGW(false, 4);
    default: return I2P_NGW(false, 0);
  }
#undef I2P_NGW
}

}  // namespace

// The split: channel tiles, slabs and their conv width come from
// ops/conv_cuda.py _block_plan (co_t a multiple of 8 dividing cout, <= 64;
// slabs of pw pooled columns whose conv columns fit 16 mt pixels, mt <= 8).
// The strips of pooled rows are chosen here, where the blocks a SM holds
// are known: as many strips as fill one wave of resident blocks (at least
// one per pooled row's worth of work), so no wave runs part-empty. Block
// order: channel tile fastest, then strip, slab, batch row. Requires stride
// in {1, 2}, the layout within 227 KB of shared memory, and x, w 16-byte
// aligned (checked by the wrapper too).
extern "C" int conv_block_launch(const void* x, const void* w, const void* scale,
                                 const void* shift, void* out, int B, int H, int W, int cin,
                                 int cout, int stride, int co_t, int mt, int pw, int slabs,
                                 void* stream) {
  const int Wo = (W - 1) / stride + 1, Ho = (H - 1) / stride + 1;
  const int cw_need = stride == 1 ? pw + 2 : 2 * pw + 1;
  if ((stride != 1 && stride != 2) || cin <= 0 || co_t <= 0 || co_t % 8 != 0 || co_t > 64 ||
      cout % co_t != 0 || mt < 1 || mt > 8 || cw_need > 16 * mt || slabs * pw < Wo || B <= 0 ||
      H <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = layout(cin, co_t, mt).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // n8 tiles per warp item: the fewest rounds of the 8 warps over an
  // iteration's items, each round costing its tiles; ties to the wider item
  // (fewer A loads)
  const int NT = co_t / 8;
  int ngw = 1;
  long long best_cost = -1;
  for (int n : {4, 2, 1}) {
    if (n > NT && n != 1) continue;
    const long long items = static_cast<long long>(kRows) * ((mt + 1) / 2) * ((NT + n - 1) / n);
    const long long cost = (items + kWarps - 1) / kWarps * n;
    if (best_cost < 0 || cost < best_cost) {
      ngw = n;
      best_cost = cost;
    }
  }
  // the NHWC path, unrolled over cin's 16-channel chunks where it can be;
  // the raw path by the channels of an expanded pixel
  int kc = 0;
  if (cin <= kRawCin) kc = cin <= 4 ? 4 : 8;
  else if ((cin + 15) / 16 <= 4 && (cin + 15) / 16 != 3) kc = (cin + 15) / 16;
  const Kern kern = pick(cin <= kRawCin, ngw, kc);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory, so that as many blocks
  // as fit stay resident
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long strips = static_cast<long long>(B) * slabs * (cout / co_t);
  const long long slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sm_count();
  int rowchunks = static_cast<int>(slots / strips < 1 ? 1 : slots / strips < Ho ? slots / strips : Ho);
  const int rows = (Ho + rowchunks - 1) / rowchunks;
  rowchunks = (Ho + rows - 1) / rows;
  const long long blocks = strips * rowchunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
               static_cast<const float*>(scale), static_cast<const float*>(shift),
               static_cast<bf16*>(out), B, H, W, cin, cout, stride, co_t, mt, pw, slabs, rows,
               rowchunks};
  kern<<<static_cast<int>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
