// Window selection multiplicities of the projection family's PointNet
// levels: one warp per query.
//
// Replaces the TPU kernel i2pnet_tpu/ops/select_pallas.py _sel_kernel (:47,
// launched by _make_sel :140). Same function: for the query (i, j) of a
// regular grid, centred on pixel (i*qh, j*qw) of xyz (B, h2, w2, 3) f32,
// the candidates are the kh x kw window slots s = dh*kw + dw at row
// i*qh + dh - kh/2 (a row outside the grid is invalid, not clamped) and
// column (j*qw + dw - kw/2) mod w2. A slot is valid when its point is not
// zero (|q|^2 > 1e-10) and d = max((dx*dx + dy*dy) + dz*dz, 1e-10) <= dist2.
// K argmin passes over the valid slots, ties to the lowest slot, select the
// neighbours; the remaining K - hits go to the nearest hit, or to the
// sentinel slot kh*kw when there is none; an invalid centre (|c|^2 <=
// 1e-10) puts all K on the sentinel. Output m (B, out_h*out_w, kh*kw + 1)
// f32: how often each slot was selected; every row sums to K.
//
// What bounds it on the H100: the bytes, in principle. Per query it reads
// at most 135 points of a grid that stays in L2 (11 MB at 8 x 64 x 1800)
// and writes a 136-float row of m (15.7 MB at the first level). In
// practice a query is a chain of dependent steps -- its loads, the
// selection, the store -- and the earlier design's chain of K argmin
// passes, each a 5-round butterfly of two dependent shuffles, and its
// 64-bit index divisions set its pace.
//
// The design: one warp per query, 8 queries per block. Lane l holds the
// distances of slots l, l+32, ... in registers (PER of them); a valid
// centre's slots' loads all issue at once. A ballot counts the valid
// slots. With at most K of them, every valid slot is selected exactly once
// and only the nearest is needed (for the K - hits copies): one argmin, as
// two redux.sync.min (the distance bits, then the slot among the lanes that
// hold that distance). With more than K, a ballot radix select on the key
// (distance bits, slot) finds the K smallest, from the first bit in which
// the candidates differ, and stops where the candidates left are exactly
// those needed (select_k_smallest). No pass runs per selected neighbour.
// The lanes then write the m row together, one coalesced line per
// register. The TPU kernel's dw-planes and lane-padded layout serve its
// 128-lane vector unit and are not carried over.
//
// As measured (NVIDIA H100 80GB HBM3, 700.00 W, tools/torch_kernel_times.py,
// chip_smoke.py's proj forward): the first level, 28,800 queries of which
// 74% have an empty centre, takes ~13 us, of which a copy of the kernel
// that loads nothing and only writes m takes 8.5 (m's 15.7 MB and the
// launch); the other levels, 900-7,200 queries, sit at a launch and a few
// round trips (3-6 us). Slower: staging the block's m rows in shared
// memory to write them as 16-byte vectors (a barrier waits for the
// slowest warp), loading every slot before the centre is known to be
// valid (the empty centres' windows then cost L2 traffic), and 6 blocks a
// SM by launch bounds (no change).
//
// Windows of more than 255 slots (kh*kw + 1 > 256) take select_smem_kernel:
// K argmin passes (a local argmin, a 5-step shuffle argmin across the
// warp, the winner retired), each lane's slots held in shared memory (a
// warp's row of S floats) instead of registers. A slot, once selected, is
// marked taken (kTaken, above every valid distance and kInvalid), so each
// lane still scans only its own slots, no barrier is needed, and the m row
// counts the marks. The warps per block shrink with the window to keep
// the block's rows within shared memory.
//
// Exact against the plain version (ops/select_cuda.py): the distance is
// spelled with __fmul_rn/__fadd_rn so nvcc cannot contract it into FMAs,
// and the argmin keeps the lowest slot among equal distances, which the
// plain version's stable sort also does.

#include "common.cuh"

#include <climits>

namespace {

constexpr int kWarps = 8;
constexpr float kInvalid = 1e10f;
constexpr float kTaken = 2e10f;  // select_smem_kernel: a slot already selected
constexpr int kMaxSmem = 232448 - 128;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// The K smallest keys (distance bits, then the slot: ties to the lowest
// slot) among the slots with d < kInvalid, of which there are more than K:
// a radix select from the highest bit in which the candidates differ, one
// ballot a register a bit. Every candidate whose bit is 0 is below every
// one whose bit is 1: if the zeros hold at least the `need` smallest, the
// ones drop out; else the zeros are all selected. It stops where the
// candidates left are exactly the ones needed. Returns bit t set where slot
// lane + 32 t is selected.
template <int PER>
__device__ __forceinline__ unsigned select_k_smallest(const float (&d)[PER], int lane, int K) {
  unsigned cand = 0, sel = 0, all = 0xffffffffu, any = 0;
  int ncand = 0;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const bool ok = d[t] < kInvalid;
    cand |= static_cast<unsigned>(ok) << t;
    ncand += __popc(__ballot_sync(0xffffffffu, ok));
    if (ok) {
      all &= __float_as_uint(d[t]);
      any |= __float_as_uint(d[t]);
    }
  }
  const unsigned differ = __reduce_and_sync(0xffffffffu, all) ^ __reduce_or_sync(0xffffffffu, any);
  int need = K;
  // key bit 8 + i is distance bit i (bit 31, the sign, is 0); bits 7..0 the slot
  for (int bit = differ ? 39 - __clz(differ) : 7; bit >= 0 && ncand > need; --bit) {
    unsigned zero = 0;
    int zeros = 0;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const unsigned key = bit >= 8 ? __float_as_uint(d[t]) >> (bit - 8) : (lane + 32 * t) >> bit;
      const bool z = ((cand >> t) & 1u) && !(key & 1u);
      zero |= static_cast<unsigned>(z) << t;
      zeros += __popc(__ballot_sync(0xffffffffu, z));
    }
    if (zeros >= need) {
      cand = zero;
      ncand = zeros;
    } else {
      sel |= zero;
      cand &= ~zero;
      need -= zeros;
      ncand -= zeros;
    }
  }
  return sel | cand;
}

template <int PER>
__global__ void __launch_bounds__(kWarps * 32)
select_kernel(const float* __restrict__ xyz, int B, int h2, int w2, int out_h, int out_w, int qh,
              int qw, int kh, int kw, int K, float dist2, int row_blocks, float* __restrict__ m) {
  // block (b, n / kWarps): row_blocks blocks a batch row; 32-bit indices
  const int lane = threadIdx.x & 31;
  const int N = out_h * out_w;
  const int S = kh * kw, R = S + 1;
  const int b = blockIdx.x / row_blocks;
  const int n = (blockIdx.x - b * row_blocks) * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp leaves
  const int crow = (n / out_w) * qh;
  const int ccol = (n % out_w) * qw;
  const float* g = xyz + static_cast<size_t>(b) * h2 * w2 * 3;
  const float* c = g + (static_cast<size_t>(crow) * w2 + ccol) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];
  // the valid slots' distances, kInvalid elsewhere; an invalid centre
  // (the whole warp alike) selects nothing and loads no slot
  float d[PER];
#pragma unroll
  for (int t = 0; t < PER; ++t) d[t] = kInvalid;
  if (sq3(cx, cy, cz) > 1e-10f) {
    // the slots' loads all issue before any is used
    float px[PER], py[PER], pz[PER];
    bool in[PER];
    // slot s = dh * kw + dw, stepped by 32 from the lane's first: one division
    int dh = lane / kw, dw = lane - dh * kw;
    const int step_h = 32 / kw, step_w = 32 - step_h * kw;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int row = crow + dh - kh / 2;
      in[t] = lane + 32 * t < S && row >= 0 && row < h2;
      px[t] = py[t] = pz[t] = 0.f;
      if (in[t]) {
        int col = ccol + dw - kw / 2;
        if (col < 0 || col >= w2) col = (col % w2 + w2) % w2;  // the columns wrap
        const float* p = g + (static_cast<size_t>(row) * w2 + col) * 3;
        px[t] = p[0];
        py[t] = p[1];
        pz[t] = p[2];
      }
      dh += step_h;
      dw += step_w;
      if (dw >= kw) {
        dw -= kw;
        ++dh;
      }
    }
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const float dd = fmaxf(sq3(cx - px[t], cy - py[t], cz - pz[t]), 1e-10f);
      if (in[t] && sq3(px[t], py[t], pz[t]) > 1e-10f && dd <= dist2) d[t] = dd;
    }
  }
  int nvalid = 0;
#pragma unroll
  for (int t = 0; t < PER; ++t) nvalid += __popc(__ballot_sync(0xffffffffu, d[t] < kInvalid));

  // bit t of sel: slot lane + 32 t is selected. With at most K valid slots
  // every one is, once, and the K - hits copies go to the nearest (or, with
  // none, to the sentinel); with more, the K smallest keys (distance, slot)
  unsigned sel = 0;
  int fill_slot = S, fill_n = K;
  if (nvalid <= K) {
#pragma unroll
    for (int t = 0; t < PER; ++t) sel |= static_cast<unsigned>(d[t] < kInvalid) << t;
    if (nvalid > 0) {
      fill_n = K - nvalid;
      // the nearest: the least distance (non-negative floats order as
      // their bits), then the least slot among the lanes that hold it
      float best = kInvalid;
      unsigned slot = 0xffffffffu;
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        if (d[t] < best) {  // slots grow with t: a strict < keeps the lowest
          best = d[t];
          slot = lane + 32 * t;
        }
      }
      const unsigned bits = __float_as_uint(best);
      const unsigned least = __reduce_min_sync(0xffffffffu, bits);
      const unsigned mine = bits == least ? slot : 0xffffffffu;
      fill_slot = static_cast<int>(__reduce_min_sync(0xffffffffu, mine));
    }
  } else {
    fill_n = 0;
    sel = select_k_smallest<PER>(d, lane, K);
  }
  // the lanes write the row together, one coalesced line per register
  float* row = m + (static_cast<size_t>(b) * N + n) * R;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int s = lane + 32 * t;
    if (s <= S) row[s] = static_cast<float>(((sel >> t) & 1u) + (s == fill_slot ? fill_n : 0));
  }
}

// The same function for any window: lane l's slots l, l + 32, ... in a
// shared-memory row of S distances per warp, wpb warps a block.
__global__ void __launch_bounds__(kWarps * 32)
select_smem_kernel(const float* __restrict__ xyz, int B, int h2, int w2, int out_h, int out_w,
                   int qh, int qw, int kh, int kw, int K, float dist2, float* __restrict__ m) {
  extern __shared__ float rows[];
  const int lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  const int N = out_h * out_w;
  const int S = kh * kw;
  float* d = rows + static_cast<size_t>(threadIdx.x >> 5) * S;
  const long long q = static_cast<long long>(blockIdx.x) * wpb + (threadIdx.x >> 5);
  if (q >= static_cast<long long>(B) * N) return;  // the whole warp leaves
  const int b = static_cast<int>(q / N);
  const int n = static_cast<int>(q % N);
  const int crow = (n / out_w) * qh;
  const int ccol = (n % out_w) * qw;
  const float* g = xyz + static_cast<size_t>(b) * h2 * w2 * 3;
  const float* c = g + (static_cast<size_t>(crow) * w2 + ccol) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];
  const bool cvalid = sq3(cx, cy, cz) > 1e-10f;

  for (int s = lane; s < S; s += 32) {
    float v = kInvalid;
    const int dh = s / kw;
    const int row = crow + dh - kh / 2;
    if (cvalid && row >= 0 && row < h2) {
      int col = (ccol + (s - dh * kw) - kw / 2) % w2;
      if (col < 0) col += w2;
      const float* p = g + (static_cast<size_t>(row) * w2 + col) * 3;
      const float px = p[0], py = p[1], pz = p[2];
      const float dd = fmaxf(sq3(cx - px, cy - py, cz - pz), 1e-10f);
      if (sq3(px, py, pz) > 1e-10f && dd <= dist2) v = dd;
    }
    d[s] = v;
  }

  int hits = 0, nearest = S;
  if (cvalid) {
    for (int k = 0; k < K; ++k) {
      float best = kInvalid;
      int slot = INT_MAX;
      for (int s = lane; s < S; s += 32) {
        if (d[s] < best) {  // slots grow along the scan: a strict < keeps the lowest
          best = d[s];
          slot = s;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, best, off);
        const int os = __shfl_xor_sync(0xffffffffu, slot, off);
        if (od < best || (od == best && os < slot)) {
          best = od;
          slot = os;
        }
      }
      if (!(best < kInvalid)) break;  // no valid slot left, for every lane alike
      if (k == 0) nearest = slot;
      ++hits;
      if ((slot & 31) == lane) d[slot] = kTaken;  // the owning lane alone touches it
    }
  }
  const int fill_slot = cvalid ? nearest : S;
  const int fill_n = cvalid ? K - hits : K;
  float* row_out = m + q * (S + 1);
  for (int s = lane; s <= S; s += 32)
    row_out[s] = static_cast<float>((s < S && d[s] == kTaken ? 1 : 0) + (s == fill_slot ? fill_n : 0));
}

template <int PER>
cudaError_t launch(const float* xyz, int B, int h2, int w2, int out_h, int out_w, int qh, int qw,
                   int kh, int kw, int K, float dist2, float* m, cudaStream_t stream) {
  const int row_blocks = (out_h * out_w + kWarps - 1) / kWarps;
  const long long blocks = static_cast<long long>(B) * row_blocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  select_kernel<PER><<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
      xyz, B, h2, w2, out_h, out_w, qh, qw, kh, kw, K, dist2, row_blocks, m);
  return cudaGetLastError();
}

}  // namespace

// xyz: (B, h2, w2, 3) f32 contiguous; m: (B, out_h*out_w, kh*kw + 1) f32.
// (out_h - 1)*qh < h2 and (out_w - 1)*qw < w2; kh*kw + 1 <= 256 takes the
// register kernel, a larger window (up to one warp's row of kh*kw floats
// in shared memory) select_smem_kernel.
extern "C" int select_launch(const void* xyz, int B, int h2, int w2, int out_h, int out_w, int qh,
                             int qw, int kh, int kw, int K, float dist2, void* m, void* stream) {
  const auto* x = static_cast<const float*>(xyz);
  auto* o = static_cast<float*>(m);
  auto s = static_cast<cudaStream_t>(stream);
  const int per = (kh * kw + 1 + 31) / 32;
  if (B * out_h * out_w == 0) return 0;
  cudaError_t err;
  switch (per) {
    case 1: err = launch<1>(x, B, h2, w2, out_h, out_w, qh, qw, kh, kw, K, dist2, o, s); break;
    case 2: err = launch<2>(x, B, h2, w2, out_h, out_w, qh, qw, kh, kw, K, dist2, o, s); break;
    case 3: err = launch<3>(x, B, h2, w2, out_h, out_w, qh, qw, kh, kw, K, dist2, o, s); break;
    case 4: err = launch<4>(x, B, h2, w2, out_h, out_w, qh, qw, kh, kw, K, dist2, o, s); break;
    case 5: err = launch<5>(x, B, h2, w2, out_h, out_w, qh, qw, kh, kw, K, dist2, o, s); break;
    case 6: err = launch<6>(x, B, h2, w2, out_h, out_w, qh, qw, kh, kw, K, dist2, o, s); break;
    case 7: err = launch<7>(x, B, h2, w2, out_h, out_w, qh, qw, kh, kw, K, dist2, o, s); break;
    case 8: err = launch<8>(x, B, h2, w2, out_h, out_w, qh, qw, kh, kw, K, dist2, o, s); break;
    default: {
      const size_t row = sizeof(float) * static_cast<size_t>(kh) * kw;
      if (row > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
      const int wpb = static_cast<int>(kMaxSmem / row < kWarps ? kMaxSmem / row : kWarps);
      const int smem = static_cast<int>(row * wpb);
      err = cudaFuncSetAttribute(select_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) break;
      const long long queries = static_cast<long long>(B) * out_h * out_w;
      select_smem_kernel<<<static_cast<int>((queries + wpb - 1) / wpb), wpb * 32, smem, s>>>(
          x, B, h2, w2, out_h, out_w, qh, qw, kh, kw, K, dist2, o);
      err = cudaGetLastError();
    }
  }
  return static_cast<int>(err);
}
