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
// What bounds it on the H100: the bytes. Per query it reads at most 135
// points of a grid that stays in L2 (11 MB at 8 x 64 x 1800) and writes a
// 136-float row of m; the argmin passes are a few hundred register
// operations. m is most of the traffic (15.7 MB at the first level).
//
// The design: one warp per query, 8 queries per block. Lane l holds the
// distances of slots l, l+32, ... in registers (PER of them), so a pass is
// a local argmin over PER values and a 5-step shuffle argmin across the
// warp; the lane that owns the winner retires it and counts it. A pass
// that finds no valid slot ends the loop for the whole warp (every later
// pass would find none). The lanes then write the m row together, one
// coalesced 128-byte line per register. The TPU kernel's dw-planes and
// lane-padded layout serve its 128-lane vector unit and are not carried
// over.
//
// Windows of more than 255 slots (kh*kw + 1 > 256) take select_smem_kernel:
// the same passes with each lane's slots held in shared memory (a warp's
// row of S floats) instead of registers. A slot, once selected, is marked
// taken (kTaken, above every valid distance and kInvalid), so each lane
// still scans only its own slots, no barrier is needed, and the m row
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

template <int PER>
__global__ void __launch_bounds__(kWarps * 32)
select_kernel(const float* __restrict__ xyz, int B, int h2, int w2, int out_h, int out_w, int qh,
              int qw, int kh, int kw, int K, float dist2, float* __restrict__ m) {
  const int lane = threadIdx.x & 31;
  const int N = out_h * out_w;
  const long long q = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (q >= static_cast<long long>(B) * N) return;  // the whole warp leaves
  const int b = static_cast<int>(q / N);
  const int n = static_cast<int>(q % N);
  const int crow = (n / out_w) * qh;
  const int ccol = (n % out_w) * qw;
  const int S = kh * kw;
  const float* g = xyz + static_cast<size_t>(b) * h2 * w2 * 3;
  const float* c = g + (static_cast<size_t>(crow) * w2 + ccol) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];
  const bool cvalid = sq3(cx, cy, cz) > 1e-10f;

  float d[PER];
  int cnt[PER];
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    cnt[t] = 0;
    d[t] = kInvalid;
    const int s = lane + 32 * t;
    if (!cvalid || s >= S) continue;
    const int dh = s / kw;
    const int row = crow + dh - kh / 2;
    if (row < 0 || row >= h2) continue;
    int col = (ccol + (s - dh * kw) - kw / 2) % w2;
    if (col < 0) col += w2;
    const float* p = g + (static_cast<size_t>(row) * w2 + col) * 3;
    const float px = p[0], py = p[1], pz = p[2];
    const float dd = fmaxf(sq3(cx - px, cy - py, cz - pz), 1e-10f);
    if (sq3(px, py, pz) > 1e-10f && dd <= dist2) d[t] = dd;
  }

  int hits = 0, nearest = S;
  if (cvalid) {
    for (int k = 0; k < K; ++k) {
      float best = kInvalid;
      int slot = INT_MAX;
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        if (d[t] < best) {  // slots grow with t: a strict < keeps the lowest
          best = d[t];
          slot = lane + 32 * t;
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
      if ((slot & 31) == lane) {
#pragma unroll
        for (int t = 0; t < PER; ++t) {
          if (t == (slot >> 5)) {
            d[t] = kInvalid;
            ++cnt[t];
          }
        }
      }
    }
  }
  // copy fill: the nearest hit (or the sentinel) takes the rest of the K
  const int fill_slot = cvalid ? nearest : S;
  const int fill_n = cvalid ? K - hits : K;
  float* row_out = m + q * (S + 1);
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int s = lane + 32 * t;
    if (s <= S) row_out[s] = static_cast<float>(cnt[t] + (s == fill_slot ? fill_n : 0));
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
  const long long queries = static_cast<long long>(B) * out_h * out_w;
  const int blocks = static_cast<int>((queries + kWarps - 1) / kWarps);
  select_kernel<PER><<<blocks, kWarps * 32, 0, stream>>>(xyz, B, h2, w2, out_h, out_w, qh, qw,
                                                         kh, kw, K, dist2, m);
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
