// One pass of a projection-family PointNet level's dense eval chain, over
// the selected window slots only: one warp per query.
//
// Replaces no TPU kernel: i2pnet_tpu/ops/dense_window.py dense_pointnet_eval
// is plain jnp (the JAX package runs the chain as XLA ops after its
// selection kernel). On the card the port ran it op by op too: ~15 f32
// passes a layer over all (B, N, kh*kw + 1, C) slots, ~110 launches a
// level, while only the K selected slots (m > 0) of a query add anything.
//
// Function (ops/dense_level_cuda.py dense_level_pass_plain is the plain
// version): for the query (i, j) of batch row b, centred on cell
// (i*qh, j*qw), slot s = dh*kw + dw lies at row clamp(i*qh + dh - kh/2,
// 0, h2-1), column (j*qw + dw - kw/2) mod w2, and the sentinel slot kh*kw
// at cell (0, 0) (ops/projection.py window_candidates). A slot's grouped
// features are those of the level's mode: center (diff = cand - ctr, the
// warped centre, cand, |diff|, and the feature with intens), dist (|diff|)
// or diff_feature ([diff, feature]). Each layer is a bf16 Dense with f32
// accumulation, rounded to bf16, plus the bias in bf16, taken to f32; then
// (h - mean) * rstd * scale + shift and ReLU in f32, with mean and var the
// m-weighted statistics over every selected slot of the batch. A pass
// computes layers 0..layer from the grids and, by its kind, writes the
// per-batch-row sums over the selected slots of m*h (mean) or m*(h-mean)^2
// (var) of its layer -- (B, C) f32 -- or, after the last layer, the max
// over the slots with m > 0 (B, out_h, out_w, C) f32. The wrapper runs
// 2L + 1 passes a level: each layer's mean pass, then its variance pass,
// then the max; the statistics of the layers before a pass come in as
// (R, C) sums over R rows and one divisor (the batch rows' sums and
// B*N*K, or under a mesh the all-reduced means and 1).
//
// What bounds it on the H100: not the bytes or the operations at their
// peak rates. A pass reads the grids, m and the weights (at most ~30 MB at
// the first level, L2-resident) and writes (B, C) sums; its tensor-core
// work is a few GFLOP (the fourth level, which recomputes its
// 131-128-128-256 MLP, ~9 GFLOP over its 7 passes) -- ~10 us at the
// bytes' rate, ~15 at mma.sync's, where a level (the select kernel
// included) takes 0.3-0.9 ms. What does set the pace is not established:
// no profiler that reads stall reasons runs where it was measured. Two
// candidates: the chain of a
// query's dependent steps (the m row, the gather of its slots' cells, the
// layers' mma chains), and the weights, which every warp rereads through
// L1 as f32 and converts to bf16 for each query and k-step, spread over
// only 16 or 32 rows of each mma. The fourth level, with the fewest
// queries and the widest MLP, is the slowest, which fits the second.
//
// The design: one warp per query, kWarps queries in flight a block, the
// blocks of a batch row striding over its queries. The warp reads the m
// row, and a ballot compacts the slots with m > 0 (at most K of them) into
// 16-row tiles with m as the row weight; the other slots are never
// touched. It builds each selected slot's features from the grids in
// shared memory (bf16, the lane-per-row geometry, the feature channels
// lane-per-channel), then runs each layer on the tensor cores
// (mma.sync m16n8k16, A by ldmatrix from shared memory, B straight from the
// f32 weights in L1, converted to bf16 in registers), one 8-column tile at
// a time, with the epilogue in the accumulator's registers: normalise and
// store the next layer's input (bf16), or add the weighted sums (shuffles
// over the rows, then a per-warp column accumulator), or take the masked
// max. The statistics need the whole batch, so every pass recomputes the
// layers before its own instead of storing (B, N, K, C) activations. The
// per-row sums are deterministic: each block adds its warps in order, and
// the last block of a batch row to finish (found with an arrival counter
// after __threadfence, left zero) adds the blocks' partials in block order.
// The counters are per device: calls on one device must not run on two
// streams at once.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxLayers = 4;
constexpr int kMaxWidth = 256;
constexpr int NT = 4;  // 8-column tiles a layer's inner loop computes together
constexpr int kMaxPer = 8;  // m rows of up to 256 slots, 8 registers a lane

enum Mode { kDiffFeature = 0, kCenter = 1, kCenterIntens = 2, kDist = 3 };
enum Kind { kMean = 0, kVar = 1, kMax = 2 };

struct Args {
  const float* src;  // (B, h2, w2, 3): the candidates' points
  const float* cxyz;  // (B, h2, w2, 3): the warped grid, whose centre cell center mode takes
  const void* feat;  // (B, h2, w2, cf) f32 or bf16
  const float* m;  // (B, out_h*out_w, kh*kw + 1) contiguous
  long long src_s[3], cxyz_s[3], feat_s[3];  // batch, row, column strides (elements)
  int B, h2, w2, out_h, out_w, qh, qw, kh, kw, cf, feat_bf16, mode;
  int L, cin[kMaxLayers], cout[kMaxLayers];
  const float* w[kMaxLayers];  // (cout, cin) f32
  const float* bias[kMaxLayers];
  const float* scale[kMaxLayers];
  const float* shift[kMaxLayers];
  const float* mean_sum[kMaxLayers];  // (R, cout) or null
  const float* var_sum[kMaxLayers];
  int R;
  float denom, eps;
  int layer, kind;
  float* out;  // (B, cout[layer]) sums, or (B, N, cout[L-1]) for kMax
  float* work;  // (B, bpr, cout[layer]) the blocks' partial sums
  int* counters;  // (B,) arrival counters, zero between calls
  int bpr;  // blocks a batch row
};

__host__ __device__ constexpr int pad16(int c) { return (c + 15) & ~15; }

// The layers a pass computes.
__host__ __device__ inline int depth(const Args& a) { return a.kind == kMax ? a.L : a.layer + 1; }

// The row stride (bf16) of a warp's activation tiles: the widest input of
// a layer the pass computes, 8 more so that ldmatrix's rows fall on
// different banks.
__host__ __device__ inline int tile_ld(const Args& a) {
  int w = pad16(a.cin[0]);
  for (int l = 0; l + 1 < depth(a); ++l) w = w > pad16(a.cout[l]) ? w : pad16(a.cout[l]);
  return w + 8;
}

__host__ __device__ inline int stat_width(const Args& a) {
  int n = 0;
  for (int l = 0; l < depth(a); ++l) n += a.cout[l];
  return n;
}

template <int MT>
__host__ __device__ inline size_t smem_bytes(const Args& a) {
  const size_t stats = 2 * sizeof(float) * stat_width(a);
  const size_t sums = a.kind == kMax ? 0 : sizeof(float) * kWarps * a.cout[a.layer];
  const size_t warp = 32 * (sizeof(int) + sizeof(float)) + 2 * 16 * MT * tile_ld(a) * 2;
  return ((stats + sums + 15) & ~size_t(15)) + kWarps * warp;
}

__device__ __forceinline__ float to_f32(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Two consecutive weights (n, k) and (n, k+1) of a (cout, cin) f32 matrix as
// one bf16 pair, zeros past cin.
__device__ __forceinline__ uint32_t wpair(const float* row, int k, int cin) {
  const float lo = k < cin ? __ldg(row + k) : 0.f;
  const float hi = k + 1 < cin ? __ldg(row + k + 1) : 0.f;
  return pack_bf16(lo, hi);
}

template <int MT>
__global__ void __launch_bounds__(kWarps * 32) dense_level_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ROWS = 16 * MT;
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int N = a.out_h * a.out_w, S = a.kh * a.kw + 1;
  const int layers = depth(a), ld = tile_ld(a), sw = stat_width(a);
  const int csum = a.kind == kMax ? 0 : a.cout[a.layer];

  float* s_mean = reinterpret_cast<float*>(smem);
  float* s_rstd = s_mean + sw;
  float* s_sums = s_rstd + sw;  // (kWarps, csum)
  unsigned char* wbase = smem + ((2 * sizeof(float) * sw + sizeof(float) * kWarps * csum + 15) &
                                 ~size_t(15));
  unsigned char* mine = wbase + warp * (32 * (sizeof(int) + sizeof(float)) + 2 * ROWS * ld * 2);
  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(mine);
  __nv_bfloat16* buf1 = buf0 + ROWS * ld;
  int* r_slot = reinterpret_cast<int*>(buf1 + ROWS * ld);
  float* r_w = reinterpret_cast<float*>(r_slot + 32);

  // the statistics of the layers before this pass's (and its own mean in a
  // variance pass): the R rows' sums over the divisor
  {
    int off = 0;
    for (int l = 0; l < layers; ++l) {
      const int co = a.cout[l];
      const bool own = l == layers - 1 && a.kind != kMax;
      const bool has_mean = !own || a.kind == kVar, has_var = !own;
      for (int c = threadIdx.x; c < co; c += blockDim.x) {
        float mean = 0.f, rstd = 0.f;
        if (has_mean) {
          float s = 0.f;
          for (int r = 0; r < a.R; ++r) s += a.mean_sum[l][r * co + c];
          mean = s / a.denom;
        }
        if (has_var) {
          float s = 0.f;
          for (int r = 0; r < a.R; ++r) s += a.var_sum[l][r * co + c];
          rstd = 1.f / sqrtf(s / a.denom + a.eps);
        }
        s_mean[off + c] = mean;
        s_rstd[off + c] = rstd;
      }
      off += co;
    }
    for (int c = threadIdx.x; c < kWarps * csum; c += blockDim.x) s_sums[c] = 0.f;
  }
  __syncthreads();

  float* my_sums = s_sums + warp * csum;
  const long long* ss = a.src_s;
  const long long* fs = a.feat_s;
  // the m row of a query, lane l holding slots l, l + 32, ... (zeros past S
  // and past the last query)
  auto load_m = [&](int q, float (&v)[kMaxPer]) {
    const float* mrow = a.m + (static_cast<long long>(b) * N + q) * S;
#pragma unroll
    for (int p = 0; p < kMaxPer; ++p) {
      const int s = p * 32 + lane;
      v[p] = q < N && s < S ? __ldg(mrow + s) : 0.f;
    }
  };
  const int qstep = a.bpr * kWarps;
  float mv[kMaxPer];
  load_m(blockIdx.x * kWarps + warp, mv);
  for (int q = blockIdx.x * kWarps + warp; q < N; q += qstep) {
    const int qi = q / a.out_w, qj = q - qi * a.out_w;
    const int ci = qi * a.qh, cj = qj * a.qw;
    // --- the slots with m > 0, compacted in slot order
    int count = 0;
#pragma unroll
    for (int p = 0; p < kMaxPer; ++p) {
      if (p * 32 >= S) break;
      const unsigned bal = __ballot_sync(0xffffffffu, mv[p] > 0.f);
      const int pos = count + __popc(bal & ((1u << lane) - 1u));
      if (mv[p] > 0.f && pos < ROWS) {
        r_slot[pos] = p * 32 + lane;
        r_w[pos] = mv[p];
      }
      count += __popc(bal);
    }
    load_m(q + qstep, mv);  // the next query's row, in flight while this one computes
    count = count < ROWS ? count : ROWS;
    const int mt = (count + 15) >> 4, rows = 16 * mt;
    if (lane >= count && lane < rows) {
      r_slot[lane] = S - 1;
      r_w[lane] = 0.f;
    }
    __syncwarp();

    // --- the grouped features of the selected slots (bf16, zero-padded)
    const int c0 = a.cin[0], k0p = pad16(c0);
    const float* ctr = a.src + b * ss[0] + ci * ss[1] + cj * ss[2];
    auto cell = [&](int s, int& r, int& c) {
      if (s == S - 1) {
        r = 0;
        c = 0;
        return;
      }
      const int dh = s / a.kw, dw = s - dh * a.kw;
      r = min(max(ci + dh - a.kh / 2, 0), a.h2 - 1);
      c = cj + dw - a.kw / 2;
      c = ((c % a.w2) + a.w2) % a.w2;
    };
    if (lane < rows) {
      __nv_bfloat16* row = buf0 + lane * ld;
      if (lane < count) {
        int r, c;
        cell(r_slot[lane], r, c);
        const float* p = a.src + b * ss[0] + r * ss[1] + c * ss[2];
        const float px = p[0], py = p[1], pz = p[2];
        const float dx = px - ctr[0], dy = py - ctr[1], dz = pz - ctr[2];
        const float sq = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        const float dist = sq > 0.f ? sqrtf(sq) : 0.f;
        if (a.mode == kDist) {
          row[0] = __float2bfloat16_rn(dist);
        } else {
          row[0] = __float2bfloat16_rn(dx);
          row[1] = __float2bfloat16_rn(dy);
          row[2] = __float2bfloat16_rn(dz);
          if (a.mode != kDiffFeature) {
            const float* w = a.cxyz + b * a.cxyz_s[0] + ci * a.cxyz_s[1] + cj * a.cxyz_s[2];
            row[3] = __float2bfloat16_rn(w[0]);
            row[4] = __float2bfloat16_rn(w[1]);
            row[5] = __float2bfloat16_rn(w[2]);
            row[6] = __float2bfloat16_rn(px);
            row[7] = __float2bfloat16_rn(py);
            row[8] = __float2bfloat16_rn(pz);
            row[9] = __float2bfloat16_rn(dist);
          }
        }
        for (int k = c0; k < k0p; ++k) row[k] = __float2bfloat16_rn(0.f);
      } else {
        for (int k = 0; k < k0p; k += 8) *reinterpret_cast<uint4*>(row + k) = make_uint4(0, 0, 0, 0);
      }
    }
    if (a.mode == kDiffFeature || a.mode == kCenterIntens) {
      const int off = a.mode == kDiffFeature ? 3 : 10;
      for (int i = 0; i < count; ++i) {
        int r, c;
        cell(r_slot[i], r, c);
        const long long base = b * fs[0] + r * fs[1] + c * fs[2];
        for (int k = lane; k < a.cf; k += 32)
          buf0[i * ld + off + k] = __float2bfloat16_rn(to_f32(a.feat, base + k, a.feat_bf16));
      }
    }
    __syncwarp();

    // --- the layers, NT 8-column tiles at a time: their weights' loads
    // issue together and share each A fragment
    __nv_bfloat16* cur = buf0;
    __nv_bfloat16* nxt = buf1;
    int off = 0;  // the layer's first column in s_mean / s_rstd
    for (int l = 0; l < layers; ++l) {
      const int cin = a.cin[l], kp = l == 0 ? k0p : pad16(a.cout[l - 1]), co = a.cout[l];
      const bool last = l == layers - 1, own = last && a.kind != kMax;
      const float* W = a.w[l];
      for (int n0 = 0; n0 < co; n0 += 8 * NT) {
        const int nt = (co - n0) / 8 < NT ? (co - n0) / 8 : NT;
        float acc[MT][NT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < NT; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
        for (int k0 = 0; k0 < kp; k0 += 16) {
          uint32_t bf[NT][2];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            bf[j][0] = bf[j][1] = 0u;
            if (j < nt) {
              const float* wrow = W + static_cast<long long>(n0 + 8 * j + g) * cin;
              bf[j][0] = wpair(wrow, k0 + 2 * t, cin);
              bf[j][1] = wpair(wrow, k0 + 8 + 2 * t, cin);
            }
          }
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            if (mi < mt) {
              uint32_t af[4];
              ldmatrix_x4(af, cur + (mi * 16 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
#pragma unroll
              for (int j = 0; j < NT; ++j)
                if (j < nt) mma_bf16(acc[mi][j], af, bf[j][0], bf[j][1]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j >= nt) continue;
          const int c = n0 + 8 * j + 2 * t;
          const float bias0 = bf16_round(__ldg(a.bias[l] + c)),
                      bias1 = bf16_round(__ldg(a.bias[l] + c + 1));
          float v0 = 0.f, v1 = 0.f;  // own: the weighted sums; kMax's last: the max
          if (last && a.kind == kMax) v0 = v1 = -INFINITY;
          const float mean0 = s_mean[off + c], mean1 = s_mean[off + c + 1];
          const float rstd0 = s_rstd[off + c], rstd1 = s_rstd[off + c + 1];
          float sc0 = 0.f, sc1 = 0.f, sh0 = 0.f, sh1 = 0.f;
          if (!own) {
            sc0 = __ldg(a.scale[l] + c);
            sc1 = __ldg(a.scale[l] + c + 1);
            sh0 = __ldg(a.shift[l] + c);
            sh1 = __ldg(a.shift[l] + c + 1);
          }
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            if (mi < mt) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int r = mi * 16 + g + 8 * half;
                const float h0 = bf16_round(bf16_round(acc[mi][j][2 * half]) + bias0);
                const float h1 = bf16_round(bf16_round(acc[mi][j][2 * half + 1]) + bias1);
                const float wr = r_w[r];
                if (own) {
                  if (wr > 0.f) {
                    if (a.kind == kMean) {
                      v0 += h0 * wr;
                      v1 += h1 * wr;
                    } else {
                      const float d0 = h0 - mean0, d1 = h1 - mean1;
                      v0 += (d0 * d0) * wr;
                      v1 += (d1 * d1) * wr;
                    }
                  }
                  continue;
                }
                const float z0 =
                    fmaxf(__fadd_rn(__fmul_rn(__fmul_rn(h0 - mean0, rstd0), sc0), sh0), 0.f);
                const float z1 =
                    fmaxf(__fadd_rn(__fmul_rn(__fmul_rn(h1 - mean1, rstd1), sc1), sh1), 0.f);
                if (last) {
                  if (wr > 0.f) {
                    v0 = fmaxf(v0, z0);
                    v1 = fmaxf(v1, z1);
                  }
                } else {
                  *reinterpret_cast<uint32_t*>(nxt + r * ld + c) = pack_bf16(z0, z1);
                }
              }
            }
          }
          if (last) {
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              const float u0 = __shfl_xor_sync(0xffffffffu, v0, o);
              const float u1 = __shfl_xor_sync(0xffffffffu, v1, o);
              if (own) {
                v0 += u0;
                v1 += u1;
              } else {
                v0 = fmaxf(v0, u0);
                v1 = fmaxf(v1, u1);
              }
            }
            if (g == 0) {
              if (own) {
                my_sums[c] += v0;
                my_sums[c + 1] += v1;
              } else {
                float* o = a.out + (static_cast<long long>(b) * N + q) * co + c;
                *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
              }
            }
          }
        }
      }
      if (!last) {
        if (co & 8) {  // the next layer's K tile past co reads zeros
          if (lane < rows)
            *reinterpret_cast<uint4*>(nxt + lane * ld + co) = make_uint4(0, 0, 0, 0);
        }
        __nv_bfloat16* tmp = cur;
        cur = nxt;
        nxt = tmp;
        __syncwarp();
      }
      off += co;
    }
    __syncwarp();
  }
  if (a.kind == kMax) return;

  // --- the batch row's sums: the block's warps in order, then the blocks
  __syncthreads();
  float* part = a.work + (static_cast<long long>(b) * a.bpr + blockIdx.x) * csum;
  for (int c = threadIdx.x; c < csum; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += s_sums[w * csum + c];
    part[c] = s;
  }
  __threadfence();
  __syncthreads();
  __shared__ int last_block;
  if (threadIdx.x == 0) last_block = atomicAdd(&a.counters[b], 1) == a.bpr - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const float* parts = a.work + static_cast<long long>(b) * a.bpr * csum;
  for (int c = threadIdx.x; c < csum; c += blockDim.x) {
    float s = 0.f;
    for (int x = 0; x < a.bpr; ++x) s += __ldcg(parts + x * csum + c);
    a.out[b * csum + c] = s;
  }
  if (threadIdx.x == 0) a.counters[b] = 0;
}

template <int MT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<MT>(a);
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_level_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  dense_level_kernel<MT><<<dim3(a.bpr, a.B), kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One pass (Args above). rows: 16 or 32, the selected slots a query may
// have (K rounded up to 16). Every width a multiple of 8 and at most 256,
// cin[l] == cout[l-1], L <= 4 (at most ~148 KB of shared memory), a window
// of at most 255 slots (kh*kw + 1 <= 256: the m row in registers); a.work
// holds B * bpr * cout[layer] floats and a.counters B ints, zero.
extern "C" int dense_level_launch(const void* args, int rows, void* stream) {
  const auto* a = static_cast<const Args*>(args);
  auto s = static_cast<cudaStream_t>(stream);
  if (a->B == 0 || a->out_h * a->out_w == 0) return 0;
  if (a->L < 1 || a->L > kMaxLayers || a->cin[0] > kMaxWidth || a->kh * a->kw + 1 > 32 * kMaxPer)
    return cudaErrorInvalidValue;
  for (int l = 0; l < a->L; ++l)
    if (a->cout[l] % 8 || a->cout[l] > kMaxWidth || (l > 0 && a->cin[l] != a->cout[l - 1]))
      return cudaErrorInvalidValue;
  const cudaError_t err = rows > 16 ? launch<2>(*a, s) : launch<1>(*a, s);
  return static_cast<int>(err);
}
