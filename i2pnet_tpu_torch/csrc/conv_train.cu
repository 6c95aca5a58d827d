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
// (b): an implicit GEMM with M = 9 taps x 16 input channels, N = co_t output
// channels, K = pixels. Blocks run in no order on the card, so the TPU
// kernel's sequential accumulation over its grid becomes a split: block
// (chunk, ci tile, co tile) walks a fixed run of 8x16-pixel tiles, each warp
// one 16-pixel tile row, summing in registers; the warps' sums are added in
// warp order in shared memory and written as the chunk's partial; a second
// launch sums the partials in chunk order. No atomics: a repeated call is
// bit-identical. Both operands are staged channel-major ([channel][pixel])
// so that an mma fragment's pixel pairs are adjacent.

#include "common.cuh"

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

constexpr int kDwTH = 8, kDwTW = 16;                 // pixel tile; warp w takes row w
constexpr int kDwHalo = (kDwTH + 2) * (kDwTW + 2);  // 180 input pixels
// shared-memory row strides (bf16) of one channel: 92 and 68 words, so the
// 8 channel rows x 4 pixel pairs of an mma fragment load hit 32 banks
constexpr int kXs = 184;
constexpr int kGs = 136;

template <int NT>  // output channels per block: co_t = 8 * NT
__global__ void __launch_bounds__(kWarps * 32)
conv_dw_partial_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                       float* __restrict__ partial, int B, int H, int W, int cin, int cout,
                       int tiles_per_block) {
  constexpr int co_t = 8 * NT;
  __shared__ __align__(16) uint16_t xs[16 * kXs];    // [ci][halo pixel]
  __shared__ __align__(16) uint16_t gs[co_t * kGs];  // [co][pixel]
  __shared__ float red[9 * 16 * co_t];               // [tap][ci][co]
  const int ci0 = blockIdx.y * 16, co0 = blockIdx.z * co_t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int tiles_h = (H + kDwTH - 1) / kDwTH, tiles_w = (W + kDwTW - 1) / kDwTW;
  const int ntiles = B * tiles_h * tiles_w;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(ntiles, t_begin + tiles_per_block);
  const bool vec = cin % 8 == 0;

  float acc[9][NT][4] = {};
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int b = tile / (tiles_h * tiles_w);
    const int r0 = (tile / tiles_w) % tiles_h * kDwTH, c0 = tile % tiles_w * kDwTW;
    __syncthreads();  // the previous tile's fragments are read
    for (int i = threadIdx.x; i < kDwHalo * 2; i += blockDim.x) {
      const int grp = i & 1, p = i >> 1;
      const int gr = r0 - 1 + p / (kDwTW + 2), gc = c0 - 1 + p % (kDwTW + 2);
      const int c = ci0 + grp * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr >= 0 && gr < H && gc >= 0 && gc < W)
        v = load8(x + ((static_cast<size_t>(b) * H + gr) * W + gc) * cin + c, vec, cin - c);
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) xs[(grp * 8 + j) * kXs + p] = e[j];
    }
    for (int i = threadIdx.x; i < kDwTH * kDwTW * NT; i += blockDim.x) {
      const int grp = i % NT, p = i / NT;
      const int gr = r0 + p / kDwTW, gc = c0 + p % kDwTW;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr < H && gc < W)
        v = *reinterpret_cast<const uint4*>(g + ((static_cast<size_t>(b) * H + gr) * W + gc) * cout +
                                            co0 + grp * 8);
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) gs[(grp * 8 + j) * kGs + p] = e[j];
    }
    __syncthreads();

    // A[m = ci][k = pixel] is x shifted by the tap, B[k = pixel][n = co] is g
    uint32_t bf[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint16_t* gp = gs + (nt * 8 + gq) * kGs + warp * kDwTW + 2 * t;
      bf[nt][0] = *reinterpret_cast<const uint32_t*>(gp);
      bf[nt][1] = *reinterpret_cast<const uint32_t*>(gp + 8);
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      // halo index of this row's pixel 0 under the tap; odd when kw == 1,
      // so the pixel pairs are packed from two 16-bit loads
      const int base = (warp + tap / 3) * (kDwTW + 2) + tap % 3 + 2 * t;
      uint32_t a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint16_t* xp = xs + (gq + 8 * (q & 1)) * kXs + base + 8 * (q >> 1);
        a[q] = static_cast<uint32_t>(xp[0]) | (static_cast<uint32_t>(xp[1]) << 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[tap][nt], a, bf[nt][0], bf[nt][1]);
    }
  }

  // the warps' sums, added in warp order
  for (int wv = 0; wv < kWarps; ++wv) {
    if (warp == wv) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ci = gq + 8 * (e >> 1), co = nt * 8 + 2 * t + (e & 1);
            float& r = red[(tap * 16 + ci) * co_t + co];
            r = wv == 0 ? acc[tap][nt][e] : r + acc[tap][nt][e];
          }
    }
    __syncthreads();
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * 9 * cin * cout;
  for (int i = threadIdx.x; i < 9 * 16 * co_t; i += blockDim.x) {
    const int tap = i / (16 * co_t), ci = i / co_t % 16, co = i % co_t;
    if (ci0 + ci < cin) out[(tap * cin + ci0 + ci) * cout + co0 + co] = red[i];
  }
}

// dw[i] = sum over chunks c, in order, of partial[c][i]
__global__ void conv_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                      int n, int nchunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < nchunks; ++c) s += partial[static_cast<size_t>(c) * n + i];
  dw[i] = s;
}

template <int NT>
cudaError_t launch_conv_dw(const void* x, const void* g, void* partial, void* dw, int B, int H,
                           int W, int cin, int cout, int tiles_per_block, int nchunks,
                           cudaStream_t stream) {
  const dim3 grid(nchunks, (cin + 15) / 16, cout / (8 * NT));
  conv_dw_partial_kernel<NT><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<float*>(partial), B, H, W, cin, cout, tiles_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 9 * cin * cout;
  conv_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(partial),
                                                             static_cast<float*>(dw), n, nchunks);
  return cudaGetLastError();
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

// dw (3,3,cin,cout) f32 from x (B,H,W,cin) bf16 and g (B,H,W,cout) bf16;
// partial holds nchunks x 9*cin*cout f32, chunk c covering pixel tiles
// [c * tiles_per_block, (c+1) * tiles_per_block). Two launches. Requires
// cout % 8 == 0.
extern "C" int conv_dw_launch(const void* x, const void* g, void* partial, void* dw, int B,
                              int H, int W, int cin, int cout, int tiles_per_block, int nchunks,
                              void* stream) {
  if (cout % 8 != 0 || cin <= 0 || tiles_per_block <= 0 || nchunks <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout % 16 == 0)
    return launch_conv_dw<2>(x, g, partial, dw, B, H, W, cin, cout, tiles_per_block, nchunks, s);
  return launch_conv_dw<1>(x, g, partial, dw, B, H, W, cin, cout, tiles_per_block, nchunks, s);
}
