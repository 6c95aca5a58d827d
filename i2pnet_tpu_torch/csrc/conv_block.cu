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
// What bounds it on the H100: the conv's multiply-adds (about 22 G MACs per
// forward of the shipped encoder at B = 8, 384x1280) and, without fusion,
// the traffic of the full-resolution conv output between the conv, the
// epilogue and the pool. Fusing keeps that intermediate in shared memory:
// each block reads its input tile once and writes only pooled values.
//
// The design: one block per (batch row, output tile of TO x TO pooled
// pixels, CO_T output channels). The block stages the input tile with a
// 2-pixel halo (the conv's and the pool's), zero outside the image, in
// shared memory as [pixel][channel] with the channels zero-padded to a
// multiple of 16 (cin = 3 becomes 16) and 8 more of padding per pixel, so
// the A-fragment words of 8 pixels fall in distinct banks. The conv is an
// implicit GEMM on bf16 tensor cores (mma.sync.m16n8k16, f32 accumulate):
// M = the conv pixels that the tile's pool windows cover, N = CO_T, K = 9
// taps x the padded channels; each warp owns 16-pixel M tiles. The weights
// sit in shared memory transposed to [co][tap][ci] (padded rows) so each
// B-fragment word is one 32-bit load. The epilogue applies scale/shift and
// LeakyReLU, rounds to bf16, writes -inf at conv positions outside the image
// (the pool's padding) into a shared [co][pixel] tile, and the block then
// pools it.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

struct Geometry {
  int TO, CH, CW, IH, IW;  // pooled tile, conv region, input region
};

__host__ __device__ inline Geometry geometry(int stride) {
  Geometry g;
  g.TO = 16 / stride;
  g.CH = g.CW = (g.TO - 1) * stride + 3;
  g.IH = g.IW = g.CH + 2;
  return g;
}

struct Smem {  // byte offsets; cinp = cin rounded up to 16
  size_t w, c, in, total;
  int cinp, ps, ws;  // padded channels; pixel stride and weight-row stride (bf16)
};

__host__ __device__ inline Smem smem_layout(int cin, int co_t, int stride) {
  const Geometry g = geometry(stride);
  Smem s;
  s.cinp = (cin + 15) / 16 * 16;
  s.ps = s.cinp + 8;
  s.ws = 9 * s.cinp + 8;
  s.w = 0;
  s.c = (sizeof(__nv_bfloat16) * co_t * s.ws + 15) / 16 * 16;
  s.in = s.c + sizeof(float) * co_t * g.CH * g.CW;
  s.total = s.in + sizeof(__nv_bfloat16) * g.IH * g.IW * s.ps;
  return s;
}

__global__ void __launch_bounds__(kWarps * 32)
conv_block_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  __nv_bfloat16* __restrict__ out, int H, int W, int cin, int cout, int stride,
                  int co_t) {
  const Geometry geo = geometry(stride);
  const Smem S = smem_layout(cin, co_t, stride);
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const int nchunk = cout / co_t;
  const int b = blockIdx.z / nchunk;
  const int co0 = (blockIdx.z % nchunk) * co_t;
  const int oh0 = blockIdx.y * geo.TO;
  const int ow0 = blockIdx.x * geo.TO;
  const int r0 = oh0 * stride - 1;  // global conv row of conv-region row 0
  const int c0 = ow0 * stride - 1;
  const int npix = geo.CH * geo.CW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem + S.w);    // [co_t][9][cinp]
  float* c_s = reinterpret_cast<float*>(smem + S.c);                    // [co_t][CH][CW]
  __nv_bfloat16* in_s = reinterpret_cast<__nv_bfloat16*>(smem + S.in);  // [IH][IW][cinp]

  // stage weights and the input tile, 8 channels (16 bytes) per step; the
  // channels past cin are zeros
  const int groups = S.cinp / 8;
  const bool vec = cin % 8 == 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < co_t * 9 * groups; i += blockDim.x) {
    const int grp = i % groups, row = i / groups;  // row = co * 9 + tap
    const __nv_bfloat16* src = w + (static_cast<size_t>(co0) * 9 + row) * cin + grp * 8;
    *reinterpret_cast<uint4*>(w_s + (row / 9) * S.ws + (row % 9) * S.cinp + grp * 8) =
        load8(src, vec, cin - grp * 8);
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < geo.IH * geo.IW * groups; i += blockDim.x) {
    const int grp = i % groups, p = i / groups;
    const int gr = r0 - 1 + p / geo.IW, gc = c0 - 1 + p % geo.IW;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      v = load8(x + ((static_cast<size_t>(b) * H + gr) * W + gc) * cin + grp * 8, vec,
                cin - grp * 8);
    *reinterpret_cast<uint4*>(in_s + p * S.ps + grp * 8) = v;
  }
  __syncthreads();

  // implicit GEMM over the conv region, 16 conv pixels per M tile
  const int ntiles = co_t / 8;
  for (int m0 = warp * 16; m0 < npix; m0 += kWarps * 16) {
    int base[2];  // input-tile pixel of this lane's two rows at tap (0, 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = min(m0 + g + 8 * r, npix - 1);  // rows past the region: computed, dropped
      base[r] = (p / geo.CW) * geo.IW + p % geo.CW;
    }
    float acc[2][4] = {};  // co_t <= 16: at most 2 n-tiles
    for (int tap = 0; tap < 9; ++tap) {
      const int shift_px = (tap / 3) * geo.IW + tap % 3;
      for (int k0 = 0; k0 < S.cinp; k0 += 16) {
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const __nv_bfloat16* ip = in_s + (base[r] + shift_px) * S.ps + k0 + 2 * t;
          a[r] = *reinterpret_cast<const uint32_t*>(ip);
          a[2 + r] = *reinterpret_cast<const uint32_t*>(ip + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          if (nt < ntiles) {
            const __nv_bfloat16* wp = w_s + (nt * 8 + g) * S.ws + tap * S.cinp + k0 + 2 * t;
            mma_bf16(acc[nt], a, *reinterpret_cast<const uint32_t*>(wp),
                     *reinterpret_cast<const uint32_t*>(wp + 8));
          }
        }
      }
    }
    // epilogue: scale/shift, LeakyReLU, bf16, -inf outside the image
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      if (nt >= ntiles) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = m0 + g + 8 * (e >> 1);
        if (p >= npix) continue;
        const int co = nt * 8 + 2 * t + (e & 1);
        const int gr = r0 + p / geo.CW, gc = c0 + p % geo.CW;
        const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
        // two roundings, as the plain version's separate multiply and add
        const float y =
            leaky01(__fadd_rn(__fmul_rn(acc[nt][e], scale[co0 + co]), shift[co0 + co]));
        c_s[co * npix + p] = inside ? bf16_round(y) : -INFINITY;
      }
    }
  }
  __syncthreads();

  // 3x3 max-pool at stride s over the conv region; channel-fastest writes
  for (int item = threadIdx.x; item < geo.TO * geo.TO * co_t; item += blockDim.x) {
    const int co = item % co_t, q = item / co_t;
    const int oh = q / geo.TO, ow = q % geo.TO;
    if (oh0 + oh >= Ho || ow0 + ow >= Wo) continue;
    const float* cp = c_s + co * npix + (oh * stride) * geo.CW + ow * stride;
    float m = -INFINITY;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) m = fmaxf(m, cp[(tap / 3) * geo.CW + tap % 3]);
    out[((static_cast<size_t>(b) * Ho + oh0 + oh) * Wo + ow0 + ow) * cout + co0 + co] =
        __float2bfloat16_rn(m);
  }
}

}  // namespace

// Requires stride in {1, 2} and cout % 8 == 0 (checked by the wrapper too).
extern "C" int conv_block_launch(const void* x, const void* w, const void* scale,
                                 const void* shift, void* out, int B, int H, int W, int cin,
                                 int cout, int stride, void* stream) {
  if ((stride != 1 && stride != 2) || cout % 8 != 0 || cin <= 0) return cudaErrorInvalidValue;
  const int co_t = cout % 16 == 0 ? 16 : 8;
  const Geometry g = geometry(stride);
  const size_t smem = smem_layout(cin, co_t, stride).total;
  cudaError_t err = cudaFuncSetAttribute(conv_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory, so that as many blocks
  // as fit stay resident (the default carveout may hold fewer)
  err = cudaFuncSetAttribute(conv_block_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const dim3 grid((Wo + g.TO - 1) / g.TO, (Ho + g.TO - 1) / g.TO, B * (cout / co_t));
  conv_block_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<__nv_bfloat16*>(out), H, W, cin, cout, stride, co_t);
  return static_cast<int>(cudaGetLastError());
}
