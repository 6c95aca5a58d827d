// Shared by every kernel library under csrc/: the error-string export that
// ops/_build.py binds, and small device helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

extern "C" const char* i2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The SMs of the current device (read once).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// LeakyReLU(0.1) as the JAX package applies it.
__device__ __forceinline__ float leaky01(float x) { return x >= 0.f ? x : 0.1f * x; }

// Round a float to bf16 and back: the value a bf16 store would hold.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two floats rounded to bf16 and packed as one 32-bit register, the lower
// column in the low half (the operand layout of mma.sync).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += A (16x16, row-major bf16 fragment a) @ B (16x8, col-major fragment
// b0, b1), f32 accumulate. Fragment layouts (PTX ISA, mma.m16n8k16), with
// g = lane / 4 and t = lane % 4: a[0] rows g, cols 2t..2t+1; a[1] rows
// g+8, same cols; a[2], a[3] the same rows at cols 8+2t..; b0 k = 2t..2t+1,
// n = g; b1 k = 8+2t..; c[0..1] row g, cols 2t..2t+1; c[2..3] row g+8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global src to shared dst, asynchronously; the bytes past
// src_bytes (<= 16) are zero-filled, so src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

// 8 bytes, as cp_async16 (through L1: the .cg form takes 16 bytes only)
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, as cp_async8
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices, transposed: lane l gives the row address of
// matrix l / 8, row l % 8, and receives in r[q] matrix q's column l / 4,
// rows 2 (l % 4) and 2 (l % 4) + 1 -- the mma fragment of a K-major operand
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// four 8x8 bf16 matrices as stored: lane l gives the row address of matrix
// l / 8, row l % 8, and receives in r[q] matrix q's row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1 -- the mma fragment of a row-major A, or of
// a B held as [n][k]
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// two matrices, as ldmatrix_x4's first two (lanes 0-15 give the addresses)
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}

// The 16-bit lanes of two channels from the bytes of x: each byte of the
// result is bit 7 of the byte of x that sel's nibble names (prmt's sign
// mode: 8 + byte), so sel 0x9988 gives 0xffff in the low lane where bit 7
// of byte 0 is set and in the high lane where that of byte 1 is; 0xbbaa
// the same from bytes 2 and 3
__device__ __forceinline__ unsigned sign_lanes(unsigned x, unsigned sel) {
  unsigned r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(0u), "r"(sel));
  return r;
}

// 8 consecutive bf16 from src as one 16-byte word, zeros past the first
// `valid`: a vector load when the row is 16-byte aligned (vec, cin % 8 == 0,
// so valid is then >= 8 or <= 0), else scalar loads.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* src, bool vec, int valid) {
  if (valid <= 0) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return *reinterpret_cast<const uint4*>(src);
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = j < valid ? src[j] : __float2bfloat16_rn(0.f);
  return *reinterpret_cast<const uint4*>(v);
}
