// Farthest point sampling, one CUDA block per batch row, of any size.
//
// Replaces the TPU kernel i2pnet_tpu/ops/fps_pallas.py _fps_kernel (:27,
// launched by fps_pallas :68). Same function: start at index 0, keep each
// point's running minimum squared distance to the chosen set, pick the
// argmax, ties to the lowest index; (B, N, 3) f32 -> (B, npoint) int64.
//
// What bounds it on the H100: latency. npoint strictly sequential steps,
// each a distance update over N points and a block-wide argmax; the work
// per step is tiny (N = 8192: 8 points per thread at 1024 threads), so a
// step costs its critical path: the argmax and its barrier. Device memory
// is touched once.
//
// The design against that:
// - Thread t owns the contiguous points [t * PER, (t + 1) * PER), so lane
//   order and warp order are index order. Each thread keeps its points and
//   running distances in registers for the whole loop; a strict > over
//   increasing j keeps its lowest index among equal maxima.
// - The running distances are >= +0.0 (or +inf before a point's first
//   update), so their bit patterns order as uint32. A warp's argmax is then
//   one __reduce_max_sync (redux.sync), a __ballot_sync of the lanes that
//   hold the maximum, __ffs for the lowest such lane and one __shfl_sync
//   of its index: no 5-round shuffle chain carrying the index. Slots past
//   N hold +0.0, which never beats a real point of lower index.
// - Lane 0 of each warp writes (bits, index) into a double-buffered shared
//   array; after one __syncthreads every warp repeats redux + ballot over
//   the nwarps entries itself, so no second broadcast barrier is needed.
// - The cloud is loaded coalesced into shared memory (x, y, z planes), from
//   which each thread takes its points and every thread reads the chosen
//   centroid.
// The launcher picks the thread count per N (fps_threads): 256 threads a
// row (a thread a point up to 256 points) were the fastest or within 3% of
// it at every level of the free path on the H100 (chip_smoke.py times 128,
// 256, 512 and 1024): with no shuffle chain, a barrier across 8 warps and
// their 8-entry argmax cost less than the longer per-thread scan (32 points
// at N = 8192) adds. Measured there: 0.558 us a step over the four levels,
// 0.718 at 8192 points (1024 threads: 0.836); the earlier design -- strided
// ownership, a 5-round shuffle argmax carrying the index, 1024 threads --
// took 1.02-1.03. Slower still, and not kept: a cluster of 8 blocks per row
// exchanging winners through distributed shared memory (its barrier costs
// over 1 us a step). The first level stays the slowest: 8192 points on one
// SM cost ~12 instructions each a step.
//
// Clouds past the registers' reach -- N > 16384 points (the shared-memory
// copy, 12 N bytes) or more than 32 points a thread -- take a second
// kernel, fps_any_kernel: the same function, no size limit, simple rather
// than fast (no shipped config reaches it). Thread t owns the points t,
// t + T, t + 2T, ... (coalesced reads of the cloud, which stays in L2 and is
// read again every step); the running distances sit in shared memory while
// 4 N bytes fit (kAnySmemPoints), else in a global scratch the wrapper
// allocates. With strided ownership lane order is not index order, so the
// argmax reduces 64-bit keys (distance bits << 32 | ~index): the largest
// key is the largest distance at the lowest index.
//
// Bit-identical to the plain loop: the squared distance is
// (dx*dx + dy*dy) + dz*dz with no FMA contraction (__fmul_rn/__fadd_rn), the
// order the plain version's separate tensor ops evaluate.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kFewThreads = 256;
constexpr int kSmemPoints = 16384;    // the register kernel's cloud copy: 12 N bytes
constexpr int kAnySmemPoints = 49152; // fps_any_kernel's distances in shared memory: 4 N bytes

// lowest lane among those whose bits equal the warp's maximum (valid lanes only)
__device__ __forceinline__ int argmax_lane(unsigned bits, bool valid, unsigned& wmax) {
  wmax = __reduce_max_sync(0xffffffffu, valid ? bits : 0u);
  const unsigned hit = __ballot_sync(0xffffffffu, valid && bits == wmax);
  return __ffs(hit) - 1;
}

template <int PER, int MAXT>  // MAXT: the most threads it is launched with
__global__ void __launch_bounds__(MAXT)
fps_kernel(const float* __restrict__ xyz, int N, int npoint, long long* __restrict__ out) {
  extern __shared__ float cloud[];  // x plane, y plane, z plane: 3 * N floats
  __shared__ unsigned red_d[2][32];
  __shared__ int red_i[2][32];

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  float* sx = cloud;
  float* sy = cloud + N;
  float* sz = cloud + 2 * N;
  for (int i = threadIdx.x; i < 3 * N; i += blockDim.x) cloud[(i % 3) * N + i / 3] = p[i];
  __syncthreads();

  const int first = threadIdx.x * PER;
  float px[PER], py[PER], pz[PER], dist[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = first + j;
    const bool real = i < N;
    px[j] = real ? sx[i] : 0.f;
    py[j] = real ? sy[i] : 0.f;
    pz[j] = real ? sz[i] : 0.f;
    dist[j] = real ? INFINITY : 0.f;  // padding: +0.0, never above a real point of lower index
  }

  long long* o = out + static_cast<size_t>(b) * npoint;
  int far = 0;
  for (int it = 0; it < npoint; ++it) {
    if (threadIdx.x == 0) o[it] = far;
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    unsigned best = 0u;
    int besti = first;
#pragma unroll
    for (int j = 0; j < PER; ++j) {  // a padding slot's +0.0 stays +0.0: no bounds check
      const float dx = px[j] - cx, dy = py[j] - cy, dz = pz[j] - cz;
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      dist[j] = fminf(dist[j], d);
      const unsigned bits = __float_as_uint(dist[j]);
      if (j == 0 || bits > best) {  // strict >: the lowest index among equals
        best = bits;
        besti = first + j;
      }
    }
    unsigned wmax;
    const int src = argmax_lane(best, true, wmax);
    const int widx = __shfl_sync(0xffffffffu, besti, src);
    const int buf = it & 1;
    if (lane == 0) {
      red_d[buf][warp] = wmax;
      red_i[buf][warp] = widx;
    }
    __syncthreads();
    const bool valid = lane < nwarps;
    const int wsrc = argmax_lane(valid ? red_d[buf][lane] : 0u, valid, wmax);
    far = red_i[buf][wsrc];
  }
}

__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// Any N: strided ownership, distances in shared memory (SMEM_DIST) or in
// scratch (B, N) f32, the argmax over 64-bit (distance, ~index) keys.
template <bool SMEM_DIST>
__global__ void __launch_bounds__(kMaxThreads)
fps_any_kernel(const float* __restrict__ xyz, int N, int npoint, long long* __restrict__ out,
               float* __restrict__ scratch) {
  extern __shared__ float sdist[];  // N floats when SMEM_DIST
  __shared__ unsigned long long red[2][32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  float* dist = SMEM_DIST ? sdist : scratch + static_cast<size_t>(b) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) dist[i] = INFINITY;
  // each thread reads and writes only its own points' distances: no barrier

  long long* o = out + static_cast<size_t>(b) * npoint;
  int far = 0;
  for (int it = 0; it < npoint; ++it) {
    if (threadIdx.x == 0) o[it] = far;
    const float cx = p[3 * far], cy = p[3 * far + 1], cz = p[3 * far + 2];
    unsigned long long best = 0ull;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const float dx = p[3 * i] - cx, dy = p[3 * i + 1] - cy, dz = p[3 * i + 2] - cz;
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(dist[i], d);
      dist[i] = m;
      const unsigned long long key =
          static_cast<unsigned long long>(__float_as_uint(m)) << 32 | (~static_cast<unsigned>(i));
      best = key > best ? key : best;
    }
    best = warp_max_u64(best);
    const int buf = it & 1;
    if (lane == 0) red[buf][warp] = best;
    __syncthreads();
    best = warp_max_u64(lane < nwarps ? red[buf][lane] : 0ull);
    far = static_cast<int>(~static_cast<unsigned>(best));
  }
}

template <int PER, int MAXT>
cudaError_t launch_t(const float* xyz, int B, int N, int npoint, long long* out, int threads,
                     cudaStream_t stream) {
  const int smem = 3 * N * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(fps_kernel<PER, MAXT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fps_kernel<PER, MAXT><<<B, threads, smem, stream>>>(xyz, N, npoint, out);
  return cudaGetLastError();
}

// fewer threads allow more registers a thread, for the larger PER
template <int PER>
cudaError_t launch(const float* xyz, int B, int N, int npoint, long long* out, int threads,
                   cudaStream_t stream) {
  if (threads <= 256) return launch_t<PER, 256>(xyz, B, N, npoint, out, threads, stream);
  if (threads <= 512) return launch_t<PER, 512>(xyz, B, N, npoint, out, threads, stream);
  return launch_t<PER, kMaxThreads>(xyz, B, N, npoint, out, threads, stream);
}

// The thread count the launcher takes for N points when the caller names
// none: a point a thread up to 256 points, else 256 threads (8 warps), the
// fastest of 128-1024 at every level of the free path on the H100
// (chip_smoke.py's sweep): fewer warps make the barrier and the cross-warp
// argmax cheaper than the longer scan of each thread costs. Past 8192
// points, enough threads for 32 points each.
int fps_threads(int N) {
  const int want = N <= kFewThreads ? N : max(kFewThreads, (N + 31) / 32);
  return (want + 31) / 32 * 32;
}

}  // namespace

// xyz: (B, N, 3) f32 contiguous; out: (B, npoint) int64. threads: a
// multiple of 32 in [32, 1024], or 0 for fps_threads(N) (fps_any_kernel:
// 1024). N <= 16384 with at most 32 points a thread takes the register
// kernel; any other N fps_any_kernel, with its distances in shared memory
// for N <= kAnySmemPoints, else in scratch, (B, N) f32 (null otherwise).
extern "C" int fps_launch(const void* xyz, int B, int N, int npoint, void* out, int threads,
                          void* scratch, void* stream) {
  if (threads % 32 != 0 || threads < 0 || threads > kMaxThreads || N <= 0 || npoint <= 0 ||
      npoint > N)
    return cudaErrorInvalidValue;
  const auto* x = static_cast<const float*>(xyz);
  auto* o = static_cast<long long*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (N > kSmemPoints || (threads != 0 && N > 32 * threads)) {
    if (threads == 0) threads = kMaxThreads;
    cudaError_t err;
    if (N <= kAnySmemPoints) {
      const int smem = N * static_cast<int>(sizeof(float));
      err = cudaFuncSetAttribute(fps_any_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      fps_any_kernel<true><<<B, threads, smem, s>>>(x, N, npoint, o, nullptr);
    } else {
      if (scratch == nullptr) return cudaErrorInvalidValue;
      fps_any_kernel<false><<<B, threads, 0, s>>>(x, N, npoint, o, static_cast<float*>(scratch));
    }
    return cudaGetLastError();
  }
  if (threads == 0) threads = fps_threads(N);
  const int per = (N + threads - 1) / threads;
  if (per <= 1) return launch<1>(x, B, N, npoint, o, threads, s);
  if (per <= 2) return launch<2>(x, B, N, npoint, o, threads, s);
  if (per <= 4) return launch<4>(x, B, N, npoint, o, threads, s);
  if (per <= 8) return launch<8>(x, B, N, npoint, o, threads, s);
  if (per <= 16) return launch<16>(x, B, N, npoint, o, threads, s);
  if (per <= 32) return launch<32>(x, B, N, npoint, o, threads, s);
  return cudaErrorInvalidValue;
}
