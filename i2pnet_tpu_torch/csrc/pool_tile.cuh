// The tile of the pool backwards -- kernels (d) and (f) (bn_pool_train.cu)
// and the route (pool_route.cu) -- which gather, for each input pixel, the
// pooled cells of a 3x3 window (stride S, pad 1) whose window covers it, in
// tap order; and the launch helpers of (c), (e), (f) and the route.
//
// A block owns a tile of input pixels of one batch row -- TH x TW, TH = S *
// rows, TW = S * kPassCols -- and CG channel groups, and visits it in S x S
// parity passes of rows x kPassCols pixels, (row, column) parity resolved
// at compile time, so that at stride 2 a pixel visits only its 1, 2 or 4
// candidate cells. A pass has rows * 64 (pixel, group) items, rows / 4 for
// each of the block's kPoolThreads threads. The block stages the pooled
// cells that cover the tile, with their 1-cell halo: the cells from (oh0,
// ow0) on, cell_rows(rows) x NC of them.
#pragma once

#include "common.cuh"

constexpr int kPoolThreads = 256;
constexpr int kPoolMinRows = 4;
constexpr int kPoolBlocksPerSm = 2048 / kPoolThreads;

template <int S, int CG>
struct PoolTile {
  static constexpr int kPassCols = 64 / CG;
  static constexpr int TW = S * kPassCols;
  // the covering cells: a 1-cell halo on each side at stride 1; at stride 2
  // (the tile's origin even) one more row and column
  static constexpr int NC = S == 1 ? TW + 2 : kPassCols + 1;
  __host__ __device__ static constexpr int cell_rows(int rows) {
    return S == 1 ? rows + 2 : rows + 1;
  }
  // the first covering cell of a tile whose first pixel is h0 (or w0)
  __device__ static __forceinline__ int first_cell(int h0) { return S == 1 ? h0 - 1 : h0 / 2; }
  // the staged cell row of the cell (oh) with oh * S + kh - 1 == h, for the
  // pixel h = h0 + S * i + py of pass row i: the same for columns
  __device__ static __forceinline__ int cell_of(int i, int py, int kh) {
    return S == 1 ? i + 2 - kh : i + (py + 1 - kh) / 2;
  }
};

// The pass rows of a tile: halved from max_rows (at least to kPoolMinRows)
// while the grid has fewer than per_sm_x2 / 2 blocks a SM, so that small
// calls spread over the card (2 * kPoolBlocksPerSm: as many blocks as the
// SMs hold at once); rows_of_tiles is the blocks of one tile row.
inline int pool_pass_rows(int max_rows, int S, int H, long long rows_of_tiles,
                          int per_sm_x2 = 2 * kPoolBlocksPerSm) {
  const long long least = static_cast<long long>(per_sm_x2) * sm_count() / 2;
  int rows = max_rows;
  while (rows > kPoolMinRows && (H + S * rows - 1) / (S * rows) * rows_of_tiles < least)
    rows /= 2;
  return rows;
}

// Launch a pool-tile kernel: blocks in one grid dimension (the kernel takes
// column tile fastest, so that neighbouring blocks share their halos in L2),
// smem bytes of dynamic shared memory, the carveout at its most.
template <typename Kernel, typename... Args>
cudaError_t launch_pool_tiles(Kernel kern, long long blocks, int smem, cudaStream_t stream,
                              Args... args) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(blocks), kPoolThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The block's (column tile, row tile, channel chunk, batch row) from a
// one-dimensional blockIdx.x.
struct PoolBlock {
  int tx, ty, chunk, b;
  __device__ __forceinline__ PoolBlock(int tiles_x, int tiles_y, int chunks) {
    int blk = blockIdx.x;
    tx = blk % tiles_x;
    blk /= tiles_x;
    ty = blk % tiles_y;
    blk /= tiles_y;
    chunk = blk % chunks;
    b = blk / chunks;
  }
};
