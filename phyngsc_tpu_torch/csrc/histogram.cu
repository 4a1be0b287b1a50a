// K1: per-position symbol histogram, (R, L) uint8 symbols + (R, L) uint8
// mask -> (L, A) int32 counts of the masked (nonzero) cells' symbols < A,
// 1 <= A <= 256.
//
// Replaces phyngsc_tpu/ops/histogram.py _make_hist_kernel /
// position_histogram_pallas (:37-92). The TPU kernel walks 1024-record
// blocks in order and keeps one (L, A) accumulator resident in VMEM; here
// blocks run in parallel, so each block counts its rows into a shared-memory
// (Lc, A) tile with shared atomics and merges the tile's nonzero bins into
// the global counts with one atomicAdd each.
//
// Bound: device memory, one pass over the R*L symbol and mask bytes. The
// design streams them:
// - A block takes a contiguous run of rows, a multiple of 16, so its bytes
//   start 16-byte aligned for any L, and reads them as one flat range, 16
//   bytes of symbols and 16 of mask a load (uint4). A thread tracks the
//   position of its chunk incrementally (32-bit, no division per cell); only
//   a ragged tail of fewer than 16 bytes is read byte by byte.
// - The grid holds as many blocks as the SMs keep resident (occupancy of
//   this kernel at its tile size), so each SM has enough loads in flight;
//   fewer blocks would starve the memory system, more would only add tiles
//   to clear and merge. Blocks have 1024 threads: the same warps an SM
//   holds in half the blocks of 512, so half the tiles to clear and merge
//   (measured 10-25% faster on an H100).
// - Tile rows are A | 1 words apart, so the bank of a bin depends on its
//   position as well as its symbol: lanes of a warp that count the same
//   few symbols (DNA, skewed qualities) at different positions hit
//   different banks.
// - Where one (L, A) tile would not fit kWholeTileBytes (long reads), the
//   positions are cut into slices over blockIdx.y; a block then skips the
//   16-byte chunks that hold none of its positions, so the bytes read stay
//   near one pass.
// Integer atomics make the counts exact in any order. Aggregating a warp's
// lanes that hit one bin (__match_any_sync) before the shared atomic
// measured 2.5-3x slower on every main-path input and 1.5x on one symbol
// everywhere, and a per-warp copy of the quality tile (37 KB) does not fit,
// so each cell takes one shared atomic.
// At the main path's sizes a thread loads one or two chunks, and the time
// is the fixed cost of a block (clear, one load's latency, merge): leaving
// out the merge or the shared atomics saves under 3%.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "device.h"

namespace {

constexpr int kThreads = 1024;
constexpr int kChunk = 16;                      // bytes a thread loads at once
constexpr int kWholeTileBytes = 64 * 1024;      // one tile for all positions
constexpr int kSliceTileBytes = 200 * 1024;     // else positions in slices

// one cell at position p (then p moves on, wrapping at L)
__device__ __forceinline__ void count1(int sym, bool on, int& p, int L, int p0,
                                       int lc, int A, int stride,
                                       int32_t* tile) {
  const unsigned q = static_cast<unsigned>(p - p0);  // position in the slice
  if (on && sym < A && q < static_cast<unsigned>(lc))
    atomicAdd(&tile[q * stride + sym], 1);
  p = p + 1 == L ? 0 : p + 1;
}

// the four cells of one 32-bit word of symbols and of mask
__device__ __forceinline__ void count4(uint32_t s, uint32_t m, int& p, int L,
                                       int p0, int lc, int A, int stride,
                                       int32_t* tile) {
#pragma unroll
  for (int b = 0; b < 4; ++b)
    count1((s >> (8 * b)) & 0xFF, (m >> (8 * b)) & 0xFF, p, L, p0, lc, A,
           stride, tile);
}

// grid (row runs, position slices); the rows of block x are
// [x * rows, min(R, (x + 1) * rows)), rows a multiple of 16; R * L < 2^31
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ sym, const uint8_t* __restrict__ mask,
            int R, int L, int A, int stride, int Lc, int rows,
            int32_t* __restrict__ out) {
  extern __shared__ int32_t tile[];  // (lc, stride)
  const int p0 = blockIdx.y * Lc;
  const int lc = min(Lc, L - p0);
  for (int i = threadIdx.x; i < lc * stride; i += kThreads) tile[i] = 0;
  __syncthreads();

  const int r0 = blockIdx.x * rows;
  const unsigned b1 = static_cast<unsigned>(min(R, r0 + rows)) * L;
  constexpr unsigned step = kThreads * kChunk;
  const int pstep = static_cast<int>(step % L);
  unsigned b = static_cast<unsigned>(r0) * L + threadIdx.x * kChunk;
  int pos = static_cast<int>((threadIdx.x * kChunk) % L);  // r0 * L % L == 0
  const bool sliced = lc < L;
  for (; b < b1; b += step) {
    // does the chunk hold a position of this slice? (L >= 16 when sliced)
    int ahead = p0 - pos;
    if (ahead < 0) ahead += L;
    if (!sliced || static_cast<unsigned>(pos - p0) < static_cast<unsigned>(lc) ||
        ahead < kChunk) {
      int p = pos;
      if (b + kChunk <= b1) {
        const uint4 m = __ldg(reinterpret_cast<const uint4*>(mask + b));
        const uint4 s = __ldg(reinterpret_cast<const uint4*>(sym + b));
        if (m.x | m.y | m.z | m.w) {
          count4(s.x, m.x, p, L, p0, lc, A, stride, tile);
          count4(s.y, m.y, p, L, p0, lc, A, stride, tile);
          count4(s.z, m.z, p, L, p0, lc, A, stride, tile);
          count4(s.w, m.w, p, L, p0, lc, A, stride, tile);
        }
      } else {
        for (unsigned k = b; k < b1; ++k)
          count1(sym[k], mask[k] != 0, p, L, p0, lc, A, stride, tile);
      }
    }
    pos += pstep;
    if (pos >= L) pos -= L;
  }
  __syncthreads();

  int32_t* out0 = out + p0 * A;
  for (int i = threadIdx.x; i < lc * A; i += kThreads) {
    const int q = i / A;
    const int32_t v = tile[q * stride + (i - q * A)];
    if (v) atomicAdd(out0 + i, v);
  }
}

// Blocks of hist_kernel that an SM keeps resident at smem bytes of tile, in
// `blocks`. The opt-in to tiles over 48 KB and the occupancy query run once
// per device and tile size (one read length gives every sub-block one size).
cudaError_t blocks_per_sm(int smem, int& blocks) {
  static int last_smem[phyngsc::kMaxDevices] = {},
             last_blocks[phyngsc::kMaxDevices] = {};
  static bool opted_in[phyngsc::kMaxDevices] = {};
  const int dev = phyngsc::device_index();
  if (last_smem[dev] == smem && last_blocks[dev] > 0) {
    blocks = last_blocks[dev];
    return cudaSuccess;
  }
  if (smem > 48 * 1024 && !opted_in[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSliceTileBytes);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, hist_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  blocks = std::max(1, blocks);
  last_smem[dev] = smem;
  last_blocks[dev] = blocks;
  return cudaSuccess;
}

}  // namespace

// sym, mask (R, L) uint8, both 16-byte aligned, R * L < 2^31, 1 <= A <= 256;
// out (L, A) int32, zeroed here on the stream. Returns the first CUDA error
// of the zeroing, the set-up and the launch.
extern "C" int phyngsc_hist(const void* sym, const void* mask, int R, int L,
                            int A, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * L * A, st);
  if (err != cudaSuccess || R == 0 || L == 0) return static_cast<int>(err);
  const int stride = A | 1;
  const int64_t row_bytes = int64_t{4} * stride;
  int Lc = L;
  if (L * row_bytes > kWholeTileBytes) {
    const int64_t per = std::max<int64_t>(1, kSliceTileBytes / row_bytes);
    const int64_t slices = (L + per - 1) / per;
    Lc = static_cast<int>((L + slices - 1) / slices);
  }
  const int gy = (L + Lc - 1) / Lc;
  const int smem = static_cast<int>(Lc * row_bytes);
  int per_sm = 0;
  err = blocks_per_sm(smem, per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = per_sm * phyngsc::sm_count();
  // row runs: a multiple of 16 rows each, about resident / gy of them
  const int runs = std::max(1, resident / gy);
  int rows = (R + runs - 1) / runs;
  rows = (rows + 15) / 16 * 16;
  const int gx = (R + rows - 1) / rows;
  hist_kernel<<<dim3(gx, gy), kThreads, smem, st>>>(
      static_cast<const uint8_t*>(sym), static_cast<const uint8_t*>(mask), R,
      L, A, stride, Lc, rows, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
