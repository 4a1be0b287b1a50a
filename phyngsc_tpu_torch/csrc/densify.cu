// K5: densify a linear substream-sequential word stream into the
// (Wmax, Sp) lane-minor plane the walks read:
//
//   out[w, s] = words[start[s] + w]   for s < S, w < count[s],
//                                      0 <= start[s] + w < n
//   out[w, s] = 0                     otherwise (past a lane's words, pad
//                                      lanes s >= S, reads past the stream)
//
// The (2, S) int64 lane table holds start, the exclusive prefix sum of the
// substream table, in row 0 and count, the table itself, in row 1. The host
// computes it from the container's table, which it has already checked
// (bitpack.lane_table), and uploads it in one copy, so nothing runs on the
// device before the launch and the starts cost O(S) whatever S is.
//
// Replaces phyngsc_tpu/ops/bitpack.py _dense_rows_kernel / dense_words_pallas
// (:870-934). The TPU kernel issues one HBM->HBM DMA per lane into an
// (Sp, Wmax) plane, leaves a lane's tail holding the following lanes' words,
// and transposes afterwards (.T), because its DMA copies rows. Here the
// kernel writes the (Wmax, Sp) layout directly, and writes zeros past a
// lane's words, so the plane equals the host layout (dense_words_np) in
// every cell.
//
// Bound: device memory, a pure copy (4 bytes in, 4 bytes out a word). A lane's
// words are contiguous in the source, but neighbouring lanes are neighbouring
// columns of the plane, so the copy is a transpose. A block takes a 32-lane x
// 32-word tile: each warp reads 32 consecutive words of one lane (coalesced),
// the tile goes through shared memory (one column of padding against bank
// conflicts), and each warp writes 32 consecutive lanes of one row
// (coalesced). A block reads its 32 lanes' starts and counts into shared
// memory once and loops over its strip's row tiles; the grid holds about
// four waves of the blocks the SMs keep resident. Compared on chip_smoke's
// planes in one process, one wave was slower on tall planes (71,680 rows
// over 4 strips) and one block a tile on the widest (131,072 lanes); four
// waves were the fastest of the three, or within 10% of it, on every
// plane.
//
// Untrusted input: every source index is checked against [0, n), every output
// index against (Wmax, Sp); a corrupt table gives a plane of garbage or zeros,
// never an access out of bounds.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "device.h"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // threads a tile column: each thread moves 4 words
constexpr int kThreads = kTile * kRows;
constexpr int kBlocksPerSm = 2048 / kThreads;
constexpr int kWaves = 4;

__global__ void __launch_bounds__(kThreads)
densify_kernel(const uint32_t* __restrict__ words, int64_t n,
               const int64_t* __restrict__ lanes, int S, int Wmax, int Sp,
               uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[kTile][kTile + 1];  // [lane][word]
  __shared__ int64_t lane[2][kTile];           // [start | count][lane]
  const int s0 = blockIdx.x * kTile;
  if (threadIdx.y < 2) {
    const int s = s0 + threadIdx.x;
    lane[threadIdx.y][threadIdx.x] =
        s < S ? __ldg(lanes + int64_t{threadIdx.y} * S + s) : 0;
  }
  __syncthreads();

  for (int w0 = blockIdx.y * kTile; w0 < Wmax; w0 += gridDim.y * kTile) {
    const int w = w0 + threadIdx.x;
    for (int j = threadIdx.y; j < kTile; j += kRows) {
      uint32_t v = 0;
      if (w < lane[1][j]) {
        const int64_t src = lane[0][j] + w;
        if (src >= 0 && src < n) v = __ldg(words + src);
      }
      tile[j][threadIdx.x] = v;
    }
    __syncthreads();
    const int s = s0 + threadIdx.x;
    for (int j = threadIdx.y; j < kTile; j += kRows) {
      const int wr = w0 + j;
      if (wr < Wmax && s < Sp)
        out[static_cast<int64_t>(wr) * Sp + s] = tile[threadIdx.x][j];
    }
    __syncthreads();
  }
}

}  // namespace

// words (n,) uint32, lanes (2, S) int64, out (Wmax, Sp) uint32 with S <= Sp;
// every cell of out is written. Returns cudaGetLastError() after the launch.
extern "C" int phyngsc_densify(const void* words, int64_t n, const void* lanes,
                               int S, int Wmax, int Sp, void* out,
                               void* stream) {
  const int gx = (Sp + kTile - 1) / kTile;
  const int tiles = (Wmax + kTile - 1) / kTile;
  const int blocks = kWaves * phyngsc::sm_count() * kBlocksPerSm;
  const int gy = std::max(1, std::min({tiles, blocks / gx, 65535}));
  densify_kernel<<<dim3(gx, gy), dim3(kTile, kRows), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n,
      static_cast<const int64_t*>(lanes), S, Wmax, Sp,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
