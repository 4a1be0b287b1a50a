// K5: densify a linear substream-sequential word stream into the
// (Wmax, Sp) lane-minor plane the walks read:
//
//   out[w, s] = words[start[s] + w]   for s < S, w < sub[s], start[s] + w < n
//   out[w, s] = 0                     otherwise (past a lane's words, pad
//                                      lanes s >= S, reads past the stream)
//
// start = the exclusive prefix sum of sub, computed by the caller on the
// device.
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
// (coalesced). Row tiles loop over blockIdx.y, so any Wmax fits the grid.
//
// Untrusted input: every source index is checked against n, every output
// index against (Wmax, Sp); a corrupt table gives a plane of garbage or
// zeros, never an access out of bounds.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // threads a tile column: each thread moves 4 words

__global__ void densify_kernel(const uint32_t* __restrict__ words, int64_t n,
                               const int64_t* __restrict__ start,
                               const int32_t* __restrict__ sub, int S,
                               int Wmax, int Sp, uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[kTile][kTile + 1];  // [lane][word]
  const int s0 = blockIdx.x * kTile;
  for (int w0 = blockIdx.y * kTile; w0 < Wmax; w0 += gridDim.y * kTile) {
    const int w = w0 + threadIdx.x;
    for (int j = threadIdx.y; j < kTile; j += kRows) {
      const int s = s0 + j;
      uint32_t v = 0;
      if (s < S && w < Wmax && w < __ldg(sub + s)) {
        const int64_t src = __ldg(start + s) + w;
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

// words (n,) uint32, start (S,) int64, sub (S,) int32, out (Wmax, Sp) uint32
// with S <= Sp; every cell of out is written. Returns cudaGetLastError()
// after the launch.
extern "C" int phyngsc_densify(const void* words, int64_t n, const void* start,
                               const void* sub, int S, int Wmax, int Sp,
                               void* out, void* stream) {
  const unsigned gx = static_cast<unsigned>((Sp + kTile - 1) / kTile);
  const unsigned gy = static_cast<unsigned>(
      std::min((Wmax + kTile - 1) / kTile, 65535));
  densify_kernel<<<dim3(gx, gy), dim3(kTile, kRows), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n,
      static_cast<const int64_t*>(start), static_cast<const int32_t*>(sub), S,
      Wmax, Sp, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
