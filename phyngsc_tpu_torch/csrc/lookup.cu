// K4: per-position code lookup, out[r, p] = tab[p, sym[r, p]].
//
// Replaces phyngsc_tpu/ops/lookup.py _pl_kernel / _pl_chunk /
// fused_lookup_pallas (:214-272). The TPU kernel builds an int8 one-hot
// (TR, Lc*A) tile in VMEM and multiplies it by a block-diagonal table of
// three 6/6/4-bit int8 planes, because Pallas cannot gather from VMEM. A
// Hopper thread gathers from shared memory, so the one-hot, the planes and
// the matmul are gone: a block stages an (Lc, A) int32 tile of the table in
// shared memory (Lc*A*4 <= 48 KB, positions tiled over blockIdx.y so any L
// works), then each thread reads a uint8 symbol and writes the int32 entry.
// A symbol >= A gives 0, as the TPU one-hot (which matches no column) does.
//
// Bound: device memory. Each symbol costs 1 byte in and 4 bytes out; the
// table is read once per block from L2. Neighbouring threads take
// neighbouring elements of the (R, L) row-major planes, so both streams
// coalesce. About four blocks per SM each take a contiguous run of rows, so
// the table is staged once per block, not once per row tile, and the
// per-element index math stays 32-bit.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 48 * 1024;
constexpr int kBlocksPerSm = 4;   // 48 KB tiles: four blocks fit an SM
constexpr int kMaxBlocks = 132 * kBlocksPerSm;

__global__ void lookup_kernel(const uint8_t* __restrict__ sym,
                              const int32_t* __restrict__ tab, int64_t R,
                              int L, int A, int Lc, int64_t rows_per_block,
                              int32_t* __restrict__ out) {
  extern __shared__ int32_t tile[];  // (lc, A)
  const int p0 = blockIdx.y * Lc;
  const int lc = min(Lc, L - p0);
  const int64_t tab0 = static_cast<int64_t>(p0) * A;
  for (int i = threadIdx.x; i < lc * A; i += blockDim.x) tile[i] = tab[tab0 + i];
  __syncthreads();

  // this block's rows [r0, r1); the host keeps (r1 - r0) * lc < 2^31, so
  // the per-element index math is 32-bit
  const int64_t r0 = blockIdx.x * rows_per_block;
  const int64_t r1 = min(R, r0 + rows_per_block);
  if (r0 >= r1) return;
  const int n = static_cast<int>((r1 - r0) * lc);
  const uint8_t* sym0 = sym + r0 * L + p0;
  int32_t* out0 = out + r0 * L + p0;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / lc;
    const int p = e - r * lc;
    const int64_t k = static_cast<int64_t>(r) * L + p;
    const int s = sym0[k];
    out0[k] = s < A ? tile[p * A + s] : 0;
  }
}

}  // namespace

// sym (R, L) uint8, tab (L, A) int32, out (R, L) int32. Returns
// cudaGetLastError() after the launch.
extern "C" int phyngsc_lookup(const void* sym, const void* tab, int64_t R,
                              int L, int A, void* out, void* stream) {
  const int Lc = std::max(1, std::min(L, kTileBytes / (A * 4)));
  const unsigned gy = static_cast<unsigned>((L + Lc - 1) / Lc);
  // about kMaxBlocks blocks in all, each a contiguous run of rows, at
  // least 32 rows and fewer than 2^30 elements a block
  const int64_t want = std::max<int64_t>(1, kMaxBlocks / gy);
  int64_t rows = std::max<int64_t>(32, (R + want - 1) / want);
  rows = std::min<int64_t>(rows, (int64_t{1} << 30) / Lc);
  const unsigned gx = static_cast<unsigned>((R + rows - 1) / rows);
  const size_t smem = static_cast<size_t>(Lc) * A * sizeof(int32_t);
  lookup_kernel<<<dim3(gx, gy), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sym), static_cast<const int32_t*>(tab), R, L,
      A, Lc, rows, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
