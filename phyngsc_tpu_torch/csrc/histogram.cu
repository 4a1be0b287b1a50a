// K1: per-position symbol histogram, (R, L) uint8 symbols + mask -> (L, A) int32.
//
// Replaces phyngsc_tpu/ops/histogram.py _make_hist_kernel /
// position_histogram_pallas (:37-92). The TPU kernel walks 1024-record
// blocks in order and keeps one (L, A) accumulator resident in VMEM; here
// blocks run in parallel, so each block counts its rows into a shared-memory
// (Lc, A) tile with shared atomics and merges the tile's nonzero bins into
// the global counts with one atomicAdd each.
//
// Bound: one pass over R*L symbol and mask bytes, plus shared atomics that
// contend where a position's alphabet is skewed (quality scores). Integer
// atomics make the counts exact in any order. Positions are tiled over
// blockIdx.y in Lc-wide slices that fit 40 KB of shared memory, so any
// L <= 65535 works (the TPU kernel's 1280-position ceiling was a VMEM limit).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 1024;
constexpr int kTileBytes = 40 * 1024;

__global__ void hist_kernel(const uint8_t* __restrict__ sym,
                            const uint8_t* __restrict__ mask, int64_t R,
                            int L, int A, int Lc, int32_t* __restrict__ out) {
  extern __shared__ int32_t tile[];  // (lc, A)
  const int p0 = blockIdx.y * Lc;
  const int lc = min(Lc, L - p0);
  for (int i = threadIdx.x; i < lc * A; i += blockDim.x) tile[i] = 0;
  __syncthreads();

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int64_t r1 = min(R, r0 + kRowsPerBlock);
  const int64_t n = (r1 - r0) * lc;
  for (int64_t c = threadIdx.x; c < n; c += blockDim.x) {
    const int64_t r = r0 + c / lc;
    const int p = static_cast<int>(c % lc);
    const int64_t k = r * L + p0 + p;
    if (mask[k]) {
      const int s = sym[k];
      if (s < A) atomicAdd(&tile[p * A + s], 1);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < lc * A; i += blockDim.x) {
    const int32_t v = tile[i];
    if (v) atomicAdd(&out[static_cast<int64_t>(p0) * A + i], v);
  }
}

}  // namespace

// out must be zeroed by the caller. Returns cudaGetLastError() after the
// launch.
extern "C" int phyngsc_hist(const void* sym, const void* mask, int64_t R,
                            int L, int A, void* out, void* stream) {
  const int Lc = max(1, min(L, kTileBytes / (A * 4)));
  const dim3 grid(static_cast<unsigned>((R + kRowsPerBlock - 1) / kRowsPerBlock),
                  static_cast<unsigned>((L + Lc - 1) / Lc));
  const size_t smem = static_cast<size_t>(Lc) * A * sizeof(int32_t);
  hist_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sym), static_cast<const uint8_t*>(mask), R, L,
      A, Lc, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
