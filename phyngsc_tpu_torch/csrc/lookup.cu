// K4: code lookup, out[r, p] = tab[tree[p], sym[r, p]] as int32, 0 where
// sym[r, p] >= A. tab is (T, A) uint16 fused entries ((len << 12) | code),
// 1 <= T, A <= 256; tree is (L,) uint8 tree ids (an id >= T reads tree
// T - 1), or none when T == 1.
//
// Replaces phyngsc_tpu/ops/lookup.py _pl_kernel / _pl_chunk /
// fused_lookup_pallas (:214-272), which the JAX encode calls on the (L, A)
// table fused_tab = tab[tree]. The TPU kernel builds an int8 one-hot
// (TR, Lc*A) tile in VMEM and multiplies it by a block-diagonal table of
// three 6/6/4-bit int8 planes, because Pallas cannot gather from VMEM. A
// Hopper thread gathers from shared memory, so the one-hot, the planes, the
// matmul and the (L, A) table are gone: every block stages the (T, A) table
// (at most 128 KB) and the tree ids (at most 64 KB) in shared memory once
// and gathers each entry from there.
//
// Bound: device memory, 1 byte in and 4 bytes out a symbol. The design:
// - The R*L symbols are one flat range, cut into spans of 512, 16 for each
//   lane of a warp. A lane reads its 16 with one 16-byte load. The warp
//   passes them through a 512-byte tile in shared memory, so that each lane
//   then looks up 4 neighbouring symbols at a time and stores their entries
//   with one 16-byte store, neighbouring lanes on neighbouring addresses
//   (each store instruction writes 512 contiguous bytes).
// - Positions are tracked per lane in 32 bits and move on by additions that
//   wrap at L (one modulo a lane when the kernel starts), so any L works,
//   also L < 16, where one span wraps several rows. The ragged tail of
//   fewer than 512 symbols is read byte by byte.
// - A block takes a contiguous run of spans, its warps in turn. A warp loads
//   its next span before it looks up the one it holds, and its first load is
//   in flight while the block stages the tables.
// - The grid is the blocks the SMs keep resident at this table size
//   (phyngsc::resident_blocks), or fewer where that would leave a warp
//   without a span; the spans are shared evenly among the blocks. Blocks
//   have 512 threads.
// Measured on an H100 against variants (tools/torch_k4_variants.py): each
// lane storing its own 16 entries, lanes 64 bytes apart, took 1.9-2.5x as
// long; 1024 or 256 threads, 4-byte loads, no early load, evict-first
// stores and a grid of whole spans a warp were within 0-23% either way.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "device.h"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kSpan = 512;  // symbols a warp takes at once, 16 a lane

__host__ __device__ constexpr unsigned pad16(unsigned bytes) {
  return (bytes + 15) & ~15u;
}

// q + d, wrapping at L (q, d < L)
__device__ __forceinline__ unsigned advance(unsigned q, unsigned d,
                                            unsigned L) {
  q += d;
  return q >= L ? q - L : q;
}

// the entry of symbol s at position q
template <bool kTrees>
__device__ __forceinline__ int32_t entry(const uint16_t* tab,
                                         const uint8_t* ids, unsigned A,
                                         unsigned q, unsigned s) {
  const unsigned row = kTrees ? ids[q] * A : 0u;
  return s < A ? tab[row + s] : 0;
}

// the entries of the 4 symbols of word w at positions q, q + 1, ...
template <bool kTrees>
__device__ __forceinline__ int4 entries4(uint32_t w, const uint16_t* tab,
                                         const uint8_t* ids, unsigned A,
                                         unsigned q, unsigned L) {
  int4 r;
  r.x = entry<kTrees>(tab, ids, A, q, w & 0xFF);
  q = advance(q, 1, L);
  r.y = entry<kTrees>(tab, ids, A, q, (w >> 8) & 0xFF);
  q = advance(q, 1, L);
  r.z = entry<kTrees>(tab, ids, A, q, (w >> 16) & 0xFF);
  q = advance(q, 1, L);
  r.w = entry<kTrees>(tab, ids, A, q, w >> 24);
  return r;
}

// shared memory: the table (T * A entries), the tree ids (L bytes, kTrees
// only), each padded to 16 bytes, then a 512-byte tile for each warp;
// n = R * L < 2^31
template <bool kTrees>
__global__ void __launch_bounds__(kThreads)
lookup_kernel(const uint8_t* __restrict__ sym,
              const uint16_t* __restrict__ tab,
              const uint8_t* __restrict__ tree, unsigned n, unsigned L,
              unsigned A, unsigned T, int32_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  const unsigned tab_bytes = pad16(2 * T * A);
  uint16_t* s_tab = reinterpret_cast<uint16_t*>(smem);
  uint8_t* s_ids = reinterpret_cast<uint8_t*>(smem) + tab_bytes;
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4* tile = reinterpret_cast<uint4*>(s_ids + (kTrees ? pad16(L) : 0)) +
                warp * 32;

  // this block's spans [sp0, sp1) of the n / kSpan whole ones
  const unsigned spans = n / kSpan;
  const unsigned sp0 = static_cast<unsigned>(
      static_cast<uint64_t>(spans) * blockIdx.x / gridDim.x);
  const unsigned sp1 = static_cast<unsigned>(
      static_cast<uint64_t>(spans) * (blockIdx.x + 1) / gridDim.x);
  const uint4* src = reinterpret_cast<const uint4*>(sym) + lane;
  unsigned sp = sp0 + warp;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (sp < sp1) v = __ldg(src + sp * 32);

  // stage the table and the tree ids (clamped to T - 1), 16 bytes at a time
  const unsigned nt = T * A;
  for (unsigned i = threadIdx.x; i < nt / 8; i += kThreads)
    smem[i] = __ldg(reinterpret_cast<const uint4*>(tab) + i);
  for (unsigned i = nt / 8 * 8 + threadIdx.x; i < nt; i += kThreads)
    s_tab[i] = tab[i];
  if (kTrees) {
    const unsigned top = (T - 1) * 0x01010101u;
    uint4* ids16 = reinterpret_cast<uint4*>(s_ids);
    for (unsigned i = threadIdx.x; i < L / 16; i += kThreads) {
      uint4 w = __ldg(reinterpret_cast<const uint4*>(tree) + i);
      w.x = __vminu4(w.x, top);
      w.y = __vminu4(w.y, top);
      w.z = __vminu4(w.z, top);
      w.w = __vminu4(w.w, top);
      ids16[i] = w;
    }
    for (unsigned i = L / 16 * 16 + threadIdx.x; i < L; i += kThreads)
      s_ids[i] = static_cast<uint8_t>(min(static_cast<unsigned>(tree[i]),
                                          T - 1));
  }
  __syncthreads();

  // the position of the lane's first symbol, and its steps: to the warp's
  // next span, and from one group of 4 symbols to the next (128 on)
  unsigned p = kTrees ? (sp * kSpan + 4 * lane) % L : 0;
  const unsigned next = kTrees ? kWarps * kSpan % L : 0;
  const unsigned group = kTrees ? 128 % L : 0;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(tile) + lane;
  for (; sp < sp1; sp += kWarps) {
    tile[lane] = v;
    __syncwarp();
    if (sp + kWarps < sp1) v = __ldg(src + (sp + kWarps) * 32);
    int4* dst = reinterpret_cast<int4*>(out + sp * kSpan) + lane;
    unsigned q = p;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[32 * j] = entries4<kTrees>(words[32 * j], s_tab, s_ids, A, q, L);
      q = advance(q, group, L);
    }
    __syncwarp();
    p = advance(p, next, L);
  }

  // the ragged tail, by the warp of the last block with the fewest spans
  const unsigned rest = spans * kSpan;
  if (rest < n && blockIdx.x == gridDim.x - 1 &&
      warp == (sp1 - sp0) % kWarps) {
    unsigned q = kTrees ? (rest + lane) % L : 0;
    const unsigned step = kTrees ? 32 % L : 0;
    for (unsigned e = rest + lane; e < n; e += 32) {
      out[e] = entry<kTrees>(s_tab, s_ids, A, q, sym[e]);
      q = advance(q, step, L);
    }
  }
}

}  // namespace

// sym (n,) uint8, the (R, L) symbols row-major, n = R * L < 2^31; tab
// (T, A) uint16; tree (L,) uint8, or null for no tree ids; all three
// 16-byte aligned; out (n,) int32. Returns the first CUDA error of the
// set-up and the launch.
extern "C" int phyngsc_lookup(const void* sym, const void* tab,
                              const void* tree, int n, int L, int A, int T,
                              void* out, void* stream) {
  if (n <= 0) return 0;
  const bool trees = tree != nullptr;
  const void* kernel =
      trees ? reinterpret_cast<const void*>(lookup_kernel<true>)
            : reinterpret_cast<const void*>(lookup_kernel<false>);
  const int smem = static_cast<int>(pad16(2u * T * A) +
                                    (trees ? pad16(L) : 0) + kWarps * kSpan);
  int per_sm = 0;
  const cudaError_t err =
      phyngsc::resident_blocks(kernel, kThreads, smem, per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int spans = n / static_cast<int>(kSpan);
  const int blocks = std::max(1, std::min(per_sm * phyngsc::sm_count(),
                                          (spans + kWarps - 1) / kWarps));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const uint8_t*>(sym);
  const auto* t = static_cast<const uint16_t*>(tab);
  auto* o = static_cast<int32_t*>(out);
  if (trees)
    lookup_kernel<true><<<blocks, kThreads, smem, st>>>(
        s, t, static_cast<const uint8_t*>(tree), n, L, A, T, o);
  else
    lookup_kernel<false><<<blocks, kThreads, smem, st>>>(s, t, nullptr, n, L,
                                                          A, T, o);
  return static_cast<int>(cudaGetLastError());
}
