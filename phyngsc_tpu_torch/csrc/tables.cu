// K6: the decode's walk tables from nibble-packed code lengths, one block
// a tree.
//
// Replaces phyngsc_tpu/ops/bitpack.py lut_runs_device + luts_from_lens_device
// (:1081-1137), which XLA runs on the TPU (a sort by (len, sym), a cumsum of
// the Kraft widths, a scatter and a cumsum over the windows), and the host's
// two_level_luts (ops/bitpack.py), whose layout the host now computes from
// the lengths alone (ops/tables.py two_level_layout) and passes in.
//
// Input: words, T * 32 nibble words (pack_lens4_np: symbol s's length in
// bits 28 - 4 * (s % 8) of word s / 8 of its tree), then T singleton
// symbols (int32, -1 where none). Output: full, the (T, 2^lut_bits) int32
// LUTs of (len << 9) | sym, 0 past an incomplete code's end (but for a code
// of all 256 symbols, whose last entry repeats there, as the JAX package's
// cumulative sum of run deltas repeats it); packed, the
// uint16 two-level table (ops/bitpack.py two_level_luts) when k > 0: tree
// t's 2^k primaries at t << k, then blocks of 2^d entries, d = lut_bits - k.
// layout (3, T) int32: each tree's first escaped prefix, its count of
// escaped prefixes, the first one's block; blocks past `own` are the one
// shared block of escapes.
//
// Design: a thread a symbol. The canonical order needs no sort: a symbol's
// rank is the count of present symbols of shorter length plus those of its
// length with a smaller symbol, from ballots of each warp over the 16
// lengths and a scan over the 8 warps' counts in shared memory; its run
// starts at the Kraft sum of the shorter lengths plus rank * its width.
// The runs are then laid out in canonical order in shared memory and every
// window finds its run by a binary search (8 steps for 256 runs), so each
// thread writes whole neighbouring entries of the LUT and the two-level
// table: the stores coalesce and no thread walks a long run alone.
//
// Bound: bytes. A tree moves 132 bytes in and 4 * 2^lut_bits + the table's
// entries out (about 16 KB at 12 bits); at T = 36 about 0.6 MB, under a
// microsecond at 3.35 TB/s, so a launch is bound by its own latency.
//
// Untrusted input: lengths are nibbles (< 16); widths are capped at
// lut_bits as the JAX package caps them, so every run start stays below
// 256 * 2^16 and runs past the last window are dropped; the layout comes
// from the host's own computation on the same lengths, and every store is
// bounded by the sizes the wrapper allocated.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one symbol a thread
constexpr int kWarps = kThreads / 32;
constexpr int kLens = 16;
constexpr uint32_t kEscape = 0x8000u;

struct Runs {
  int start[kThreads];    // canonical position -> first window
  int32_t entry[kThreads];
  int n;                  // runs
  int end;                // the window after the last run
};

// The LUT entry of window i: the value of the last run starting at or
// before i, or 0 at and past the runs' end.
__device__ int32_t entry_at(const Runs& r, int i) {
  if (i >= r.end) return 0;
  int lo = 0, hi = r.n;  // start[0] == 0 <= i
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (r.start[mid] <= i) lo = mid; else hi = mid;
  }
  return r.entry[lo];
}

__device__ uint16_t fit15(int32_t e) {
  return static_cast<uint32_t>(e) < kEscape ? static_cast<uint16_t>(e)
                                            : static_cast<uint16_t>(kEscape);
}

__global__ void __launch_bounds__(kThreads) tables_kernel(
    const uint32_t* __restrict__ words, int n_trees, int lut_bits,
    const int32_t* __restrict__ layout, int k, int own, int n_blocks,
    int n_entries, int32_t* __restrict__ full, uint16_t* __restrict__ packed) {
  __shared__ Runs runs;
  __shared__ int warp_count[kWarps][kLens];
  __shared__ int first[kLens];   // canonical position of each length's first
  __shared__ int kraft[kLens];   // first window of each length

  const int t = blockIdx.x;
  const int s = threadIdx.x;
  const int lane = s & 31, warp = s >> 5;
  const int V = 1 << lut_bits;
  const int32_t single = static_cast<int32_t>(
      __ldg(words + static_cast<int64_t>(n_trees) * 32 + t));
  const uint32_t w = __ldg(words + static_cast<int64_t>(t) * 32 + (s >> 3));
  const int len = single >= 0 ? 0 : (w >> (28 - 4 * (s & 7))) & 0xF;

  // each warp's count of every length; my rank among my warp's same length
  int in_warp = 0;
#pragma unroll
  for (int l = 0; l < kLens; ++l) {
    const unsigned b = __ballot_sync(0xffffffffu, len == l);
    if (lane == l) warp_count[warp][l] = __popc(b);
    if (len == l) in_warp = __popc(b & ((1u << lane) - 1u));
  }
  __syncthreads();
  if (s == 0) {
    int pos = 0, win = 0;
    for (int l = 1; l < kLens; ++l) {
      int c = 0;
      for (int v = 0; v < kWarps; ++v) c += warp_count[v][l];
      first[l] = pos;
      kraft[l] = win;
      pos += c;
      win += c << (lut_bits - min(l, lut_bits));
    }
    if (single >= 0) {  // one run over every window
      runs.start[0] = 0;
      runs.entry[0] = single;
      runs.n = 1;
      runs.end = V;
    } else {  // all 256 present: no absent symbol ends the last run
      runs.n = pos;
      runs.end = pos == kThreads ? V : min(win, V);
    }
  }
  __syncthreads();
  if (len > 0) {
    int rank = in_warp;
    for (int v = 0; v < warp; ++v) rank += warp_count[v][len];
    runs.start[first[len] + rank] =
        kraft[len] + (rank << (lut_bits - min(len, lut_bits)));
    runs.entry[first[len] + rank] = (len << 9) | s;
  }
  __syncthreads();

  int32_t* lut = full + static_cast<int64_t>(t) * V;
  for (int i = s; i < V; i += kThreads) lut[i] = entry_at(runs, i);
  if (k == 0) return;

  const int d = lut_bits - k;
  const int lo = layout[t], count = layout[n_trees + t];
  const int base = layout[2 * n_trees + t];
  const int n_primary = n_trees << k;
  uint16_t* primary = packed + (static_cast<int64_t>(t) << k);
  for (int j = s; j < (1 << k); j += kThreads) {
    const int q = j - lo;
    primary[j] = q >= 0 && q < count
                     ? static_cast<uint16_t>(kEscape | min(base + q, own))
                     : fit15(entry_at(runs, j << d));
  }
  // this tree's blocks of its own: prefixes lo .. lo + mine - 1
  const int mine = max(min(count, own - base), 0);
  uint16_t* sec = packed + n_primary + (static_cast<int64_t>(base) << d);
  for (int x = s; x < (mine << d); x += kThreads)
    sec[x] = fit15(entry_at(runs, (lo << d) + x));
  if (t == 0) {  // the shared block of escapes, then the padding
    const int shared = n_primary + (own << d);
    const int used = n_primary + (n_blocks << d);
    for (int x = shared + s; x < used; x += kThreads) packed[x] = kEscape;
    for (int x = used + s; x < n_entries; x += kThreads) packed[x] = 0;
  }
}

}  // namespace

extern "C" int phyngsc_tables(const void* words, int n_trees, int lut_bits,
                              const void* layout, int k, int own, int n_blocks,
                              int n_entries, void* full, void* packed,
                              void* stream) {
  if (n_trees <= 0) return 0;
  tables_kernel<<<n_trees, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_trees, lut_bits,
      static_cast<const int32_t*>(layout), k, own, n_blocks, n_entries,
      static_cast<int32_t*>(full), static_cast<uint16_t*>(packed));
  return static_cast<int>(cudaGetLastError());
}
