// K6: the decode's walk tables from nibble-packed code lengths, for both
// streams of a sub-block in one launch, each tree spread over several blocks.
//
// Replaces phyngsc_tpu/ops/bitpack.py lut_runs_device + luts_from_lens_device
// (:1081-1137), which XLA runs on the TPU (a sort by (len, sym), a cumsum of
// the Kraft widths, a scatter and a cumsum over the windows; the JAX
// package's fused decode builds both streams' runs in one device program),
// and the host's two_level_luts (ops/bitpack.py), whose layout the host now
// computes from the lengths alone (ops/tables.py two_level_layout) and passes
// in.
//
// Input, per stream (one or two: quality, then Huffman DNA; both at
// lut_bits): words, T * 32 nibble words (pack_lens4_np: symbol s's length in
// bits 28 - 4 * (s % 8) of word s / 8 of its tree), then T singleton symbols
// (int32, -1 where none). Output: full, the (T, 2^lut_bits) int32 LUTs of
// (len << 9) | sym, 0 past an incomplete code's end (but for a code of all
// 256 symbols, whose last entry repeats there, as the JAX package's
// cumulative sum of run deltas repeats it); packed, the uint16 two-level
// table (ops/bitpack.py two_level_luts) when k > 0: tree t's 2^k primaries
// at t << k, then blocks of 2^d entries, d = lut_bits - k. layout (3, T)
// int32: each tree's first escaped prefix, its count of escaped prefixes,
// the first one's block; blocks past `own` are the one shared block of
// escapes.
//
// Design: the grid is (trees of both streams) x (chunks of a tree's window
// space), a power of two of chunks a tree, the fewest that give each thread
// 4 windows or fewer and the grid at least a block an SM, with kThreads
// windows a chunk or more: at 12 bits 4 chunks of 1,024 windows for 36 to
// 128 trees, 16 of 256 for one tree. (Compared on chip_smoke's K6 cases on
// an H100, in turns: 8 windows a thread was slower at 77-128 trees, and
// twice or four times the blocks slower at 36.) Every block ranks its
// tree's 256 symbols itself (no block waits on another): a thread a
// symbol, whose rank is the count of present symbols of shorter length
// plus those of its length with a smaller symbol, from each warp's
// __match_any_sync on the lengths and one warp's shuffle scans over the
// lengths; its run starts at the Kraft sum of the shorter lengths plus
// rank * its width. The runs are laid out in canonical order in shared
// memory. Then each thread takes neighbouring windows of the chunk: it
// finds the first one's run by a binary search in shared memory (8 steps
// for 256 runs) and steps from run to run after it, and stores the LUT
// entries (16 bytes a store), the primary where a window starts a prefix
// and the secondary entry where its prefix has a block of its own, the
// warp's stores on neighbouring addresses. The shared block of escapes and
// the padding are spread over the stream's blocks.
//
// Bound: bytes. A tree moves 132 bytes in and 4 * 2^lut_bits + the table's
// entries out (about 20 KB at 12 bits); at T = 36 about 0.75 MB, under a
// microsecond at 3.35 TB/s, so a launch is bound by its own latency and the
// ranking each block repeats (phyngsc_empty measures the launch alone).
//
// Untrusted input: lengths are nibbles (< 16); widths are capped at
// lut_bits as the JAX package caps them, so every run start stays below
// 256 * 2^16 and runs past the last window are dropped; the layout comes
// from the host's own computation on the same lengths, and every store is
// bounded by the sizes the wrapper allocated.

#include <cstdint>
#include <cuda_runtime.h>

#include "device.h"

namespace {

constexpr int kThreads = 256;  // one symbol a thread
constexpr int kWarps = kThreads / 32;
constexpr int kLens = 16;
constexpr uint32_t kEscape = 0x8000u;

struct Stream {
  const uint32_t* words;  // n_trees * 33
  const int32_t* layout;  // (3, n_trees); null when k == 0
  int32_t* full;          // (n_trees, 2^lut_bits)
  uint16_t* packed;       // n entries; null when k == 0
  int n_trees, k, own, n_blocks, n;
};

struct Params {
  Stream s[2];       // s[1].n_trees == 0 for one stream
  int lut_bits;
  int log_chunks;    // chunks a tree: 1 << log_chunks
};

struct Runs {
  int start[kThreads];    // canonical position -> first window
  int32_t entry[kThreads];
  int n;                  // runs
  int end;                // the window after the last run
};

// The run of window i: the last run starting at or before i (0 where
// there is none; its entry is not read then, past the runs' end).
__device__ int run_at(const Runs& r, int i) {
  int lo = 0, hi = r.n;  // start[0] == 0 <= i
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (r.start[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

__device__ uint16_t fit15(int32_t e) {
  return static_cast<uint32_t>(e) < kEscape ? static_cast<uint16_t>(e)
                                            : static_cast<uint16_t>(kEscape);
}

__global__ void __launch_bounds__(kThreads) tables_kernel(const Params p) {
  __shared__ Runs runs;
  // each warp's count of every length, then the count in the warps before it
  __shared__ int warp_count[kWarps][kLens];
  __shared__ int first[kLens];   // canonical position of each length's first
  __shared__ int kraft[kLens];   // first window of each length

  const int chunks = 1 << p.log_chunks;
  const int g = blockIdx.x >> p.log_chunks;  // tree over both streams
  const int c = blockIdx.x & (chunks - 1);
  const bool second = g >= p.s[0].n_trees;
  const Stream st = second ? p.s[1] : p.s[0];
  const int t = second ? g - p.s[0].n_trees : g;
  const int s = threadIdx.x;
  const int lane = s & 31, warp = s >> 5;
  const int bits = p.lut_bits;
  const int V = 1 << bits;
  const int32_t single = static_cast<int32_t>(
      __ldg(st.words + static_cast<int64_t>(st.n_trees) * 32 + t));
  const uint32_t w = __ldg(st.words + static_cast<int64_t>(t) * 32 + (s >> 3));
  const int len = single >= 0 ? 0 : (w >> (28 - 4 * (s & 7))) & 0xF;
  const int k = st.k, d = bits - k, dmask = (1 << d) - 1;
  int lo = 0, count = 0, base = 0;  // loaded before the ranking's waits
  if (k > 0) {
    lo = st.layout[t];
    count = st.layout[st.n_trees + t];
    base = st.layout[2 * st.n_trees + t];
  }

  // each warp's count of every length (its first lane of a length writes
  // it); my rank among my warp's same length
  if (lane < kLens) warp_count[warp][lane] = 0;
  __syncwarp();
  const unsigned same = __match_any_sync(0xffffffffu, len);
  const int in_warp = __popc(same & ((1u << lane) - 1u));
  if (in_warp == 0) warp_count[warp][len] = __popc(same);
  __syncthreads();
  if (warp == 0) {  // lane l: length l's total, then scans over the lengths
    int n = 0;
    if (lane > 0 && lane < kLens) {
      for (int v = 0; v < kWarps; ++v) {
        const int x = warp_count[v][lane];
        warp_count[v][lane] = n;
        n += x;
      }
    }
    const int wide = n << (bits - min(lane, bits));
    int pos = n, win = wide;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, pos, o);
      const int b = __shfl_up_sync(0xffffffffu, win, o);
      if (lane >= o) {
        pos += a;
        win += b;
      }
    }
    if (lane < kLens) {
      first[lane] = pos - n;
      kraft[lane] = win - wide;
    }
    if (lane == 31) {
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
  }
  __syncthreads();
  if (len > 0) {
    const int rank = warp_count[warp][len] + in_warp;
    runs.start[first[len] + rank] =
        kraft[len] + (rank << (bits - min(len, bits)));
    runs.entry[first[len] + rank] = (len << 9) | s;
  }
  __syncthreads();

  // this block's chunk: the LUT, the primaries and the own secondary blocks
  const int span = V >> p.log_chunks;
  const int x0 = c * span;
  int32_t* lut = st.full + static_cast<int64_t>(t) * V;
  uint16_t* primary = nullptr;
  uint16_t* sec = nullptr;
  if (k > 0) {
    primary = st.packed + (static_cast<int64_t>(t) << k);
    sec = st.packed + (static_cast<int64_t>(st.n_trees) << k);
  }
  auto two_level = [&](int x, int32_t e) {
    const int q = (x >> d) - lo;  // this prefix among the tree's escaped
    const bool escaped = q >= 0 && q < count;
    if ((x & dmask) == 0)
      primary[x >> d] = escaped ? static_cast<uint16_t>(
                                      kEscape | min(base + q, st.own))
                                : fit15(e);
    const int blk = base + q;
    if (escaped && blk >= 0 && blk < st.own)
      sec[(static_cast<int64_t>(blk) << d) + (x & dmask)] = fit15(e);
  };
  // a thread's `per` neighbouring windows (1, 2 or a multiple of 4): one
  // binary search, then a step a window (every run covers a window or
  // more, so at most one run starts at a window); 16-byte LUT stores
  const int per = max(span / kThreads, 1);
  const int xs = x0 + s * per;
  if (s * per < span) {
    int r = run_at(runs, xs);
    int32_t e = runs.entry[r];
    int next = r + 1 < runs.n ? runs.start[r + 1] : V;
    for (int j = 0; j < per; j += 4) {
      int32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int x = xs + j + u;
        if (j + u >= per) break;
        if (x >= next) {
          ++r;
          e = runs.entry[r];
          next = r + 1 < runs.n ? runs.start[r + 1] : V;
        }
        v[u] = x < runs.end ? e : 0;
        if (k > 0) two_level(x, v[u]);
      }
      if (per >= 4)
        *reinterpret_cast<int4*>(lut + xs + j) =
            make_int4(v[0], v[1], v[2], v[3]);
      else
        for (int u = 0; u < per; ++u) lut[xs + u] = v[u];
    }
  }
  if (k == 0) return;
  // the shared block of escapes, then the padding, over the stream's blocks
  const int64_t n_primary = static_cast<int64_t>(st.n_trees) << k;
  const int64_t shared = n_primary + (static_cast<int64_t>(st.own) << d);
  const int64_t used = n_primary + (static_cast<int64_t>(st.n_blocks) << d);
  const int64_t step = static_cast<int64_t>(st.n_trees) * chunks * kThreads;
  for (int64_t x = shared + (static_cast<int64_t>(t) * chunks + c) * kThreads +
                   s;
       x < st.n; x += step)
    st.packed[x] = x < used ? static_cast<uint16_t>(kEscape) : 0;
}

__global__ void empty_kernel() {}

Stream stream_of(const void* words, const void* layout, int n_trees, int k,
                 int own, int n_blocks, int n, void* full, void* packed) {
  return Stream{static_cast<const uint32_t*>(words),
                static_cast<const int32_t*>(layout),
                static_cast<int32_t*>(full),
                static_cast<uint16_t*>(packed),
                n_trees, k, own, n_blocks, n};
}

}  // namespace

// One launch over the trees of stream 0 and, where n_trees1 > 0, stream 1.
extern "C" int phyngsc_tables(int lut_bits, const void* words0,
                              const void* layout0, int n_trees0, int k0,
                              int own0, int n_blocks0, int n0, void* full0,
                              void* packed0, const void* words1,
                              const void* layout1, int n_trees1, int k1,
                              int own1, int n_blocks1, int n1, void* full1,
                              void* packed1, void* stream) {
  Params p;
  p.s[0] = stream_of(words0, layout0, n_trees0, k0, own0, n_blocks0, n0,
                     full0, packed0);
  p.s[1] = stream_of(words1, layout1, n_trees1, k1, own1, n_blocks1, n1,
                     full1, packed1);
  p.lut_bits = lut_bits;
  const int trees = n_trees0 + n_trees1;
  if (trees <= 0) return 0;
  // the fewest chunks that give each thread 4 windows or fewer and the grid
  // a block an SM, with kThreads windows a chunk or more
  const int most = lut_bits > 8 ? lut_bits - 8 : 0;
  const int sms = phyngsc::sm_count();
  p.log_chunks = min(lut_bits > 10 ? lut_bits - 10 : 0, most);
  while (p.log_chunks < most && (trees << p.log_chunks) < sms) ++p.log_chunks;
  tables_kernel<<<trees << p.log_chunks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of `blocks` blocks of kThreads threads: the device time
// of a launch that does nothing, the floor under K5's and K6's times.
extern "C" int phyngsc_empty(int blocks, void* stream) {
  empty_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
