// K2 / K3: canonical-Huffman LUT walks, one thread per substream.
//
// K2 (phyngsc_walk_uniform) replaces phyngsc_tpu/ops/bitpack.py
// _make_walk_kernel / unpack_substreams_uniform_pallas (:572-695); K3
// (phyngsc_walk_masked) replaces _make_masked_kernel /
// unpack_substreams_masked_pallas (:698-823).
//
// The TPU kernels need every lane's words in a dense (Wmax, Sp) VMEM plane
// and replace the per-lane LUT read by a 256-column run-compare sum, because
// Pallas has no per-lane gather. A Hopper thread gathers freely, so each
// thread reads the LINEAR word stream from its substream's start (exclusive
// prefix sum of the substream table) and looks its entry up in a full
// 2^lut_bits LUT, entry = (len << 9) | sym, built on the host. Both walks
// pick the tree per step, as the TPU kernels read per-step tables: K2 by the
// position t % Lt, K3 by the slot position t % L (one tree for DNA).
//
// Bound: each step is a chain of dependent loads (window -> LUT entry ->
// cursor), so a walk is latency bound and a sub-block has only S = Rp / G
// walks (about 1,000 live at the default G = 64). The design keeps the chain
// short: the two window words live in registers and advance by at most one
// word per step, so the only load on the chain is the LUT entry, which the
// read-only cache and L2 serve. Several sub-blocks per launch are later work.
//
// Untrusted input: every word read is bounds-checked against n_words (reads
// past the end give 0), the window is built from a 64-bit pair so no shift
// is by 32, and every output index is bounded by the lane's slot range, so
// a corrupt substream table decodes garbage but never reads or writes out
// of bounds. A tree id outside [0, n_trees) is clamped.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

struct BitCursor {
  const uint32_t* words;
  int64_t n;
  int64_t wi;  // index of w0
  uint32_t w0, w1;
  int bit;     // consumed bits of w0, in [0, 32)

  __device__ uint32_t load(int64_t i) const {
    return (i >= 0 && i < n) ? __ldg(words + i) : 0u;
  }
  __device__ void init(const uint32_t* w, int64_t nw, int64_t start) {
    words = w;
    n = nw;
    wi = start;
    bit = 0;
    w0 = load(wi);
    w1 = load(wi + 1);
  }
  // the 32 bits at the cursor, MSB first
  __device__ uint32_t window() const {
    const uint64_t pair = (static_cast<uint64_t>(w0) << 32) | w1;
    return static_cast<uint32_t>((pair << bit) >> 32);
  }
  __device__ void advance(int len) {
    bit += len;
    while (bit >= 32) {
      bit -= 32;
      ++wi;
      w0 = w1;
      w1 = load(wi + 1);
    }
  }
};

// K2: step t of lane s decodes position p = t % Lt of record s*G + t / Lt
// with tree tree_of_pos[p]; the lane stops after totals[s] steps.
__global__ void walk_uniform_kernel(const uint32_t* __restrict__ words,
                                    int64_t n_words,
                                    const int64_t* __restrict__ word_start,
                                    const int32_t* __restrict__ totals,
                                    const int32_t* __restrict__ luts,
                                    const int32_t* __restrict__ tree_of_pos,
                                    int lut_bits, int S, int G, int Lt, int L,
                                    uint8_t* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int total = min(totals[s], G * Lt);
  if (total <= 0) return;  // dead lane: the output stays zero
  BitCursor c;
  c.init(words, n_words, word_start[s]);
  const int64_t V = int64_t{1} << lut_bits;
  const int shift = 32 - lut_bits;
  uint8_t* row = out + static_cast<int64_t>(s) * G * L;
  int p = 0;
  for (int t = 0; t < total; ++t) {
    const uint32_t idx = c.window() >> shift;
    const int32_t e = __ldg(luts + __ldg(tree_of_pos + p) * V + idx);
    row[p] = static_cast<uint8_t>(e & 0x1FF);
    c.advance(e >> 9);
    if (++p == Lt) {
      p = 0;
      row += L;
    }
  }
}

// K3: slot t of lane s is (record s*G + t / L, position t % L); the lane
// consumes its next symbol only where keep is set, and stops once it has
// consumed totals[s] symbols (the number of kept slots of the lane). The
// table of slot t is tree tree_of_pos[t % L] of luts, clamped to
// [0, n_trees). The variants are separate instantiations, so the DNA walks
// pay nothing for the per-position trees: kPlain2 (fixed 2-bit codes, entry
// = (2 << 9) | top two window bits, no table), kOneTree (Huffman DNA, L = 1:
// the tree is read once) and kPerPosition (variable-length quality; t % L
// is a wrapping counter, not a division per slot).
enum class Tables { kPlain2, kOneTree, kPerPosition };

template <Tables kTables>
__global__ void walk_masked_kernel(const uint32_t* __restrict__ words,
                                   int64_t n_words,
                                   const int64_t* __restrict__ word_start,
                                   const int32_t* __restrict__ totals,
                                   const uint8_t* __restrict__ keep,
                                   const int32_t* __restrict__ luts,
                                   const int32_t* __restrict__ tree_of_pos,
                                   int n_trees, int lut_bits, int S, int T,
                                   int L, uint8_t* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int total = totals[s];
  if (total <= 0) return;
  BitCursor c;
  c.init(words, n_words, word_start[s]);
  const int64_t V = int64_t{1} << lut_bits;
  const int shift = 32 - lut_bits;
  const int32_t* lut = luts;
  if constexpr (kTables == Tables::kOneTree)
    lut += min(max(__ldg(tree_of_pos), 0), n_trees - 1) * V;
  const int64_t base = static_cast<int64_t>(s) * T;
  int done = 0;
  int p = 0;
  for (int t = 0; t < T && done < total; ++t) {
    int pos = 0;
    if constexpr (kTables == Tables::kPerPosition) {
      pos = p;
      p = (p + 1 == L) ? 0 : p + 1;
    }
    if (!keep[base + t]) continue;
    const uint32_t win = c.window();
    int32_t e;
    if constexpr (kTables == Tables::kPlain2) {
      e = (2 << 9) | static_cast<int32_t>(win >> 30);
    } else if constexpr (kTables == Tables::kOneTree) {
      e = __ldg(lut + (win >> shift));
    } else {
      const int tree = min(max(__ldg(tree_of_pos + pos), 0), n_trees - 1);
      e = __ldg(lut + tree * V + (win >> shift));
    }
    out[base + t] = static_cast<uint8_t>(e & 0x1FF);
    c.advance(e >> 9);
    ++done;
  }
}

unsigned blocks_for(int S) { return static_cast<unsigned>((S + kThreads - 1) / kThreads); }

}  // namespace

// out (S*G, L) uint8 must be zeroed by the caller. Returns cudaGetLastError().
extern "C" int phyngsc_walk_uniform(const void* words, int64_t n_words,
                                    const void* word_start, const void* totals,
                                    const void* luts, const void* tree_of_pos,
                                    int lut_bits, int S, int G, int Lt, int L,
                                    void* out, void* stream) {
  walk_uniform_kernel<<<blocks_for(S), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const int64_t*>(word_start),
      static_cast<const int32_t*>(totals), static_cast<const int32_t*>(luts),
      static_cast<const int32_t*>(tree_of_pos), lut_bits, S, G, Lt, L,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out (S*T,) uint8 must be zeroed by the caller; T is a multiple of L. luts
// (n_trees, 2^lut_bits) and tree_of_pos (L,) may be null when plain2.
extern "C" int phyngsc_walk_masked(const void* words, int64_t n_words,
                                   const void* word_start, const void* totals,
                                   const void* keep, const void* luts,
                                   const void* tree_of_pos, int n_trees,
                                   int plain2, int lut_bits, int S, int T,
                                   int L, void* out, void* stream) {
  const auto kernel = plain2 ? walk_masked_kernel<Tables::kPlain2>
                      : L == 1 ? walk_masked_kernel<Tables::kOneTree>
                               : walk_masked_kernel<Tables::kPerPosition>;
  kernel<<<blocks_for(S), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const int64_t*>(word_start),
      static_cast<const int32_t*>(totals), static_cast<const uint8_t*>(keep),
      static_cast<const int32_t*>(luts),
      static_cast<const int32_t*>(tree_of_pos), n_trees, lut_bits, S, T, L,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
