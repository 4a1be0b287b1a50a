// K2 / K3: canonical-Huffman LUT walks, one thread per substream.
//
// K2 (phyngsc_walk_uniform) replaces phyngsc_tpu/ops/bitpack.py
// _make_walk_kernel / unpack_substreams_uniform_pallas (:572-695, its
// pallas_call at :675); K3 (phyngsc_walk_masked) replaces
// _make_masked_kernel / unpack_substreams_masked_pallas (:698-823, its
// pallas_call at :801).
//
// Both walks read the (Wmax, Sp) lane-minor word plane that K5
// (csrc/densify.cu) builds from the linear stream, as the TPU kernels read
// their dense VMEM plane: word i of lane s sits at plane[i * Sp + s], so the
// threads of a warp, one lane each, read neighbouring words while their
// cursors keep pace. K2 step t of a lane decodes position t % Lt with tree
// tree_of_pos[t % Lt]; K3 slot t decodes only where keep is set, with tree
// tree_of_pos[t % L] (one tree for Huffman DNA, fixed 2-bit codes for
// plain2). The TPU kernels replace the per-lane LUT read by a run-compare
// sum because Pallas has no per-lane gather; a Hopper thread gathers freely.
//
// Bound: a lane is a chain of dependent steps (window -> LUT entry -> cursor
// -> next window), and a sub-block has only about 1,000 live lanes, so the
// walk is bound by the latency of each lane's serial steps, not by bytes or
// operations (both bounds are a few microseconds a sub-block): on an H100
// at 700 W a 36 bp quality step takes about 270 cycles, the lookup chain
// and the step's other ~80 instructions issued in order by one warp. The
// design keeps one on-chip load on the chain and no branch that lanes take
// at different steps:
// - the LUTs live in shared memory as 16-bit entries (len << 9) | sym,
//   staged once per block with cp.async. They are two-level tables built on
//   the host (ops/bitpack.py two_level_luts): per tree a primary of 2^k
//   entries, k the largest that fits the block's shared memory, and for
//   the few primary entries whose codes are longer than k a secondary block
//   of 2^(lut_bits - k) entries, a second shared-memory load. An entry that
//   does not fit 15 bits (none in a table built from code lengths) is
//   flagged and read from the full int32 LUT in global memory, as are the
//   prefixes that find no room for a block of their own when many trees
//   share a block with many tree ids (they point at one block of flags).
//   Where not even the primaries fit (k = 0, tens of thousands of trees),
//   the kOnChip = false instantiations read every entry from the full LUT;
// - the tree ids are staged in shared memory too (clamped, uint16), and the
//   next step's id is loaded while the current step's entry is in flight;
// - each cursor (Cursor below) keeps its next bits in a 64-bit register and
//   the plane words after them in flight in its own ring in shared memory,
//   filled by cp.async, and refills without a branch: lanes refill at
//   different steps, and a branch per refill, or a global load consumed at
//   the next one, put their cost on every step of the warp;
// - output bytes are staged in shared memory (one byte store a symbol) and
//   leave as one 16-byte store per 16 slots; K3 reads keep 16 slots at a
//   time, four 16-byte loads ahead, and plain2 decodes a whole 16-slot
//   group from one window (its kept symbols are the next 2 * popcount(keep)
//   bits).
//
// Untrusted input: every plane read is bounds-checked against Wmax (reads
// past a lane's rows give 0; no shift reaches the width of its operand),
// tree ids are clamped to [0, n_trees), every table index stays inside the
// table the wrapper built, ring slots wrap, and every output byte is
// bounded by the lane's slot range, so a corrupt substream table decodes
// garbage but never reads or writes out of bounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // threads per block, one lane each
constexpr uint32_t kEscape = 0x8000u;
constexpr int kRing = 32;  // plane words in each lane's ring (a power of 2)

__device__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ uint32_t lds16(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(a));
  return v;
}

// Copy n 16-bit entries (n a multiple of 8, src 16-byte aligned) into
// shared memory at dst: 16-byte cp.async copies, all in flight at once,
// which hold no registers. The caller waits and synchronises.
__device__ void stage_tables(uint32_t dst, const uint16_t* src, int n) {
  const uint4* src16 = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < n / 8; i += kThreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     dst + 16 * i),
                 "l"(src16 + i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Stage n clamped tree ids as uint16 at ids: id i is tree_of_pos[i % L]
// (n - L > 0 repeats the first positions, so a group of slots starting at
// any position < L reads its ids without a modulo). Then wait for the
// tables' copies and synchronise the block.
__device__ void stage_ids(uint16_t* ids, const int32_t* tree_of_pos, int n,
                          int L, int n_trees) {
  constexpr int kBatch = 8;  // loads in flight per thread
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * kThreads) {
    int32_t v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads;
      v[j] = i < n ? __ldg(tree_of_pos + (i < L ? i : (i - L) % L)) : 0;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads;
      if (i < n)
        ids[i] = static_cast<uint16_t>(min(max(v[j], 0), n_trees - 1));
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// The staged two-level tables (see ops/bitpack.py two_level_luts).
struct Tables {
  uint32_t tab;          // shared address: n_trees << k primaries, then
                         // the secondaries
  uint32_t ids;          // shared address of the uint16 tree id per position
  int k, d, lut_bits;    // d = lut_bits - k
  int sec;               // index of the first secondary entry
  const int32_t* full;   // (n_trees, 2^lut_bits) int32, for flagged entries

  // the (clamped) tree of position p
  __device__ int tree(int p) const { return lds16(ids + 2 * p); }
  // the full LUT's entry of the tree for the window's top lut_bits: from
  // the staged tables, or straight from the full LUT when !kOnChip (k = 0)
  template <bool kOnChip>
  __device__ int32_t entry(int tree, uint32_t win) const {
    if constexpr (!kOnChip)
      return __ldg(full + (static_cast<int64_t>(tree) << lut_bits) +
                   (win >> (32 - lut_bits)));
    uint32_t e = lds16(tab + 2 * ((tree << k) + (win >> (32 - k))));
    if (e & kEscape) {  // a code longer than k: its secondary block
      const uint32_t i = win >> (32 - lut_bits);
      e = lds16(tab + 2 * (sec + ((e & ~kEscape) << d) +
                           (i & ((1u << d) - 1u))));
      if (e & kEscape)  // never in a table built from code lengths
        return __ldg(full + (static_cast<int64_t>(tree) << lut_bits) + i);
    }
    return static_cast<int32_t>(e);
  }
};

// The calling thread's slots of the block's slot-major lane area (laid out
// below, ring_offset): slot j at at + j * stride.
struct Slots {
  uint32_t at;  // slot 0 of this thread; slot j 4 * kThreads bytes further
  __device__ uint32_t operator()(int j) const { return at + j * 4 * kThreads; }
};
__device__ Slots lane_slots(uint32_t base, int first) {
  return Slots{base + 4 * (first * kThreads + threadIdx.x)};
}

// A lane's bit cursor over its column of the plane, with no branch on its
// path: buf holds the stream's next n bits MSB-aligned (32 <= n <= 64 at a
// step's start, so the window is buf's high word), nw the word after them,
// and the lane's ring in shared memory the kRing - 2 words after nw, in
// flight by cp.async. A step that leaves fewer than 32 bits ORs nw in, then
// loads the next word from the ring into nw and issues the word kRing - 2
// further into the slot freed two refills ago, all predicated: nw is next
// needed at the next refill, so no step waits for a global load. Every step
// commits one cp.async group (empty unless it refills), so waiting until
// kRing - 3 groups are pending covers the word read now, issued kRing - 2
// refills, so at least as many steps, earlier.
struct Cursor {
  const uint32_t* src;  // word fw of the lane's column (col[i * Sp])
  int64_t Sp;
  int Wmax;
  int fw;               // the next word to fetch into the ring
  Slots ring;           // the lane's kRing ring slots
  uint64_t buf;
  int n;
  uint32_t nw;          // the word after buf's bits
  int rd;               // ring slot of the word after nw

  // the next word into its ring slot if p, asynchronously (zeros past row
  // Wmax), then commit the step's group
  __device__ void fetch(bool p) {
    const bool in = fw < Wmax;
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.u32 p, %3, 0;\n"
        " @p cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
        " cp.async.commit_group;\n}\n" ::"r"(ring(fw & (kRing - 1))),
        "l"(src), "r"(in ? 4 : 0), "r"(p ? 1 : 0)
        : "memory");
    if (p && in) src += Sp;
    fw += p ? 1 : 0;
  }
  __device__ void init(const uint32_t* plane, int wmax, int sp, int s,
                       Slots ring_slots) {
    const uint32_t* col = plane + s;
    Sp = sp;
    Wmax = wmax;
    ring = ring_slots;
    auto load = [&](int i) { return i < wmax ? __ldg(col + i * Sp) : 0u; };
    buf = static_cast<uint64_t>(load(0)) << 32 | load(1);
    n = 64;
    nw = load(2);
    rd = 3;
    fw = 3;
    src = col + (wmax > 3 ? 3 * Sp : 0);
    for (int i = 3; i <= kRing; ++i) fetch(true);
  }
  // the 32 bits at the cursor, MSB first
  __device__ uint32_t window() const {
    return static_cast<uint32_t>(buf >> 32);
  }
  __device__ void advance(int len) {
    if (static_cast<unsigned>(len) > 32u) {  // only from a corrupt table
      for (; len > 32; len -= 32) consume(32);
      if (len < 0) len = 0;
    }
    consume(len);
  }
  // len in [0, 32]
  __device__ void consume(int len) {
    buf <<= len;
    n -= len;
    const bool refill = n < 32;
    buf |= refill ? static_cast<uint64_t>(nw) << (32 - n) : 0;
    n += refill ? 32 : 0;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 3) : "memory");
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n"
        " @p ld.shared.u32 %0, [%1];\n}\n"
        : "+r"(nw)
        : "r"(ring(rd)), "r"(refill ? 1 : 0)
        : "memory");
    rd = (rd + (refill ? 1 : 0)) & (kRing - 1);
    fetch(refill);
  }
};

// A walk block's shared memory: the packed tables (n_packed uint16, a
// multiple of 8), the tree ids (n_ids uint16, padded to a multiple of 8),
// then kLaneWords words per thread: its ring of kRing plane words and its 4
// words of staged output bytes, slot-major (slot j of thread t at word
// j * kThreads + t), so that a warp's threads touching one slot each hit
// 32 banks.
constexpr int kLaneWords = kRing + 4;
constexpr int kLaneBytes = 4 * kLaneWords;

__host__ __device__ constexpr size_t ids_offset(int n_packed) {
  return 2 * static_cast<size_t>(n_packed);
}
__host__ __device__ constexpr size_t ring_offset(int n_packed, int n_ids) {
  return ids_offset(n_packed) + 2 * ((static_cast<size_t>(n_ids) + 7) & ~7ull);
}

// Stage the block's tables and n_ids tree ids (positions modulo L), and
// return its Tables.
__device__ Tables stage(unsigned char* smem, const uint16_t* packed,
                        int n_packed, int k, int n_primary,
                        const int32_t* full, int n_trees, int lut_bits,
                        const int32_t* tree_of_pos, int n_ids, int L) {
  const uint32_t base = shared_addr(smem);
  stage_tables(base, packed, n_packed);
  stage_ids(reinterpret_cast<uint16_t*>(smem + ids_offset(n_packed)),
            tree_of_pos, n_ids, L, n_trees);
  return Tables{base, base + static_cast<uint32_t>(ids_offset(n_packed)), k,
                lut_bits - k, lut_bits, n_primary, full};
}

// out[c, c + 16) = the bytes of v: one 16-byte store when the chunk lies
// inside the lane's range [lo, hi), else only the lane's own bytes (the
// ends of a lane whose range is not 16-byte aligned).
__device__ void store16(uint8_t* out, int64_t c, uint4 v, int64_t lo,
                        int64_t hi) {
  if (c >= lo && c + 16 <= hi) {
    *reinterpret_cast<uint4*>(out + c) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int o = 0; o < 16; ++o)
    if (c + o >= lo && c + o < hi)
      out[c + o] = static_cast<uint8_t>(w[o >> 2] >> (8 * (o & 3)));
}

// A lane's output bytes of one 16-byte chunk of out, staged in its 4 staging
// slots (zero until put): one byte store a symbol, one 16-byte store a
// chunk.
struct Chunk {
  Slots slot;

  __device__ void put(int o, uint32_t v) const {
    asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(slot(o >> 2) + (o & 3)),
                 "r"(v));
  }
  __device__ uint32_t take(int q) const {  // staged word q, then zero it
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];\n st.shared.u32 [%1], 0;\n"
                 : "=r"(v)
                 : "r"(slot(q))
                 : "memory");
    return v;
  }
  // out[c, c + 16) from the staged bytes, which return to zero
  __device__ void flush(uint8_t* out, int64_t c, int64_t lo,
                        int64_t hi) const {
    store16(out, c, make_uint4(take(0), take(1), take(2), take(3)), lo, hi);
  }
};

__device__ Chunk zeroed_chunk(Slots slot) {
  for (int q = 0; q < 4; ++q)
    asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(slot(q)) : "memory");
  return Chunk{slot};
}

// The 4 bytes of 2-bit symbols in x's 8 bits, MSB first: byte 0 = x >> 6.
__device__ uint32_t spread2(uint32_t x) {
  return (x >> 6) | ((x >> 4) & 3u) << 8 | ((x >> 2) & 3u) << 16 |
         (x & 3u) << 24;
}

// K2: step t of lane s decodes position p = t % Lt of record s*G + t / Lt
// with tree tree_of_pos[p]; the lane stops after totals[s] steps.
template <bool kOnChip>
__global__ void __launch_bounds__(kThreads)
    walk_uniform_kernel(const uint32_t* __restrict__ plane, int Wmax, int Sp,
                        const int32_t* __restrict__ totals,
                        const uint16_t* __restrict__ packed, int n_packed,
                        int k, int n_primary, const int32_t* __restrict__ full,
                        int n_trees, int lut_bits,
                        const int32_t* __restrict__ tree_of_pos, int S, int G,
                        int Lt, int L, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const int total = s < S ? min(totals[s], G * Lt) : 0;
  if (!__syncthreads_or(total > 0)) return;  // a block of dead lanes
  const Tables tb = stage(smem, packed, n_packed, k, n_primary, full, n_trees,
                          lut_bits, tree_of_pos, Lt, Lt);
  if (total <= 0) return;  // dead lane: the output stays zero
  const uint32_t lanes = shared_addr(smem + ring_offset(n_packed, Lt));
  Cursor c;
  c.init(plane, Wmax, Sp, s, lane_slots(lanes, 0));
  const Chunk ch = zeroed_chunk(lane_slots(lanes, kRing));
  const int64_t lo = static_cast<int64_t>(s) * G * L;
  const int64_t hi = lo + static_cast<int64_t>(G) * L;
  // output bytes counted from the 16-byte boundary at or below lo
  const int64_t origin = lo & ~int64_t{15};
  int row = static_cast<int>(lo - origin);  // the record's position 0
  int chunk = row >> 4;
  int p = 0;
  int tree = tb.tree(0);
  for (int t = 0; t < total; ++t) {
    const int pn = p + 1 == Lt ? 0 : p + 1;
    const int next = tb.tree(pn);  // off the chain
    const int32_t e = tb.entry<kOnChip>(tree, c.window());
    const int q = row + p;
    if (q >> 4 != chunk) {
      ch.flush(out, origin + 16 * static_cast<int64_t>(chunk), lo, hi);
      chunk = q >> 4;
    }
    ch.put(q & 15, static_cast<uint32_t>(e));
    c.advance(e >> 9);
    tree = next;
    row += pn == 0 ? L : 0;
    p = pn;
  }
  ch.flush(out, origin + 16 * static_cast<int64_t>(chunk), lo, hi);
}

// Bit j set where byte j of the 16 is nonzero.
__device__ uint32_t nonzero_bytes(uint4 v) {
  auto four = [](uint32_t x) {
    const uint32_t m = (__vcmpne4(x, 0u) >> 7) & 0x01010101u;
    return (m * 0x01020408u) >> 24;  // byte i's flag to bit i
  };
  return four(v.x) | four(v.y) << 4 | four(v.z) << 8 | four(v.w) << 12;
}

// Bit j set where c + j lies in [lo, hi).
__device__ uint32_t own_bytes(int64_t c, int64_t lo, int64_t hi) {
  uint32_t m = 0xFFFFu;
  if (c < lo) m &= 0xFFFFu << (lo - c);
  if (c + 16 > hi) m &= 0xFFFFu >> (c + 16 - hi);
  return m;
}

// keep[c, c + 16), zeros past the n bytes of keep.
__device__ uint4 load_keep(const uint8_t* keep, int64_t c, int64_t n) {
  if (c + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(keep + c));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int o = 0; o < 16; ++o)
    if (c + o < n)
      w[o >> 2] |= static_cast<uint32_t>(keep[c + o]) << (8 * (o & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The lowest r set bits of m.
__device__ uint32_t lowest_bits(uint32_t m, int r) {
  uint32_t out = 0;
  for (; r > 0 && m; --r) {
    const uint32_t low = m & (0u - m);
    out |= low;
    m ^= low;
  }
  return out;
}

// K3: slot t of lane s is (record s*G + t / L, position t % L); the lane
// consumes its next symbol only where keep is set, and stops once it has
// consumed totals[s] symbols (the number of kept slots of the lane). The
// variants are separate instantiations: kPlain2 (fixed 2-bit codes, no
// table), kOneTree (Huffman DNA, L = 1) and kPerPosition (variable-length
// quality, tree tree_of_pos[t % L]), each with its tables on chip or, for
// kPerPosition, not (kOnChip).
enum class Variant { kPlain2, kOneTree, kPerPosition };

// tree ids a K3 block stages: one per position and the first 15 again
// (slot pg + j of a group, pg < L, j < 16), the one tree, or none
__host__ __device__ constexpr int masked_ids(Variant v, int L) {
  return v == Variant::kPerPosition ? L + 15 : v == Variant::kOneTree ? 1 : 0;
}

constexpr int kKeepAhead = 4;  // 16-slot keep loads in flight per lane

template <Variant kV, bool kOnChip>
__global__ void __launch_bounds__(kThreads)
    walk_masked_kernel(const uint32_t* __restrict__ plane, int Wmax, int Sp,
                       const int32_t* __restrict__ totals,
                       const uint8_t* __restrict__ keep,
                       const uint16_t* __restrict__ packed, int n_packed,
                       int k, int n_primary, const int32_t* __restrict__ full,
                       int n_trees, int lut_bits,
                       const int32_t* __restrict__ tree_of_pos, int S, int T,
                       int L, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const int total = s < S ? totals[s] : 0;
  const int n_ids = masked_ids(kV, L);
  Tables tb{};
  if constexpr (kV != Variant::kPlain2) {
    if (!__syncthreads_or(total > 0)) return;
    tb = stage(smem, packed, n_packed, k, n_primary, full, n_trees, lut_bits,
               tree_of_pos, n_ids, L);
  }
  if (total <= 0) return;
  const uint32_t lanes = shared_addr(smem + ring_offset(n_packed, n_ids));
  Cursor c;
  c.init(plane, Wmax, Sp, s, lane_slots(lanes, 0));
  const Chunk ch = zeroed_chunk(lane_slots(lanes, kRing));
  const int64_t lo = static_cast<int64_t>(s) * T;
  const int64_t hi = lo + T;
  const int64_t n = static_cast<int64_t>(S) * T;
  int64_t g = lo & ~int64_t{15};  // 16-slot groups aligned in memory
  // position (slot % L) of the group's first slot, g - lo in (-16, 0]
  int pg = 0;
  if constexpr (kV == Variant::kPerPosition)
    pg = static_cast<int>(((g - lo) % L + L) % L);
  int tree = 0;
  if constexpr (kV == Variant::kOneTree) tree = tb.tree(0);
  int done = 0;
  uint4 kb[kKeepAhead];
#pragma unroll
  for (int i = 0; i < kKeepAhead; ++i)
    kb[i] = g + 16 * i < hi ? load_keep(keep, g + 16 * i, n)
                            : make_uint4(0u, 0u, 0u, 0u);
  bool more = true;
  while (more) {
#pragma unroll
    for (int i = 0; i < kKeepAhead; ++i) {
      const int64_t gi = g + 16 * i;
      if (gi >= hi || done >= total) {
        more = false;
        break;
      }
      uint32_t mask = nonzero_bytes(kb[i]) & own_bytes(gi, lo, hi);
      const int64_t ahead = gi + 16 * kKeepAhead;
      if (ahead < hi) kb[i] = load_keep(keep, ahead, n);
      int cnt = __popc(mask);
      if (cnt > total - done) {
        cnt = total - done;
        mask = lowest_bits(mask, cnt);
      }
      if (mask) {
        if constexpr (kV == Variant::kPlain2) {
          // the group's kept symbols are the next 2 * cnt <= 32 bits
          const uint32_t win = c.window();
          c.advance(2 * cnt);
          if (mask == 0xFFFFu) {  // the group's 16 symbols, straight out
            store16(out, gi,
                    make_uint4(spread2(win >> 24), spread2((win >> 16) & 255u),
                               spread2((win >> 8) & 255u),
                               spread2(win & 255u)),
                    lo, hi);
            done += cnt;
            continue;
          }
          int r = 0;
          for (uint32_t m = mask; m; m &= m - 1, ++r)
            ch.put(__ffs(m) - 1, (win >> (30 - 2 * r)) & 3u);
        } else {
          uint32_t m = mask;
          int j = __ffs(m) - 1;
          int tj = tree;
          if constexpr (kV == Variant::kPerPosition) tj = tb.tree(pg + j);
          while (m) {
            m &= m - 1;
            const int jn = __ffs(m) - 1;  // -1 when none is left
            int tn = tj;
            if constexpr (kV == Variant::kPerPosition)
              if (m) tn = tb.tree(pg + jn);  // off the chain
            const int32_t e = tb.entry<kOnChip>(tj, c.window());
            ch.put(j, static_cast<uint32_t>(e));
            c.advance(e >> 9);
            j = jn;
            tj = tn;
          }
        }
        ch.flush(out, gi, lo, hi);
        done += cnt;
      }
      if constexpr (kV == Variant::kPerPosition) {
        pg += 16;
        if (pg >= L) pg = pg - L < L ? pg - L : pg % L;
      }
    }
    g += 16 * kKeepAhead;
  }
}

unsigned blocks_for(int S) {
  return static_cast<unsigned>((S + kThreads - 1) / kThreads);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// plane (Wmax, Sp) uint32 with S <= Sp; packed (n_packed,) uint16 two-level
// tables (n_packed a multiple of 8, 16-byte aligned, n_primary = n_trees <<
// k of them primaries), or none (n_packed 0, k 0: every entry from full);
// full (n_trees, 2^lut_bits) int32; out (S*G, L) uint8 must be zeroed and
// 16-byte aligned. Returns cudaGetLastError().
extern "C" int phyngsc_walk_uniform(const void* plane, int Wmax, int Sp,
                                    const void* totals, const void* packed,
                                    int n_packed, int k, int n_primary,
                                    const void* full, int n_trees,
                                    int lut_bits, const void* tree_of_pos,
                                    int S, int G, int Lt, int L, void* out,
                                    void* stream) {
  const auto kernel = n_packed > 0 ? walk_uniform_kernel<true>
                                   : walk_uniform_kernel<false>;
  const size_t smem = ring_offset(n_packed, Lt) + kLaneBytes * kThreads;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks_for(S), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(plane), Wmax, Sp,
      static_cast<const int32_t*>(totals),
      static_cast<const uint16_t*>(packed), n_packed, k, n_primary,
      static_cast<const int32_t*>(full), n_trees, lut_bits,
      static_cast<const int32_t*>(tree_of_pos), S, G, Lt, L,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// plane (Wmax, Sp) uint32 with S <= Sp; keep and out (S*T,) uint8, 16-byte
// aligned, out zeroed; T is a multiple of L. The tables are as for
// phyngsc_walk_uniform, and null (n_packed 0) when plain2.
extern "C" int phyngsc_walk_masked(const void* plane, int Wmax, int Sp,
                                   const void* totals, const void* keep,
                                   const void* packed, int n_packed, int k,
                                   int n_primary, const void* full,
                                   int n_trees, int lut_bits,
                                   const void* tree_of_pos, int plain2, int S,
                                   int T, int L, void* out, void* stream) {
  if (plain2) n_packed = 0;
  const bool on_chip = n_packed > 0;
  // one tree with no tables on chip (never built so) walks as position 0
  const Variant v = plain2                ? Variant::kPlain2
                    : L == 1 && on_chip ? Variant::kOneTree
                                          : Variant::kPerPosition;
  const auto kernel =
      v == Variant::kPlain2 ? walk_masked_kernel<Variant::kPlain2, true>
      : v == Variant::kOneTree
          ? walk_masked_kernel<Variant::kOneTree, true>
          : on_chip ? walk_masked_kernel<Variant::kPerPosition, true>
                    : walk_masked_kernel<Variant::kPerPosition, false>;
  const size_t smem =
      ring_offset(n_packed, masked_ids(v, L)) + kLaneBytes * kThreads;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks_for(S), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(plane), Wmax, Sp,
      static_cast<const int32_t*>(totals), static_cast<const uint8_t*>(keep),
      static_cast<const uint16_t*>(packed), n_packed, k, n_primary,
      static_cast<const int32_t*>(full), n_trees, lut_bits,
      static_cast<const int32_t*>(tree_of_pos), S, T, L,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
