// Copied from native/host_runtime.cpp; OpenMP regions on host_threads.h.
// Native host runtime for phyngsc_tpu_torch (ctypes-loaded).
//
// Every function computes what its twin in native/host_runtime.cpp computes,
// byte for byte. The one change is the threading: each OpenMP region is a
// phyngsc::parallel_for on the std::thread pool of host_threads.h, and each
// reduction keeps one partial a chunk, combined after the join, so results
// do not depend on the thread count. phyngsc_threads / phyngsc_set_threads
// read and set that count. phyngsc_quality_tables and phyngsc_title_encode
// have no twin there: the port's stage B quality table search
// (models/quality.py), on the calling thread, and the title stream's whole
// encode (models/title.py).
//
// The reference spends its host cycles in OpenMP byte scans over the read
// buffer (record indexing, phyNGSC.cpp:254-331) and in Huffman tree builds
// (huffman.cpp:18-85). These are the host-side hot loops of the TPU pipeline
// too — everything else runs on device — so they get native implementations:
//
//   phyngsc_index_records  — newline-structured record span scan (C3)
//   phyngsc_gather         — padded (R, W) matrix gather for device batching
//   phyngsc_huffman_lengths— batched length-limited Huffman (C8 host side)
//   phyngsc_quality_tables — the quality stream's whole table search
//   phyngsc_title_encode   — the title stream's whole encode
//
// Build: phyngsc_tpu_torch/host_runtime.py (g++ -O3 -march=native -fPIC
// -std=c++17 -pthread -shared) into build/host/. PHYNGSC_NO_NATIVE=1 makes
// the callers take their numpy versions instead.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

#include "host_threads.h"

namespace {
// The least items a chunk of each region takes (phyngsc::parallel_for).
constexpr int64_t ROWS_GRAIN = 1024;       // records of a row loop
constexpr int64_t BYTES_GRAIN = 1 << 16;   // bytes or elements of a flat loop
constexpr int64_t WORDS_GRAIN = 1 << 14;   // packed words
constexpr int64_t LANES_GRAIN = 4;         // substreams of a decode walk
}  // namespace

extern "C" {

int phyngsc_threads() { return phyngsc::threads(); }

int phyngsc_set_threads(int t) { return phyngsc::set_threads(t); }

// Returns number of complete 4-line records found, or -(1+record_idx) on a
// validation failure at record_idx. Buffer must start at a record start.
int64_t phyngsc_index_records(const uint8_t *buf, int64_t n,
                              int64_t *title_start, int64_t *title_end,
                              int64_t *seq_start, int64_t *seq_end,
                              int64_t *qual_start, int64_t *qual_end,
                              int64_t max_records, int validate) {
  int64_t count = 0;
  const uint8_t *p = buf;
  const uint8_t *end = buf + n;
  while (p < end && count < max_records) {
    const uint8_t *t0 = p;
    const uint8_t *t1 = (const uint8_t *)memchr(t0, '\n', end - t0);
    if (!t1) break;
    const uint8_t *s0 = t1 + 1;
    const uint8_t *s1 = (const uint8_t *)memchr(s0, '\n', end - s0);
    if (!s1) break;
    const uint8_t *p0 = s1 + 1;
    const uint8_t *p1 = (const uint8_t *)memchr(p0, '\n', end - p0);
    if (!p1) break;
    const uint8_t *q0 = p1 + 1;
    const uint8_t *q1 = (const uint8_t *)memchr(q0, '\n', end - q0);
    if (!q1) break;
    if (validate) {
      if (*t0 != '@') return -(1 + count);
      if (p1 - p0 != 1 || *p0 != '+') return -(1 + count);
      if (q1 - q0 != s1 - s0) return -(1 + count);
    }
    title_start[count] = t0 - buf;
    title_end[count] = t1 - buf;
    seq_start[count] = s0 - buf;
    seq_end[count] = s1 - buf;
    qual_start[count] = q0 - buf;
    qual_end[count] = q1 - buf;
    ++count;
    p = q1 + 1;
  }
  return count;
}

// out must be R*W bytes, zero-filled by callee for the padding.
void phyngsc_gather(const uint8_t *buf, int64_t n, const int64_t *starts,
                    const int32_t *lens, int64_t R, int64_t W, uint8_t *out) {
  phyngsc::parallel_for(R, ROWS_GRAIN, [&](int, int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      uint8_t *dst = out + r * W;
      int64_t len = lens[r];
      if (len > W) len = W;
      int64_t s = starts[r];
      if (s < 0 || s + len > n) len = 0;
      if (len > 0) memcpy(dst, buf + s, (size_t)len);
      if (len < W) memset(dst + len, 0, (size_t)(W - len));
    }
  });
}

// Fused per-record gather of the three stage-A planes — a record's title,
// sequence and quality bytes are adjacent in the input, so one pass over
// records beats three separate row gathers on cache traffic. Returns the
// max quality byte (stage A's >= 128 validation, saving another plane
// pass). Out rows are zero-padded to their widths.
int32_t phyngsc_gather3(const uint8_t *buf, int64_t n,
                        const int64_t *t_start, const int32_t *t_lens,
                        int64_t TW, const int64_t *s_start,
                        const int64_t *q_start, const int32_t *lens,
                        int64_t W, int64_t R, uint8_t *titles, uint8_t *seq,
                        uint8_t *qual) {
  const int k = phyngsc::chunk_count(R, ROWS_GRAIN);
  std::vector<int32_t> part(k, 0);  // each chunk's max
  phyngsc::parallel_chunks(R, k, [&](int c, int64_t r0, int64_t r1) {
    int32_t qmax = 0;
    for (int64_t r = r0; r < r1; ++r) {
      int64_t tl = t_lens[r];
      if (tl > TW) tl = TW;
      int64_t ts = t_start[r];
      if (ts < 0 || ts + tl > n) tl = 0;
      uint8_t *td = titles + r * TW;
      if (tl > 0) memcpy(td, buf + ts, (size_t)tl);
      if (tl < TW) memset(td + tl, 0, (size_t)(TW - tl));
      int64_t len = lens[r];
      if (len > W) len = W;
      int64_t ss = s_start[r], qs = q_start[r];
      if (ss < 0 || ss + len > n || qs < 0 || qs + len > n) len = 0;
      uint8_t *sd = seq + r * W;
      uint8_t *qd = qual + r * W;
      if (len > 0) {
        memcpy(sd, buf + ss, (size_t)len);
        memcpy(qd, buf + qs, (size_t)len);
        for (int64_t i = 0; i < len; ++i)
          if ((int32_t)qd[i] > qmax) qmax = qd[i];
      }
      if (len < W) {
        memset(sd + len, 0, (size_t)(W - len));
        memset(qd + len, 0, (size_t)(W - len));
      }
    }
    part[c] = qmax;
  });
  int32_t qmax = 0;
  for (int32_t m : part) qmax = std::max(qmax, m);
  return qmax;
}

namespace {

// One tree's package-merge lists, as huffman_one builds them for a cap of
// L bits: the present symbols sorted, and lists 1 .. L - 1.
struct MergeLists {
  std::vector<int> present;     // symbols with a count, by (count, symbol)
  std::vector<int16_t> leaves;  // (L - 1, 2n + 1): leaves among the first o
  std::vector<int64_t> leaf_w, cur_w, mrg_w;  // scratch
};

// Package-merge (Larmore–Hirschberg coin collector): exact optimal
// length-limited codes. Ordering mirrors ops/huffman.
// _package_merge_lengths exactly — leaves sorted by (freq, symbol); on
// weight ties leaves precede packages and earlier items precede later
// (both inputs to each merge are pre-sorted, so the stable two-pointer
// merge with leaf priority reproduces numpy's lexsort) — so native and
// numpy builders emit identical tables.
//
// Each list keeps its weights and how many leaves its first items hold,
// not each item's leaf counts: a merge keeps the leaves and the packages
// each in order, so the first k items of list l + 1 are its first a
// leaves and its first k - a packages, and those packages are the first
// 2(k - a) items of list l.
void merge_lists(const int64_t *hist, int32_t A, int32_t L, MergeLists *m) {
  std::vector<int> &present = m->present;
  present.clear();
  bool packable = A <= 256;  // (freq, symbol) in one 64-bit key
  for (int32_t s = 0; s < A; ++s) {
    if (hist[s] > 0) {
      present.push_back(s);
      packable = packable && hist[s] < (int64_t(1) << 55);
    }
  }
  const int n = (int)present.size();
  if (n <= 1) return;
  // sort symbols by (freq, symbol) — stable tiebreak like the host builder
  if (packable) {
    thread_local std::vector<uint64_t> keys;
    keys.resize(n);
    for (int i = 0; i < n; ++i)
      keys[i] = (uint64_t)hist[present[i]] << 8 | (uint64_t)present[i];
    std::sort(keys.begin(), keys.end());
    for (int i = 0; i < n; ++i) present[i] = (int)(keys[i] & 255);
  } else {
    std::sort(present.begin(), present.end(), [&](int a, int b) {
      return hist[a] != hist[b] ? hist[a] < hist[b] : a < b;
    });
  }
  std::vector<int64_t> &leaf_w = m->leaf_w, &cur_w = m->cur_w,
                       &mrg_w = m->mrg_w;
  leaf_w.resize(n);
  for (int i = 0; i < n; ++i) leaf_w[i] = hist[present[i]];
  cur_w.assign(leaf_w.begin(), leaf_w.end());
  const size_t stride = 2 * (size_t)n + 1;
  m->leaves.resize((size_t)std::max(L - 1, 0) * stride);
  for (int level = 0; level < L - 1; ++level) {
    const int np_ = (int)(cur_w.size() / 2);
    const int total = n + np_;
    mrg_w.resize(total);
    int16_t *seen = &m->leaves[(size_t)level * stride];
    int li = 0, pi = 0;
    seen[0] = 0;
    for (int o = 0; o < total; ++o) {
      const int64_t pw = pi < np_ ? cur_w[2 * pi] + cur_w[2 * pi + 1] : 0;
      if (li < n && (pi >= np_ || leaf_w[li] <= pw)) {
        mrg_w[o] = leaf_w[li++];
      } else {
        mrg_w[o] = pw;
        ++pi;
      }
      seen[o + 1] = (int16_t)li;
    }
    cur_w.swap(mrg_w);
  }
}

// The code lengths at the cap of max_len = L bits the lists were built for
// (n <= 2^max_len): leaf i's length is the number of lists whose items
// taken hold it, walking back from the 2(n - 1) first of list max_len - 1.
void lengths_of(const MergeLists &m, int32_t A, int32_t max_len,
                uint8_t *lens, int32_t *singleton) {
  std::fill(lens, lens + A, 0);
  *singleton = -1;
  const int n = (int)m.present.size();
  if (n == 0) return;
  if (n == 1) {  // zero-bit singleton code
    *singleton = m.present[0];
    return;
  }
  thread_local std::vector<int> lists;
  lists.assign(n + 1, 0);  // lists[a]: the lists taking leaves < a
  const size_t stride = 2 * (size_t)n + 1;
  int k = 2 * (n - 1);
  for (int level = max_len - 2; level >= 0; --level) {
    const int a = m.leaves[(size_t)level * stride + k];
    ++lists[a];
    k = 2 * (k - a);
  }
  ++lists[k];  // list 0 is the leaves alone
  int acc = 0;
  for (int i = n - 1; i >= 0; --i) {
    acc += lists[i + 1];
    lens[m.present[i]] = (uint8_t)acc;
  }
}

// Single-tree length-limited Huffman (sort + two-queue merge + Kraft repair).
void huffman_one(const int64_t *hist, int32_t A, int32_t max_len,
                 uint8_t *lens, int32_t *singleton) {
  thread_local MergeLists m;  // scratch kept by each thread
  merge_lists(hist, A, max_len, &m);
  lengths_of(m, A, max_len, lens, singleton);
}

}  // namespace

void phyngsc_huffman_lengths(const int64_t *hist, int32_t K, int32_t A,
                             int32_t max_len, uint8_t *lens,
                             int32_t *singletons) {
  phyngsc::parallel_for(K, 1, [&](int, int64_t k0, int64_t k1) {
    for (int64_t k = k0; k < k1; ++k) {
      huffman_one(hist + k * A, A, max_len, lens + k * A, &singletons[k]);
    }
  });
}

namespace {

// group_for of ops/lookup.py: the largest k with k * max_len <= 32, in [2, 8].
int32_t group_for(int32_t max_len) {
  return std::max(2, std::min(32 / std::max(max_len, 1), 8));
}

// Python's `x <= d` for an int x and a finite double d, exactly (no
// rounding of x to a double).
bool int_le_double(int64_t x, double d) {
  if (d >= 9223372036854775808.0) return true;
  if (d < -9223372036854775808.0) return false;
  return x <= (int64_t)std::floor(d);
}

// One table set of models/quality.py's search: the rows of `counts` built
// on the calling thread.
struct TableSet {
  int32_t T = 0;
  std::vector<uint8_t> lens;       // (T, A)
  std::vector<int32_t> singletons; // (T,)
};

// The widest of T rows' symbol counts.
int64_t widest_row(const int64_t *counts, int32_t T, int32_t A) {
  int64_t widest = 0;
  for (int64_t i = 0; i < (int64_t)T * A; i += A) {
    int64_t n = 0;
    for (int32_t s = 0; s < A; ++s) n += counts[i + s] != 0;
    widest = std::max(widest, n);
  }
  return widest;
}

// quality.build_tables' lengths and singletons of T rows of A counts;
// false, with the widest row's symbol count in *n_max, where a row's
// alphabet cannot fit max_len bits (native.huffman_lengths' ValueError).
bool build_set(const int64_t *counts, int32_t T, int32_t A, int32_t max_len,
               TableSet *out, int64_t *n_max) {
  const int64_t widest = widest_row(counts, T, A);
  if (widest > (int64_t(1) << max_len)) {
    *n_max = widest;
    return false;
  }
  out->T = T;
  out->lens.resize((size_t)T * A);
  out->singletons.resize(T);
  for (int32_t t = 0; t < T; ++t)
    huffman_one(counts + (size_t)t * A, A, max_len,
                &out->lens[(size_t)t * A], &out->singletons[t]);
  return true;
}

// _table_cost_bits of models/quality.py and models/title.py: one tree's
// huffman.store_table bits.
int64_t table_cost_bits(const uint8_t *lens, int32_t A, int32_t singleton) {
  if (singleton >= 0) return 32;
  int64_t n = 0;
  for (int32_t a = 0; a < A; ++a) n += lens[a] != 0;
  return n == 0 ? 16 : n == 1 ? 32 : 16 + 8 * ((A + 7) / 8) + 4 * n;
}

// quality._table_cost_bits summed over the set's trees.
int64_t tables_bits(const TableSet &s, int32_t A) {
  int64_t bits = 0;
  for (int32_t t = 0; t < s.T; ++t)
    bits += table_cost_bits(&s.lens[(size_t)t * A], A, s.singletons[t]);
  return bits;
}

// One tree's canonical codes (ops/huffman.py canonical_codes): in (length,
// symbol) order each code left-aligns at the Kraft sum of its
// predecessors, code = (sum 2^(B - len_j)) >> (B - len), for any B at
// least the tree's longest length.
void canonical_row(const uint8_t *l, int32_t A, int32_t B, uint32_t *c) {
  int64_t start[33] = {0};  // each length's first Kraft offset
  for (int32_t a = 0; a < A; ++a)
    if (l[a]) start[l[a]] += int64_t(1) << (B - l[a]);
  int64_t acc = 0;
  for (int32_t n = 1; n <= B; ++n) {
    const int64_t w = start[n];
    start[n] = acc;
    acc += w;
  }
  for (int32_t a = 0; a < A; ++a) {
    if (!l[a]) {
      c[a] = 0;
      continue;
    }
    c[a] = (uint32_t)(start[l[a]] >> (B - l[a]));
    start[l[a]] += int64_t(1) << (B - l[a]);
  }
}

// sum over the T0 rows of counts x the lengths of row gid(t) of the set,
// gid(t) = t * T // T0 (the identity where T == T0).
int64_t payload_bits(const int64_t *counts, int32_t T0, int32_t A,
                     const TableSet &s) {
  int64_t bits = 0;
  for (int32_t t = 0; t < T0; ++t) {
    const int64_t g = (int64_t)t * s.T / T0;
    const int64_t *c = counts + (size_t)t * A;
    const uint8_t *l = &s.lens[(size_t)g * A];
    for (int32_t a = 0; a < A; ++a) bits += c[a] * l[a];
  }
  return bits;
}

}  // namespace

// Stage B's quality table search (models/quality.py build_tables_adaptive,
// whose numpy version PHYNGSC_NO_NATIVE=1 selects), on the calling thread
// alone: it is at most a few hundred tree builds of at most 256 symbols,
// which a split over the pool would only make wait on workers that the
// pool's other tasks keep busy. counts: (T0, A) histogram rows; version: the
// footer version written (v4+ may merge rows onto T < T0 trees by
// t * T // T0). Writes the chosen set's (T, A) lengths and canonical
// codes and its (T,) singletons into the first T rows of the (T0, ...)
// outputs, and info = {T, group, table sets built}. Returns 0, or -1 with
// info[3] = the widest row's symbol count where an alphabet cannot fit
// max_code_len bits.
int32_t phyngsc_quality_tables(const int64_t *counts, int32_t T0, int32_t A,
                               int32_t max_code_len, int32_t version,
                               uint8_t *lens, uint32_t *codes,
                               int32_t *singletons, int64_t *info) {
  int64_t built = 0;
  TableSet tables, cand;
  if (!build_set(counts, T0, A, max_code_len, &tables, &info[3])) return -1;
  ++built;
  // the counts the chosen set was built from
  std::vector<int64_t> cur(counts, counts + (size_t)T0 * A), merged;
  if (T0 > 1 && version >= 4) {
    // every candidate groups the original rows with the direct map that
    // the encode kernel and every v4 reader apply
    int64_t best = payload_bits(counts, T0, A, tables) + tables_bits(tables, A);
    for (int32_t T2 = T0 / 2; T2 >= 1; T2 /= 2) {
      merged.assign((size_t)T2 * A, 0);
      for (int32_t t = 0; t < T0; ++t) {
        const int64_t g = (int64_t)t * T2 / T0;
        for (int32_t a = 0; a < A; ++a)
          merged[(size_t)g * A + a] += counts[(size_t)t * A + a];
      }
      if (!build_set(merged.data(), T2, A, max_code_len, &cand, &info[3]))
        return -1;
      ++built;
      const int64_t bits = payload_bits(counts, T0, A, cand) +
                           tables_bits(cand, A);
      if (bits >= best) break;
      best = bits;
      cur.swap(merged);
      std::swap(tables, cand);
    }
  }
  const int32_t T = tables.T;
  int32_t max_len = 1;
  if ((int64_t)T * A > 0)
    max_len = *std::max_element(tables.lens.begin(), tables.lens.end());
  int32_t group = group_for(max_len);
  const int64_t base = payload_bits(cur.data(), T, A, tables);
  if (base) {
    // a capped set is the same rows built at fewer bits; a cap that a
    // row's alphabet cannot fit raises
    const double limit = (double)base * 1.004;
    bool capped = false;
    if (max_len > 6 && max_code_len > 6 &&
        widest_row(cur.data(), T, A) <= 64) {
      build_set(cur.data(), T, A, 6, &cand, &info[3]);
      ++built;
      if (int_le_double(payload_bits(cur.data(), T, A, cand), limit)) {
        std::swap(tables, cand);
        group = group_for(6);
        capped = true;
      }
    }
    if (!capped && group < 4 && max_code_len > 8) {
      if (!build_set(cur.data(), T, A, 8, &cand, &info[3])) return -1;
      ++built;
      if (int_le_double(payload_bits(cur.data(), T, A, cand), limit)) {
        std::swap(tables, cand);
        group = 4;
      }
    }
  }
  // canonical codes, B the set's longest length
  const int32_t B = (int64_t)T * A > 0
      ? *std::max_element(tables.lens.begin(), tables.lens.end()) : 0;
  for (int32_t t = 0; t < T; ++t)
    canonical_row(&tables.lens[(size_t)t * A], A, B, codes + (size_t)t * A);
  std::copy(tables.lens.begin(), tables.lens.end(), lens);
  std::copy(tables.singletons.begin(), tables.singletons.end(), singletons);
  info[0] = T;
  info[1] = group;
  info[2] = built;
  return 0;
}

// Substream-parallel LUT decode walk (twin of ops/bitpack.unpack_substreams_np
// — bit-identical). The walk is inherently sequential per substream (each
// code's length moves the bit cursor), so the host version parallelizes over
// substreams with OpenMP; used for the title char stream, whose per-record
// step counts are data-dependent (the device walk would pay one executable
// per step-count bucket and a per-sub-block H2D of the step maps).
// words: packed uint32 (caller appends >= 2 zero pad words like the numpy
// twin); luts: (n_trees, 2^lut_bits) int32 entries (len<<9 | sym).
void phyngsc_unpack_substreams(const uint32_t *words, int64_t n_words,
                               const int64_t *sub_word_start, int64_t S,
                               const int32_t *luts, int32_t lut_bits,
                               const int32_t *tree_ids, const uint8_t *valid,
                               int64_t T, int32_t *out) {
  phyngsc::parallel_for(S, LANES_GRAIN, [&](int, int64_t s0, int64_t s1) {
    for (int64_t s = s0; s < s1; ++s) {
      int64_t wi = sub_word_start[s];
      uint32_t bit = 0;
      const int32_t *tid = tree_ids + s * T;
      const uint8_t *v = valid + s * T;
      int32_t *o = out + s * T;
      for (int64_t t = 0; t < T; ++t) {
        uint32_t w1 = (wi >= 0 && wi < n_words) ? words[wi] : 0;
        uint32_t w2 = (wi + 1 >= 0 && wi + 1 < n_words) ? words[wi + 1] : 0;
        uint32_t win = bit ? ((w1 << bit) | (w2 >> (32 - bit))) : w1;
        uint32_t idx = win >> (32 - (uint32_t)lut_bits);
        int32_t entry = luts[((int64_t)tid[t] << lut_bits) | idx];
        o[t] = entry & 0x1FF;
        bit += v[t] ? (uint32_t)(entry >> 9) : 0u;
        wi += bit >> 5;
        bit &= 31u;
      }
    }
  });
}

namespace {

// One title's scan (phyngsc_title_encode's schema and numeric parse):
// writes the first max_seps separators' positions and chars, the first
// max_seps + 1 fields' values and numeric flags (canonical numbers only:
// <= 18 digits, no leading zero unless "0"), and returns the title's
// separator count.
int32_t scan_title(const uint8_t *t, int32_t n, const uint8_t *sep_tab,
                   int32_t max_seps, int32_t *sep_pos, uint8_t *sep_chars,
                   int64_t *v, uint8_t *ok) {
  int32_t ns = 0;
  int32_t field = 0;
  int64_t val = 0;
  int32_t digits = 0;
  bool all_digits = true;
  bool leading_zero = false;
  auto close_field = [&]() {
    if (field <= max_seps) {
      bool good = all_digits && digits >= 1 && digits <= 18 &&
                  !(leading_zero && digits > 1);
      v[field] = good ? val : 0;
      ok[field] = good ? 1 : 0;
    }
    val = 0;
    digits = 0;
    all_digits = true;
    leading_zero = false;
    ++field;
  };
  for (int32_t i = 0; i < n; ++i) {
    uint8_t c = t[i];
    if (sep_tab[c]) {
      close_field();
      if (ns < max_seps) {
        sep_pos[ns] = i;
        sep_chars[ns] = c;
      }
      ++ns;
    } else if (c >= '0' && c <= '9') {
      if (digits == 0 && c == '0') leading_zero = true;
      if (digits < 19) val = val * 10 + (c - '0');
      ++digits;
    } else {
      all_digits = false;
    }
  }
  close_field();
  return ns;
}

}  // namespace

// Fixed-width MSB-first word packing (ops/transfer._pack_fixed_np twin):
// word i = OR of v[j] << (32 - w*(j+1)) over its `per` values, where v is a
// per-byte transform of the source plane. The numpy version pays ~8 strided
// passes; this is the stage-A H2D pack on the compress critical path
// (reference analogue: the byte copies feeding BitStream, phyNGSC.cpp:690+).
// transform: 0 identity, 1 ACGT 2-bit ((c>>1)&3), 2 ACGTN 3-bit (N->4),
// 3 quality 6-bit (0 stays 0, else c-33).
void phyngsc_pack_fixed(const uint8_t *src, int64_t n, int32_t w,
                        int32_t transform, uint32_t *out) {
  static const int per_tab[9] = {0, 0, 16, 10, 8, 6, 5, 0, 4};
  const int per = per_tab[w];
  const int64_t n_words = (n + per - 1) / per;
  phyngsc::parallel_for(n_words, WORDS_GRAIN,
                        [&](int, int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      uint32_t acc = 0;
      const int64_t base = i * per;
      const int64_t m = std::min<int64_t>(per, n - base);
      for (int64_t j = 0; j < m; ++j) {
        uint32_t c = src[base + j];
        uint32_t v;
        switch (transform) {
          case 1: v = (c >> 1) & 3u; break;
          case 2: v = (c == 78) ? 4u : ((c >> 1) & 3u); break;
          case 3: v = c ? (c - 33u) : 0u; break;
          default: v = c; break;
        }
        acc |= v << (32 - w * (j + 1));
      }
      out[i] = acc;
    }
  });
}

// Decompressor output-tail fusion (pipeline/subblock.decode_stage_b twin):
// unpack the w-bit alphabet-index lane plane and the 6/8-bit quality lane
// plane, apply the alphabet lookup and (qual8 mode) the host-side ambiguity
// restore (inverse of phyNGSC.cpp:573-588) in ONE elementwise pass — the
// numpy version pays ~8 passes over megabyte planes per sub-block.
void phyngsc_decode_tail(const uint32_t *sw, const uint32_t *qw, int64_t n,
                         int32_t w, int32_t qw_bits, int32_t plus33,
                         int32_t qual8, const uint8_t *alpha,
                         const uint8_t *amb, uint8_t *seq_out,
                         uint8_t *qual_out) {
  static const int per_tab[9] = {0, 0, 16, 10, 8, 6, 5, 0, 4};
  const int ps = per_tab[w];
  const int pq = per_tab[qw_bits];
  const uint32_t ms = (1u << w) - 1;
  const uint32_t mq = (qw_bits == 8) ? 255u : ((1u << qw_bits) - 1);
  phyngsc::parallel_for(n, BYTES_GRAIN, [&](int, int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      const uint32_t idx = (sw[i / ps] >> (32 - w * (i % ps + 1))) & ms;
      const uint32_t q = (qw[i / pq] >> (32 - qw_bits * (i % pq + 1))) & mq;
      uint8_t sv, qv;
      if (qual8 && q >= 128) {
        int code = (int)((q - 112) >> 3);
        if (code > 16) code = 16;
        sv = amb[code];
        qv = (uint8_t)(q - 112 - (uint32_t)(code << 3) + 33);
      } else {
        sv = alpha[idx];
        qv = plus33 ? (uint8_t)(q + 33) : (uint8_t)q;
      }
      seq_out[i] = sv;
      qual_out[i] = qv;
    }
  });
}

// Ascending indices of non-ACGT/0 bytes (the SEQ_2BIT_EXC exception list):
// two parallel passes — per-chunk counts, exclusive prefix, ordered fill.
// Returns the total count; writes at most `cap` indices.
int64_t phyngsc_find_non_acgt(const uint8_t *src, int64_t n,
                              int64_t cap, uint32_t *out_idx) {
  const int64_t chunk = 1 << 16;
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  std::vector<int64_t> counts(n_chunks + 1, 0);
  phyngsc::parallel_for(n_chunks, 1, [&](int, int64_t c0, int64_t c1) {
    for (int64_t c = c0; c < c1; ++c) {
      const int64_t e = std::min(n, (c + 1) * chunk);
      int64_t k = 0;
      for (int64_t i = c * chunk; i < e; ++i) {
        const uint8_t b = src[i];
        k += (b == 0 || b == 'A' || b == 'C' || b == 'G' || b == 'T') ? 0 : 1;
      }
      counts[c + 1] = k;
    }
  });
  for (int64_t c = 0; c < n_chunks; ++c) counts[c + 1] += counts[c];
  if (counts[n_chunks] > cap) return counts[n_chunks];
  phyngsc::parallel_for(n_chunks, 1, [&](int, int64_t c0, int64_t c1) {
    for (int64_t c = c0; c < c1; ++c) {
      const int64_t e = std::min(n, (c + 1) * chunk);
      int64_t w = counts[c];
      for (int64_t i = c * chunk; i < e; ++i) {
        const uint8_t b = src[i];
        if (!(b == 0 || b == 'A' || b == 'C' || b == 'G' || b == 'T'))
          out_idx[w++] = (uint32_t)i;
      }
    }
  });
  return counts[n_chunks];
}

// One-pass byte census for the pack-mode decisions (replaces ~5 boolean
// numpy passes per plane): counts of non-ACGT/0 bytes, 'N' bytes, bytes
// >= 128, and bytes outside the 6-bit quality window (0 or [33, 96]).
void phyngsc_byte_scan(const uint8_t *src, int64_t n, int64_t *out4) {
  const int k = phyngsc::chunk_count(n, BYTES_GRAIN);
  std::vector<int64_t> part(4 * (size_t)k, 0);  // each chunk's four sums
  phyngsc::parallel_chunks(n, k, [&](int ch, int64_t i0, int64_t i1) {
    int64_t non_acgt = 0, n_n = 0, ge128 = 0, non_q6 = 0;
    for (int64_t i = i0; i < i1; ++i) {
      const uint8_t c = src[i];
      const bool acgt0 =
          c == 0 || c == 'A' || c == 'C' || c == 'G' || c == 'T';
      non_acgt += acgt0 ? 0 : 1;
      n_n += (c == 'N') ? 1 : 0;
      ge128 += (c >= 128) ? 1 : 0;
      non_q6 += (c == 0 || (c >= 33 && c <= 96)) ? 0 : 1;
    }
    int64_t *p = &part[4 * (size_t)ch];
    p[0] = non_acgt;
    p[1] = n_n;
    p[2] = ge128;
    p[3] = non_q6;
  });
  for (int j = 0; j < 4; ++j) {
    int64_t s = 0;
    for (int c = 0; c < k; ++c) s += part[4 * (size_t)c + j];
    out4[j] = s;
  }
}

// FASTQ text reassembly: per-record memcpy of title/seq/qual rows into the
// output buffer at precomputed record offsets (twin of the decompressor's
// subblock._reassemble scatter — the numpy fancy-indexing version builds
// tens of MB of index arrays per sub-block and was the decode host wall).
// offs: (R,) absolute byte offset of each record in out; layout per record is
// title \n seq \n + \n qual \n (mirrors utils/fastq.index_records spans).
void phyngsc_fastq_assemble(const uint8_t *titles, const int32_t *tlens,
                            int64_t TL, const uint8_t *seq,
                            const uint8_t *qual, const int32_t *lens,
                            int64_t L, const int64_t *offs, int64_t R,
                            uint8_t *out) {
  phyngsc::parallel_for(R, ROWS_GRAIN, [&](int, int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      uint8_t *o = out + offs[r];
      const int32_t tl = tlens[r], sl = lens[r];
      memcpy(o, titles + r * TL, (size_t)tl);
      o += tl;
      *o++ = '\n';
      memcpy(o, seq + r * L, (size_t)sl);
      o += sl;
      *o++ = '\n';
      *o++ = '+';
      *o++ = '\n';
      memcpy(o, qual + r * L, (size_t)sl);
      o += sl;
      *o++ = '\n';
    }
  });
}

// Fused title walk: decodes the title char stream substream-parallel and
// writes symbols DIRECTLY into per-field content matrices — the numpy path
// (models/title.decode) materializes (S,T) tree-id/valid maps plus (R,W)
// index matrices per field, which measured as the decompressor's host wall.
// Fields appear in walk order (mirrors title._char_symbols' column order):
//   kind 0 = char field: steps[r,f] symbols, tree = base + min(pos, nt-1)
//   kind 1 = NUM_HUF numeric: 1 symbol/record from the field's shared tree
// out is the concatenation of per-field (R, out_w[f]) int32 row-major blocks
// at out_off[f] (elements).
void phyngsc_title_walk(const uint32_t *words, int64_t n_words,
                        const int64_t *sub_word_start, int64_t S, int64_t G,
                        const int32_t *luts, int32_t lut_bits,
                        int32_t F, const int32_t *tree_base,
                        const int32_t *n_trees, const int32_t *kind,
                        const int32_t *steps /* (R, F) */, int64_t R,
                        const int64_t *out_off, const int32_t *out_w,
                        int32_t *out) {
  phyngsc::parallel_for(S, LANES_GRAIN, [&](int, int64_t s0, int64_t s1) {
    for (int64_t s = s0; s < s1; ++s) {
      int64_t wi = sub_word_start[s];
      uint32_t bit = 0;
      const int64_t r_end = (s + 1) * G < R ? (s + 1) * G : R;
      for (int64_t r = s * G; r < r_end; ++r) {
        for (int32_t f = 0; f < F; ++f) {
          const int32_t ns = kind[f] ? 1 : steps[r * F + f];
          const int32_t nt = n_trees[f];
          int32_t *o = out + out_off[f] + r * out_w[f];
          for (int32_t pos = 0; pos < ns; ++pos) {
            const int32_t tree =
                tree_base[f] + (pos < nt - 1 ? pos : nt - 1);
            uint32_t w1 = (wi >= 0 && wi < n_words) ? words[wi] : 0;
            uint32_t w2 = (wi + 1 < n_words) ? words[wi + 1] : 0;
            uint32_t win = bit ? ((w1 << bit) | (w2 >> (32 - bit))) : w1;
            uint32_t idx = win >> (32 - (uint32_t)lut_bits);
            int32_t entry = luts[((int64_t)tree << lut_bits) | idx];
            o[pos] = entry & 0x1FF;
            bit += (uint32_t)(entry >> 9);
            wi += bit >> 5;
            bit &= 31u;
          }
        }
      }
    }
  });
}

// Fused title reassembly: write each record's fields (decimal numerics from
// precomputed values + digit counts, raw char bytes) and separators into the
// (R, TL) title matrix. Twin of the numpy scatter tail of title.decode.
//   kinds: 0 numeric, 1 char;  nvals: (R,) int64 per numeric field packed
//   field-major at nval_off[f]*R;  chars: int32 symbol blocks as produced by
//   phyngsc_title_walk, at char_off[f] with row width char_w[f].
void phyngsc_title_assemble(int32_t F, const int32_t *kinds,
                            const int32_t *field_lens /* (R, F) */,
                            const int64_t *nvals, const int64_t *nval_off,
                            const int32_t *chars, const int64_t *char_off,
                            const int32_t *char_w, const uint8_t *seps,
                            int64_t R, int64_t TL, uint8_t *titles) {
  phyngsc::parallel_for(R, ROWS_GRAIN, [&](int, int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      uint8_t *t = titles + r * TL;
      int64_t c = 0;
      for (int32_t f = 0; f < F; ++f) {
        const int32_t fl = field_lens[r * F + f];
        if (kinds[f] == 0) {
          int64_t v = nvals[nval_off[f] + r];
          for (int32_t i = fl - 1; i >= 0; --i) {
            t[c + i] = (uint8_t)('0' + (v % 10));
            v /= 10;
          }
          c += fl;
        } else {
          const int32_t *src = chars + char_off[f] + r * char_w[f];
          for (int32_t i = 0; i < fl; ++i) t[c + i] = (uint8_t)src[i];
          c += fl;
        }
        if (f < F - 1) t[c++] = seps[f];
      }
      while (c < TL) t[c++] = 0;
    }
  });
}


namespace {

// The title model's constants (models/title.py).
constexpr int64_t kTitleBlock = 32;    // BLOCK_RECORDS
constexpr int32_t kTitleAlpha = 256;   // ALPHABET
constexpr int64_t kMaxHufRange = 512;  // MAX_HUF_RANGE
enum { kNumeric = 0, kChar = 1 };
enum { kValue = 0, kDelta = 1, kBlock = 2, kHuf = 3 };
enum { kBlkConst = 0, kBlkDelta = 1, kBlkRaw = 2 };

int64_t bits_of(uint64_t x) { return x ? 64 - __builtin_clzll(x) : 0; }

// One field's plan, title.NumericPlan or title.CharPlan.
struct TitleField {
  int64_t kind = kChar, mode = kValue, width = 0, base = 0, first = 0;
  int64_t dwidth = 0, hsub = kValue, alpha = 0, huf_sing = -1;
  int64_t max_len = 0, const_len = 0, len_width = 0;
  std::vector<uint8_t> lens;       // char: (n_trees, 256); NUM_HUF: (alpha,)
  std::vector<int32_t> sing;       // char: (n_trees,)
  std::vector<uint8_t> flags;      // NUM_BLOCK: (nB,)
  std::vector<uint64_t> blk_a, blk_d, blk_raw;
  std::vector<uint8_t> blk_const;  // char in block mode: (nB,)
  std::vector<uint32_t> codes;     // the canonical codes of `lens`
};

// Field f of title r: its bytes start at at(r, f) and run len(r, f).
struct TitleSpans {
  const uint8_t *titles;
  int64_t TL;
  const int32_t *tlens;
  const int32_t *sep_pos;  // (R, ns)
  int64_t ns, F;
  int32_t start(int64_t r, int64_t f) const {
    return f ? sep_pos[r * ns + f - 1] + 1 : 0;
  }
  const uint8_t *at(int64_t r, int64_t f) const {
    return titles + r * TL + start(r, f);
  }
  int32_t len(int64_t r, int64_t f) const {
    return (f + 1 < F ? sep_pos[r * ns + f] : tlens[r]) - start(r, f);
  }
};

// huffman.build_code_lengths_batch and singleton_of_batch of T rows of A
// counts; false, with the row's symbol count in *n_err, at the first row
// whose alphabet cannot fit max_len bits (its ValueError).
bool build_rows(const int64_t *counts, int64_t T, int32_t A, int32_t max_len,
                uint8_t *lens, int32_t *sing, int64_t *n_err) {
  for (int64_t t = 0; t < T; ++t) {
    int64_t n = 0;
    for (int32_t a = 0; a < A; ++a) n += counts[t * A + a] != 0;
    if (n > 1 && n > (int64_t(1) << max_len)) {
      *n_err = n;
      return false;
    }
    huffman_one(counts + t * A, A, max_len, lens + t * A, &sing[t]);
  }
  return true;
}

// title._plan_numeric_block: the plan's exact bits, or -1 where the mode
// does not apply.
int64_t plan_block(const int64_t *v, int64_t R, int64_t vmin, int64_t width_v,
                   TitleField *p) {
  if (R < 2 || width_v == 0) return -1;
  const int64_t nB = (R + kTitleBlock - 1) / kTitleBlock;
  p->kind = kNumeric;
  p->mode = kBlock;
  p->width = width_v;
  p->base = vmin;
  p->flags.resize(nB);
  p->blk_a.resize(nB);
  p->blk_d.resize(nB);
  uint64_t max_zz = 0;
  int64_t n_delta = 0, n_paid = 0;  // delta blocks; values paid at width_v
  for (int64_t g = 0; g < nB; ++g) {
    const int64_t r0 = g * kTitleBlock;
    const int64_t r1 = std::min(r0 + kTitleBlock, R);
    bool same = true, steady = r1 - r0 >= 2;
    const int64_t step = steady ? v[r0 + 1] - v[r0] : 0;
    for (int64_t r = r0 + 1; r < r1; ++r) {
      same = same && v[r] == v[r0];
      steady = steady && v[r] - v[r - 1] == step;
    }
    const uint64_t zz = step < 0 ? ((uint64_t)(-step) << 1) - 1
                                 : (uint64_t)step << 1;
    p->blk_a[g] = (uint64_t)(v[r0] - vmin);
    p->blk_d[g] = zz;
    if (same) {
      p->flags[g] = kBlkConst;
      ++n_paid;
    } else if (steady) {
      p->flags[g] = kBlkDelta;
      ++n_paid;
      ++n_delta;
      max_zz = std::max(max_zz, zz);
    } else {
      p->flags[g] = kBlkRaw;
      n_paid += r1 - r0;
      for (int64_t r = r0; r < r1; ++r)
        p->blk_raw.push_back((uint64_t)(v[r] - vmin));
    }
  }
  p->dwidth = n_delta ? std::max<int64_t>(1, bits_of(max_zz)) : 0;
  return 2 * nB + width_v * n_paid + p->dwidth * n_delta + 87;
}

// A NUM_HUF tree over hist: its lengths and singleton in p, and the
// payload's and the stored table's bits.
int64_t huf_tree(const std::vector<int64_t> &hist, int32_t max_len,
                 TitleField *p) {
  const int32_t A = (int32_t)hist.size();
  int32_t sing;
  p->lens.resize(A);
  huffman_one(hist.data(), A, max_len, p->lens.data(), &sing);
  p->huf_sing = sing;
  p->alpha = A;
  int64_t bits = table_cost_bits(p->lens.data(), A, sing);
  for (int32_t a = 0; a < A; ++a) bits += hist[a] * p->lens[a];
  return bits;
}

// title._numeric_plan_from_values of R values: the mode of fewest exact
// bits.
void plan_numeric(const int64_t *v, int64_t R, int32_t max_len,
                  TitleField *best) {
  int64_t vmin = v[0], vmax = v[0];
  for (int64_t r = 1; r < R; ++r) {
    vmin = std::min(vmin, v[r]);
    vmax = std::max(vmax, v[r]);
  }
  const int64_t width_v = vmax > vmin ? bits_of(vmax - vmin) : 0;
  best->kind = kNumeric;
  best->mode = kValue;
  best->width = width_v;
  best->base = vmin;
  int64_t best_bits = 9 + 64 + R * width_v;
  int64_t dmin = INT64_MAX, dmax = INT64_MIN;
  for (int64_t r = 1; r < R; ++r) {
    dmin = std::min(dmin, v[r] - v[r - 1]);
    dmax = std::max(dmax, v[r] - v[r - 1]);
  }
  if (R >= 2) {
    const int64_t width_d = dmax > dmin ? bits_of(dmax - dmin) : 0;
    const int64_t bits_d = 9 + 128 + (R - 1) * width_d;
    if (bits_d < best_bits) {
      best->mode = kDelta;
      best->width = width_d;
      best->base = dmin;
      best->first = v[0];
      best_bits = bits_d;
    }
  }
  TitleField cand;
  const int64_t bits_b = plan_block(v, R, vmin, width_v, &cand);
  if (bits_b >= 0 && bits_b < best_bits) {
    *best = std::move(cand);
    best_bits = bits_b;
  }
  // NUM_HUF: a shared tree over the values, or over the deltas (record 0
  // emits symbol 0), where the range fits a Kraft-feasible alphabet
  const int64_t cap = std::min<int64_t>(kMaxHufRange, int64_t(1) << max_len);
  TitleField huf, hd;
  int64_t bits_h = -1;
  std::vector<int64_t> hist;
  if (vmax - vmin + 1 >= 2 && vmax - vmin + 1 <= cap) {
    hist.assign(vmax - vmin + 1, 0);
    for (int64_t r = 0; r < R; ++r) ++hist[v[r] - vmin];
    bits_h = huf_tree(hist, max_len, &huf) + 84;
    huf.base = vmin;
  }
  if (R >= 2 && dmax - dmin + 1 >= 2 && dmax - dmin + 1 <= cap) {
    hist.assign(dmax - dmin + 1, 0);
    ++hist[0];
    for (int64_t r = 1; r < R; ++r) ++hist[v[r] - v[r - 1] - dmin];
    const int64_t bits = huf_tree(hist, max_len, &hd) + 148;
    hd.hsub = kDelta;
    hd.base = dmin;
    hd.first = v[0];
    if (bits_h < 0 || bits < bits_h) {
      huf = std::move(hd);
      bits_h = bits;
    }
  }
  if (bits_h >= 0 && bits_h < best_bits) {
    huf.kind = kNumeric;
    huf.mode = kHuf;
    huf.width = width_v;
    *best = std::move(huf);
  }
}

// title.plan_char of field f; false, with *n_err, where a tree's alphabet
// cannot fit max_len bits.
bool plan_char(const TitleSpans &sp, int64_t f, int64_t R, int32_t max_len,
               int64_t max_positions, TitleField *p, int64_t *n_err) {
  const int32_t A = kTitleAlpha;
  int32_t W = 0;
  const int32_t l0 = sp.len(0, f);
  bool same_len = true;
  for (int64_t r = 0; r < R; ++r) {
    W = std::max(W, sp.len(r, f));
    same_len = same_len && sp.len(r, f) == l0;
  }
  p->kind = kChar;
  p->max_len = W;
  const int64_t P = std::min<int64_t>(W, max_positions);
  const int64_t T = P + (W > P ? 1 : 0);
  p->lens.assign(T * A, 0);
  p->sing.assign(T, -1);
  const uint8_t *row0 = sp.at(0, f);
  bool constant = W > 0 && same_len;
  for (int64_t r = 1; constant && r < R; ++r)
    constant = memcmp(sp.at(r, f), row0, l0) == 0;
  if (constant) {
    // every tracked position a zero-bit singleton; the overflow tree
    // a singleton too where the tail's chars are all one
    p->const_len = l0;
    for (int64_t i = 0; i < P; ++i) p->sing[i] = row0[i];
    if (W > P) {
      std::vector<int64_t> counts(A, 0);
      for (int64_t i = P; i < W; ++i) counts[row0[i]] += R;
      if (std::count(counts.begin(), counts.end(), 0) == A - 1) {
        p->sing[T - 1] = row0[P];
      } else {
        int32_t unused;
        if (!build_rows(counts.data(), 1, A, max_len, &p->lens[(T - 1) * A],
                        &unused, n_err))
          return false;
      }
    }
    return true;
  }
  // one tree a position up to max_positions, the rest on the overflow
  // tree; the rows of `rep` alone where it is given
  auto stats = [&](const uint8_t *rep, std::vector<int64_t> *counts) {
    counts->assign(T * A, 0);
    for (int64_t r = 0; r < R; ++r) {
      if (rep && !rep[r]) continue;
      const uint8_t *s = sp.at(r, f);
      const int32_t n = sp.len(r, f);
      for (int32_t i = 0; i < n; ++i)
        ++(*counts)[std::min<int64_t>(i, T - 1) * A + s[i]];
    }
  };
  auto emit_bits = [&](const std::vector<int64_t> &counts,
                       const TitleField &t) {
    int64_t bits = 0;
    for (int64_t i = 0; i < T * A; ++i) bits += counts[i] * t.lens[i];
    for (int64_t i = 0; i < T; ++i)
      bits += table_cost_bits(&t.lens[i * A], A, t.sing[i]);
    return bits;
  };
  std::vector<int64_t> counts;
  stats(nullptr, &counts);
  if (!build_rows(counts.data(), T, A, max_len, p->lens.data(),
                  p->sing.data(), n_err))
    return false;
  p->const_len = same_len ? l0 : -1;
  p->len_width = same_len ? 0 : std::max<int64_t>(1, bits_of(W));
  // per-32-record block constancy, where it emits fewer exact bits: a
  // block whose records hold the same bytes emits its first record's
  if (R < 2 || W == 0) return true;
  const int64_t nB = (R + kTitleBlock - 1) / kTitleBlock;
  std::vector<uint8_t> blk(nB, 1);
  for (int64_t r = 0; r < R; ++r) {
    const int64_t r0 = r / kTitleBlock * kTitleBlock;
    if (sp.len(r, f) != sp.len(r0, f) ||
        memcmp(sp.at(r, f), sp.at(r0, f), sp.len(r, f)) != 0)
      blk[r / kTitleBlock] = 0;
  }
  if (R % kTitleBlock == 1) blk[nB - 1] = 0;  // a block of one saves nothing
  if (std::find(blk.begin(), blk.end(), 1) == blk.end()) return true;
  std::vector<uint8_t> rep(R);
  for (int64_t r = 0; r < R; ++r)
    rep[r] = !blk[r / kTitleBlock] || r % kTitleBlock == 0;
  std::vector<int64_t> counts_b;
  stats(rep.data(), &counts_b);
  TitleField b;
  b.lens.resize(T * A);
  b.sing.resize(T);
  if (!build_rows(counts_b.data(), T, A, max_len, b.lens.data(),
                  b.sing.data(), n_err))
    return false;
  if (emit_bits(counts_b, b) + nB + 16 < emit_bits(counts, *p)) {
    p->lens.swap(b.lens);
    p->sing.swap(b.sing);
    p->blk_const.swap(blk);
  }
  return true;
}

// Writes the len low bits of code MSB first at bit off of words.
inline void put_code(uint32_t *words, int64_t off, uint32_t code, int64_t len) {
  if (len == 0) return;
  const int64_t w = off >> 5;
  const int64_t room = 32 - (off & 31);
  if (len <= room) {
    words[w] |= code << (room - len);
  } else {
    words[w] |= code >> (len - room);
    words[w + 1] |= code << (32 - (len - room));
  }
}

// The columns of the per-field matrix phyngsc_title_encode returns
// (utils/native.py TITLE_COLUMNS names them).
constexpr int kTitleCols = 16;

}  // namespace

// What phyngsc_title_encode gives: counts, and arrays that its handle owns
// until phyngsc_title_free.
struct TitleEncoded {
  int64_t error;  // > 0: an alphabet of this many symbols cannot fit
  int64_t n_seps, n_fields, n_trees, n_huf, n_blocks, n_raw, n_bconst;
  int64_t n_fixed, n_char, n_sub;
  const uint8_t *seps;          // (n_seps,): n_fields - 1
  const int64_t *fields;        // (n_fields, kTitleCols)
  const uint8_t *tree_lens;     // (n_trees, 256): the char fields' trees
  const int32_t *tree_sing;     // (n_trees,)
  const uint8_t *huf_lens;      // (n_huf,): the NUM_HUF trees
  const uint8_t *blk_flags;     // (n_blocks,): the NUM_BLOCK fields'
  const uint64_t *blk_a;        // (n_blocks,)
  const uint64_t *blk_d;        // (n_blocks,)
  const uint64_t *blk_raw;      // (n_raw,)
  const uint8_t *blk_const;     // (n_bconst,): the char fields'
  const uint32_t *fixed_words;  // (n_fixed,)
  const uint32_t *char_words;   // (n_char,)
  const int32_t *sub_n_words;   // (n_sub,)
};

namespace {

struct TitleResult {  // the arrays a TitleEncoded points into
  std::vector<uint8_t> seps, tree_lens, huf_lens, blk_flags, blk_const;
  std::vector<int64_t> fields;
  std::vector<int32_t> tree_sing, sub_n_words;
  std::vector<uint64_t> blk_a, blk_d, blk_raw;
  std::vector<uint32_t> fixed_words, char_words;
};

}  // namespace

// The title stream's whole encode (models/title.py encode, whose numpy
// version PHYNGSC_NO_NATIVE=1 selects), decision for decision: the field
// schema of TitleContext.build (the raw single field where titles
// disagree on their separators), each field's plan (analyze), the fixed
// stream's words, and the char stream's words and substream word counts as
// substream_layout_np and pack_bits_scatter_np lay them out at G records a
// substream over Rp rows. titles: (R, TL), R >= 1. Fills *out and returns
// the handle that owns its arrays, for phyngsc_title_free; out->error > 0
// where a tree's alphabet cannot fit max_code_len bits (huffman's
// ValueError).
void *phyngsc_title_encode(const uint8_t *titles, const int32_t *tlens,
                           int64_t R, int64_t TL, const uint8_t *sep_tab,
                           int32_t max_code_len, int64_t max_positions,
                           int64_t G, int64_t Rp, TitleEncoded *out) {
  TitleResult *res = new TitleResult;
  memset(out, 0, sizeof(*out));
  // the schema: every title's separators, as many as the first title's
  // and the same chars; each chunk of titles notes where one disagrees
  // and which fields are not numeric in one of its titles
  int32_t ns = 0;
  for (int32_t i = 0; i < tlens[0]; ++i) ns += sep_tab[titles[i]] != 0;
  std::unique_ptr<int32_t[]> sep_pos(new int32_t[R * ns]);
  std::unique_ptr<int64_t[]> values(new int64_t[R * (ns + 1)]);  // (F, R)
  std::vector<uint8_t> seps(ns), ok0(ns + 1);
  std::vector<int64_t> v0(ns + 1);
  scan_title(titles, tlens[0], sep_tab, ns, sep_pos.get(), seps.data(),
             v0.data(), ok0.data());
  const int k = phyngsc::chunk_count(R, ROWS_GRAIN);
  // a chunk's row: the schema held, then each field numeric throughout
  std::vector<uint8_t> held((size_t)k * (ns + 2), 1);
  phyngsc::parallel_chunks(R, k, [&](int c, int64_t r0, int64_t r1) {
    std::vector<uint8_t> chars(ns), ok(ns + 1);
    std::vector<int64_t> v(ns + 1);
    uint8_t *h = &held[(size_t)c * (ns + 2)];
    for (int64_t r = r0; r < r1; ++r) {
      h[0] &= scan_title(titles + r * TL, tlens[r], sep_tab, ns,
                         sep_pos.get() + r * ns, chars.data(), v.data(),
                         ok.data()) == ns &&
              std::equal(chars.begin(), chars.end(), seps.begin());
      for (int32_t f = 0; f <= ns; ++f) {
        h[f + 1] &= ok[f];
        values[f * R + r] = v[f];
      }
    }
  });
  bool fields_ok = true;
  std::vector<uint8_t> numeric(ns + 1, 1);
  for (int c = 0; c < k; ++c) {
    const uint8_t *h = &held[(size_t)c * (ns + 2)];
    fields_ok = fields_ok && h[0];
    for (int32_t f = 0; f <= ns; ++f) numeric[f] &= h[f + 1];
  }
  const int64_t F = fields_ok ? ns + 1 : 1;
  // the raw field: one whole-title char field (its titles hold separators,
  // so it is never numeric)
  if (!fields_ok) numeric[0] = 0;
  const TitleSpans sp{titles, TL, tlens, sep_pos.get(), fields_ok ? ns : 0,
                      F};
  // the fields' plans, split over the pool where the sub-block is large;
  // the first field in order whose tree cannot fit raises
  std::vector<TitleField> plans(F);
  std::vector<const int64_t *> vals(F);  // a numeric field's R values
  std::vector<int64_t> n_err(F, 0);
  phyngsc::parallel_for(F, std::max<int64_t>(1, 16 * ROWS_GRAIN / R),
                        [&](int, int64_t f0, int64_t f1) {
    for (int64_t f = f0; f < f1; ++f) {
      TitleField &p = plans[f];
      if (numeric[f]) {
        vals[f] = values.get() + f * R;
        plan_numeric(vals[f], R, max_code_len, &p);
      } else {
        plan_char(sp, f, R, max_code_len, max_positions, &p, &n_err[f]);
      }
    }
  });
  for (int64_t f = 0; f < F; ++f) {
    if (n_err[f]) {
      out->error = n_err[f];
      return res;
    }
  }
  // the fixed stream: each record's numeric chunks and variable field
  // lengths at one stride
  int64_t stride = 0;
  for (const TitleField &p : plans) {
    if (p.kind == kNumeric && (p.mode == kValue || p.mode == kDelta))
      stride += p.width;
    else if (p.kind == kChar && p.const_len < 0)
      stride += p.len_width;
  }
  res->fixed_words.assign((R * stride + 31) / 32, 0);
  // 32 records a group: each group's bits start on a word of their own
  phyngsc::parallel_for((R + 31) / 32, ROWS_GRAIN / 32,
                        [&](int, int64_t g0, int64_t g1) {
    uint32_t *words = res->fixed_words.data();
    for (int64_t r = g0 * 32; r < std::min(g1 * 32, R); ++r) {
      int64_t off = r * stride;
      for (int64_t f = 0; f < F; ++f) {
        const TitleField &p = plans[f];
        if (p.kind == kChar) {
          if (p.const_len < 0) {
            put_code(words, off, sp.len(r, f), p.len_width);
            off += p.len_width;
          }
          continue;
        }
        if (p.width == 0 || (p.mode != kValue && p.mode != kDelta)) continue;
        const int64_t *v = vals[f];
        const uint64_t enc = p.mode == kValue ? v[r] - p.base
                             : r ? v[r] - v[r - 1] - p.base : 0;
        // chunk_widths: the top width - 16 (n - 1) bits, then 16 at a time
        for (int64_t left = p.width; left > 0;) {
          const int64_t w = left - 16 * ((left - 1) / 16);
          left -= w;
          put_code(words, off, (uint32_t)((enc >> left) & ((1u << w) - 1)),
                   w);
          off += w;
        }
      }
    }
  });
  // the char stream: the walk trees' canonical codes, then each record's
  // symbols in field order (a NUM_HUF field's one, a char field's bytes
  // where its block emits them), each substream from a word of its own
  std::vector<int64_t> walk;
  for (int64_t f = 0; f < F; ++f) {
    TitleField &p = plans[f];
    if (p.kind == kNumeric ? p.mode != kHuf
        : p.max_len == 0 ||
          (p.const_len >= 0 &&
           std::all_of(p.sing.begin(), p.sing.end(),
                       [](int32_t s) { return s >= 0; })))
      continue;
    walk.push_back(f);
    p.codes.resize(p.lens.size());
    const int32_t A = p.kind == kChar ? kTitleAlpha : (int32_t)p.alpha;
    for (size_t t = 0; t < p.lens.size(); t += A)
      canonical_row(&p.lens[t], A, max_code_len, &p.codes[t]);
  }
  auto record = [&](int64_t r, auto &&emit) {
    for (int64_t f : walk) {
      const TitleField &p = plans[f];
      if (p.kind == kNumeric) {
        const int64_t *v = vals[f];
        const int64_t s = p.hsub == kValue ? v[r] - p.base
                          : r ? v[r] - v[r - 1] - p.base : 0;
        emit(p.codes[s], p.lens[s]);
        continue;
      }
      if (!p.blk_const.empty() && p.blk_const[r / kTitleBlock] &&
          r % kTitleBlock)
        continue;  // a constant block's records after its first
      const uint8_t *s = sp.at(r, f);
      const int32_t n = sp.len(r, f);
      const int64_t last = (int64_t)p.sing.size() - 1;
      for (int32_t i = 0; i < n; ++i) {
        const int64_t k = std::min<int64_t>(i, last) * kTitleAlpha + s[i];
        emit(p.codes[k], p.lens[k]);
      }
    }
  };
  const int64_t S = Rp / G;
  res->sub_n_words.assign(S, 0);
  std::vector<int64_t> sub_start(S + 1, 0);
  if (!walk.empty()) {
    std::vector<int64_t> bits(S, 0);
    phyngsc::parallel_for(S, ROWS_GRAIN / G + 1, [&](int, int64_t s0,
                                                     int64_t s1) {
      for (int64_t s = s0; s < s1; ++s)
        for (int64_t r = s * G; r < std::min((s + 1) * G, R); ++r)
          record(r, [&](uint32_t, int64_t len) { bits[s] += len; });
    });
    for (int64_t s = 0; s < S; ++s) {
      res->sub_n_words[s] = (int32_t)((bits[s] + 31) / 32);
      sub_start[s + 1] = sub_start[s] + res->sub_n_words[s];
    }
  }
  res->char_words.assign(sub_start[S], 0);
  if (sub_start[S]) {
    phyngsc::parallel_for(S, ROWS_GRAIN / G + 1, [&](int, int64_t s0,
                                                     int64_t s1) {
      uint32_t *words = res->char_words.data();
      for (int64_t s = s0; s < s1; ++s) {
        int64_t off = sub_start[s] * 32;
        for (int64_t r = s * G; r < std::min((s + 1) * G, R); ++r)
          record(r, [&](uint32_t code, int64_t len) {
            put_code(words, off, code, len);
            off += len;
          });
      }
    });
  }
  // the plans, flat
  if (fields_ok) res->seps.swap(seps);
  for (const TitleField &p : plans) {
    const int64_t row[kTitleCols] = {
        p.kind, p.mode, p.width, p.base, p.first, p.dwidth, p.hsub, p.alpha,
        p.huf_sing, p.max_len, p.const_len, p.len_width,
        (int64_t)p.sing.size(), (int64_t)p.flags.size(),
        (int64_t)p.blk_raw.size(), (int64_t)p.blk_const.size()};
    res->fields.insert(res->fields.end(), row, row + kTitleCols);
    auto &lens = p.kind == kChar ? res->tree_lens : res->huf_lens;
    lens.insert(lens.end(), p.lens.begin(), p.lens.end());
    res->tree_sing.insert(res->tree_sing.end(), p.sing.begin(), p.sing.end());
    res->blk_flags.insert(res->blk_flags.end(), p.flags.begin(),
                          p.flags.end());
    res->blk_a.insert(res->blk_a.end(), p.blk_a.begin(), p.blk_a.end());
    res->blk_d.insert(res->blk_d.end(), p.blk_d.begin(), p.blk_d.end());
    res->blk_raw.insert(res->blk_raw.end(), p.blk_raw.begin(),
                        p.blk_raw.end());
    res->blk_const.insert(res->blk_const.end(), p.blk_const.begin(),
                          p.blk_const.end());
  }
  out->n_seps = (int64_t)res->seps.size();
  out->n_fields = F;
  out->n_trees = (int64_t)res->tree_sing.size();
  out->n_huf = (int64_t)res->huf_lens.size();
  out->n_blocks = (int64_t)res->blk_flags.size();
  out->n_raw = (int64_t)res->blk_raw.size();
  out->n_bconst = (int64_t)res->blk_const.size();
  out->n_fixed = (int64_t)res->fixed_words.size();
  out->n_char = (int64_t)res->char_words.size();
  out->n_sub = S;
  out->seps = res->seps.data();
  out->fields = res->fields.data();
  out->tree_lens = res->tree_lens.data();
  out->tree_sing = res->tree_sing.data();
  out->huf_lens = res->huf_lens.data();
  out->blk_flags = res->blk_flags.data();
  out->blk_a = res->blk_a.data();
  out->blk_d = res->blk_d.data();
  out->blk_raw = res->blk_raw.data();
  out->blk_const = res->blk_const.data();
  out->fixed_words = res->fixed_words.data();
  out->char_words = res->char_words.data();
  out->sub_n_words = res->sub_n_words.data();
  return res;
}

void phyngsc_title_free(void *handle) {
  delete static_cast<TitleResult *>(handle);
}

}  // extern "C"
