// zett_tpu native host library.
//
// TPU-era replacement for the reference's Rust components (SURVEY §2.2):
// the tokenizer-sampling substring enumerator (rust_utils/src/lib.rs:113-158),
// the HF tokenizers Unigram Viterbi encode hot loop (zett/collator.py:166),
// and the pyahocorasick automaton used for substring priors
// (zett/compute_prior.py:95-106).
//
// Everything operates on RAW BYTES: the byte-level pipeline maps text to the
// GPT-2 byte alphabet 1:1, so Python converts byte-char strings to bytes at
// the boundary and this library never touches unicode.
//
// C ABI (ctypes); all functions are thread-compatible (no shared mutable
// globals; handles are not thread-safe individually).

#include <algorithm>
#include <cassert>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// --------------------------------------------------------------------------
// serde_json float canonicalization.
//
// HF `tokenizers` deserializes tokenizer.json through Rust's serde_json,
// whose default f64 parsing is NOT correctly rounded: it computes
// fl(fl(significand) * 10^k) with one rounding per step, which differs from
// the correctly-rounded value (what Python's json produces) by 1 ulp for
// ~25% of real Unigram scores. Byte-exact Viterbi parity with HF therefore
// requires holding the scores HF actually holds. serde_canon maps a
// correctly-rounded double to the value serde_json would have produced when
// parsing that double's shortest decimal representation (which is what both
// serde_json's and Python's serializers emit). Empirically a fixed point:
// serde_canon(serde_canon(x)) == serde_canon(x).
void serde_canon(const double* in, double* out, int64_t n) {
  // serde's table holds the f64 literals 1e0..1e308 (nearest doubles);
  // strtod is correctly rounded, so it reproduces them exactly
  static const std::vector<double>& POW10 = *[] {
    auto* t = new std::vector<double>(309);
    char b[16];
    for (int k = 0; k < 309; ++k) {
      std::snprintf(b, sizeof(b), "1e%d", k);
      (*t)[k] = std::strtod(b, nullptr);
    }
    return t;
  }();
  char buf[64];
  for (int64_t i = 0; i < n; ++i) {
    double x = in[i];
    if (!std::isfinite(x)) {
      out[i] = x;
      continue;
    }
    // shortest round-trip decimal (same digits serde_json/Python emit)
    auto res = std::to_chars(buf, buf + sizeof(buf), x);
    *res.ptr = '\0';
    const char* p = buf;
    bool neg = *p == '-';
    if (neg) ++p;
    // collect digits and the effective base-10 exponent
    uint64_t sig = 0;
    int exp10 = 0;
    int n_digits = 0;
    for (; *p && *p != 'e' && *p != 'E'; ++p) {
      if (*p == '.') {
        exp10 = -1000000;  // marker: count fraction digits from here
        continue;
      }
      sig = sig * 10 + (uint64_t)(*p - '0');
      ++n_digits;
      if (exp10 <= -1000000) --exp10;  // fraction digit
    }
    int frac = exp10 <= -1000000 ? -(exp10 + 1000000) : 0;
    int e = 0;
    if (*p == 'e' || *p == 'E') e = (int)strtol(p + 1, nullptr, 10);
    int exponent = e - frac;
    double f = (double)sig;  // rounds when sig > 2^53 (the serde behavior)
    if (exponent >= 0) {
      // shortest-repr doubles keep |exponent| <= 308 + 17 digits; clamp like
      // serde's overflow path would never trigger for round-tripped values
      f *= POW10[std::min(exponent, 308)];
    } else {
      f /= POW10[std::min(-exponent, 308)];
    }
    out[i] = neg ? -f : f;
  }
}

// --------------------------------------------------------------------------
// Unigram model: trie + Viterbi
// --------------------------------------------------------------------------

struct TrieNode {
  // child array index by byte, -1 = none; stored in a flat pool
  int32_t children[256];
  int32_t piece_id;  // -1 if not terminal
};

struct UnigramModel {
  std::vector<TrieNode> nodes;
  std::vector<double> scores;
  double unk_score;
  int32_t unk_id;
  size_t max_piece_len;
  // memo cache: pretoken bytes -> encoded ids
  std::unordered_map<std::string, std::vector<int32_t>> cache;
  size_t cache_cap;
};

static int32_t trie_add_node(UnigramModel* m) {
  m->nodes.emplace_back();
  TrieNode& n = m->nodes.back();
  std::memset(n.children, -1, sizeof(n.children));
  n.piece_id = -1;
  return (int32_t)(m->nodes.size() - 1);
}

void* uni_new(const uint8_t* piece_data, const int64_t* piece_offsets,
              const double* scores, int64_t n_pieces, int32_t unk_id,
              double unk_penalty, int64_t cache_cap) {
  auto* m = new UnigramModel();
  m->nodes.reserve(1 << 16);
  trie_add_node(m);
  m->scores.assign(scores, scores + n_pieces);
  double min_score = 0.0;
  m->max_piece_len = 1;
  for (int64_t i = 0; i < n_pieces; ++i) {
    if (scores[i] < min_score) min_score = scores[i];
    const uint8_t* begin = piece_data + piece_offsets[i];
    const uint8_t* end = piece_data + piece_offsets[i + 1];
    size_t len = (size_t)(end - begin);
    if (len == 0) continue;
    if (len > m->max_piece_len) m->max_piece_len = len;
    int32_t node = 0;
    for (const uint8_t* p = begin; p != end; ++p) {
      int32_t nxt = m->nodes[node].children[*p];
      if (nxt < 0) {
        nxt = trie_add_node(m);
        m->nodes[node].children[*p] = nxt;
      }
      node = nxt;
    }
    // first occurrence wins (HF semantics)
    if (m->nodes[node].piece_id < 0) m->nodes[node].piece_id = (int32_t)i;
  }
  m->unk_score = min_score - unk_penalty;
  m->unk_id = unk_id;
  m->cache_cap = (size_t)cache_cap;
  return m;
}

void uni_free(void* handle) { delete (UnigramModel*)handle; }

// Reusable DP scratch: avoids three heap allocations per pretoken (the
// per-call malloc dominated short-pretoken Viterbi before this).
struct ViterbiScratch {
  std::vector<double> best;
  std::vector<int32_t> back_begin;
  std::vector<int32_t> back_id;
};

// Open-addressing memo cache: pretoken bytes -> encoded ids. The encode hot
// path is hit-dominated (Zipfian corpora repeat pretokens heavily), and a
// std::unordered_map<std::string, vector> pays a string copy + node hop on
// EVERY lookup. This map hashes straight off the text buffer (no key copy on
// hits), stores keys and ids in flat arenas, and probes linearly — the hit
// path is one hash, one probe, one memcmp, one memcpy of the ids.
struct MemoCache {
  struct Slot {
    uint32_t hash;
    uint32_t key_off, key_len;  // key_len == 0 marks an empty slot
    uint32_t ids_off, ids_len;
  };
  std::vector<Slot> slots;
  std::string keys;           // key arena
  std::vector<int32_t> ids;   // ids arena
  size_t count = 0;
  size_t mask;

  explicit MemoCache(size_t init_pow2 = 1 << 14) {
    slots.assign(init_pow2, Slot{0, 0, 0, 0, 0});
    mask = init_pow2 - 1;
    keys.reserve(init_pow2 * 8);
    ids.reserve(init_pow2 * 2);
  }

  static inline uint32_t fnv1a(const uint8_t* s, size_t n) {
    uint32_t h = 0x811C9DC5u;
    for (size_t i = 0; i < n; ++i) h = (h ^ s[i]) * 0x01000193u;
    // avalanche the low bits (we index with & mask)
    h ^= h >> 15;
    h *= 0x2C1B3C6Du;
    h ^= h >> 12;
    return h;
  }

  // returns slot index of the key, or the insertion point (empty slot)
  inline size_t probe(uint32_t h, const uint8_t* s, size_t n) const {
    size_t i = h & mask;
    while (true) {
      const Slot& sl = slots[i];
      if (sl.key_len == 0) return i;
      if (sl.hash == h && sl.key_len == (uint32_t)n &&
          std::memcmp(keys.data() + sl.key_off, s, n) == 0)
        return i;
      i = (i + 1) & mask;
    }
  }

  inline const Slot* find(uint32_t h, const uint8_t* s, size_t n) const {
    const Slot& sl = slots[probe(h, s, n)];
    return sl.key_len ? &sl : nullptr;
  }

  void grow() {
    std::vector<Slot> old;
    old.swap(slots);
    slots.assign(old.size() * 2, Slot{0, 0, 0, 0, 0});
    mask = slots.size() - 1;
    for (const Slot& sl : old) {
      if (!sl.key_len) continue;
      size_t i = sl.hash & mask;
      while (slots[i].key_len) i = (i + 1) & mask;
      slots[i] = sl;
    }
  }

  // insert (key must be absent); returns the ids range
  inline Slot insert(uint32_t h, const uint8_t* s, size_t n,
                     const std::vector<int32_t>& v) {
    if ((count + 1) * 4 >= slots.size() * 3) grow();
    // offsets are stored as uint32_t; past 4 GiB of accumulated key/id bytes
    // they would silently wrap and corrupt lookups
    assert(keys.size() <= UINT32_MAX && ids.size() <= UINT32_MAX);
    if (keys.size() > UINT32_MAX || ids.size() > UINT32_MAX) abort();
    size_t i = probe(h, s, n);
    Slot& sl = slots[i];
    sl.hash = h;
    sl.key_off = (uint32_t)keys.size();
    sl.key_len = (uint32_t)n;
    keys.append((const char*)s, n);
    sl.ids_off = (uint32_t)ids.size();
    sl.ids_len = (uint32_t)v.size();
    ids.insert(ids.end(), v.begin(), v.end());
    ++count;
    return sl;
  }
};

// Viterbi over one pretoken; appends ids to out. Returns count appended.
static size_t uni_viterbi(UnigramModel* m, const uint8_t* s, size_t n,
                          std::vector<int32_t>& out, ViterbiScratch& sc) {
  constexpr double NEG = -std::numeric_limits<double>::infinity();
  sc.best.assign(n + 1, NEG);
  sc.back_begin.assign(n + 1, -1);
  sc.back_id.assign(n + 1, -1);
  std::vector<double>& best = sc.best;
  std::vector<int32_t>& back_begin = sc.back_begin;
  std::vector<int32_t>& back_id = sc.back_id;
  best[0] = 0.0;
  for (size_t begin = 0; begin < n; ++begin) {
    if (best[begin] == NEG) continue;
    int32_t node = 0;
    bool has_single = false;
    size_t max_end = std::min(n, begin + m->max_piece_len);
    for (size_t end = begin; end < max_end; ++end) {
      node = m->nodes[node].children[s[end]];
      if (node < 0) break;
      int32_t pid = m->nodes[node].piece_id;
      if (pid >= 0) {
        if (end == begin) has_single = true;
        double cand = best[begin] + m->scores[pid];
        if (cand > best[end + 1]) {
          best[end + 1] = cand;
          back_begin[end + 1] = (int32_t)begin;
          back_id[end + 1] = pid;
        }
      }
    }
    if (!has_single) {
      double cand = best[begin] + m->unk_score;
      if (cand > best[begin + 1]) {
        best[begin + 1] = cand;
        back_begin[begin + 1] = (int32_t)begin;
        back_id[begin + 1] = -1;  // unk marker
      }
    }
  }
  // backtrack
  size_t start_size = out.size();
  size_t pos = n;
  while (pos > 0) {
    int32_t pid = back_id[pos];
    out.push_back(pid >= 0 ? pid : m->unk_id);
    pos = (size_t)back_begin[pos];
  }
  std::reverse(out.begin() + start_size, out.end());
  return out.size() - start_size;
}

// Threaded batch encode: pretokens are independent, so shards run on
// worker threads with thread-local memo caches; results are stitched with a
// prefix-sum pass. Returns total ids written, or -1 on insufficient capacity.
int64_t uni_encode_batch_threaded(void* handle, const uint8_t* text,
                                  const int64_t* offsets, int64_t n_pretokens,
                                  int32_t* out_ids, int64_t out_cap,
                                  int32_t* out_lens, int32_t n_threads) {
  auto* m = (UnigramModel*)handle;
  if (n_threads <= 1 || n_pretokens < 1024) n_threads = 1;
  std::vector<std::vector<int32_t>> results((size_t)n_threads);
  std::vector<std::thread> workers;
  int64_t chunk = (n_pretokens + n_threads - 1) / n_threads;
  auto work = [&](int t) {
    MemoCache cache;
    ViterbiScratch sc;
    std::vector<int32_t>& out = results[(size_t)t];
    std::vector<int32_t> buf;
    int64_t lo = t * chunk, hi = std::min(n_pretokens, (t + 1) * chunk);
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* s = text + offsets[i];
      size_t n = (size_t)(offsets[i + 1] - offsets[i]);
      if (n == 0) {
        out_lens[i] = 0;
        continue;
      }
      uint32_t h = MemoCache::fnv1a(s, n);
      const MemoCache::Slot* sl = cache.find(h, s, n);
      MemoCache::Slot tmp;
      if (!sl) {
        buf.clear();
        uni_viterbi(m, s, n, buf, sc);
        tmp = cache.insert(h, s, n, buf);
        sl = &tmp;
      }
      out_lens[i] = (int32_t)sl->ids_len;
      out.insert(out.end(), cache.ids.data() + sl->ids_off,
                 cache.ids.data() + sl->ids_off + sl->ids_len);
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    for (int t = 0; t < n_threads; ++t) workers.emplace_back(work, t);
    for (auto& w : workers) w.join();
  }
  int64_t total = 0;
  for (auto& r : results) total += (int64_t)r.size();
  if (total > out_cap) return -1;
  int64_t pos = 0;
  for (auto& r : results) {
    std::memcpy(out_ids + pos, r.data(), r.size() * sizeof(int32_t));
    pos += (int64_t)r.size();
  }
  return total;
}

// Encode a batch of pretokens (concatenated bytes + offsets). Writes ids to
// out_ids (capacity out_cap) and per-pretoken lengths to out_lens. Returns
// total ids written, or -1 if capacity insufficient.
int64_t uni_encode_batch(void* handle, const uint8_t* text,
                         const int64_t* offsets, int64_t n_pretokens,
                         int32_t* out_ids, int64_t out_cap,
                         int32_t* out_lens) {
  auto* m = (UnigramModel*)handle;
  std::vector<int32_t> buf;
  ViterbiScratch sc;
  int64_t total = 0;
  std::string key;
  for (int64_t i = 0; i < n_pretokens; ++i) {
    const uint8_t* s = text + offsets[i];
    size_t n = (size_t)(offsets[i + 1] - offsets[i]);
    key.assign((const char*)s, n);
    auto it = m->cache.find(key);
    const std::vector<int32_t>* ids;
    if (it != m->cache.end()) {
      ids = &it->second;
    } else {
      buf.clear();
      uni_viterbi(m, s, n, buf, sc);
      if (m->cache.size() < m->cache_cap) {
        ids = &m->cache.emplace(std::move(key), buf).first->second;
      } else {
        ids = &buf;
      }
    }
    int64_t len = (int64_t)ids->size();
    if (total + len > out_cap) return -1;
    std::memcpy(out_ids + total, ids->data(), len * sizeof(int32_t));
    out_lens[i] = (int32_t)len;
    total += len;
  }
  return total;
}

// Viterbi score only (log-prob of best segmentation) per pretoken.
void uni_score_batch(void* handle, const uint8_t* text, const int64_t* offsets,
                     int64_t n_pretokens, double* out_scores) {
  auto* m = (UnigramModel*)handle;
  std::vector<int32_t> buf;
  ViterbiScratch sc;
  for (int64_t i = 0; i < n_pretokens; ++i) {
    const uint8_t* s = text + offsets[i];
    size_t n = (size_t)(offsets[i + 1] - offsets[i]);
    buf.clear();
    uni_viterbi(m, s, n, buf, sc);
    double score = 0.0;
    for (int32_t pid : buf) score += (pid >= 0 && pid != m->unk_id) ? m->scores[pid] : m->unk_score;
    // note: unk pieces that coincide with a real unk_id piece use its score;
    // close enough for scoring (exact per-id score reused)
    out_scores[i] = score;
  }
}

// Forward-backward expected piece counts (the Unigram-EM E-step; the native
// replacement for the sentencepiece trainer's inner loop). For each weighted
// pretoken, accumulates the posterior expected count of every piece into
// out_counts and returns the total weighted log-likelihood.
static double uni_expected_counts_range(UnigramModel* m, const uint8_t* text,
                                        const int64_t* offsets, int64_t lo,
                                        int64_t hi, const double* weights,
                                        double* out_counts);

double uni_expected_counts(void* handle, const uint8_t* text,
                           const int64_t* offsets, int64_t n_pretokens,
                           const double* weights, double* out_counts) {
  return uni_expected_counts_range((UnigramModel*)handle, text, offsets, 0,
                                   n_pretokens, weights, out_counts);
}

// Threaded E-step: pretokens are embarrassingly parallel — shard across
// threads, each accumulating into its OWN counts vector (size vocab_size),
// then merge. Same pattern as uni_encode_batch_threaded.
double uni_expected_counts_threaded(void* handle, const uint8_t* text,
                                    const int64_t* offsets,
                                    int64_t n_pretokens,
                                    const double* weights, double* out_counts,
                                    int64_t vocab_size, int32_t n_threads) {
  auto* m = (UnigramModel*)handle;
  if (n_threads <= 1 || n_pretokens < 256) {
    return uni_expected_counts_range(m, text, offsets, 0, n_pretokens,
                                     weights, out_counts);
  }
  std::vector<std::vector<double>> counts((size_t)n_threads);
  std::vector<double> lls((size_t)n_threads, 0.0);
  std::vector<std::thread> workers;
  int64_t chunk = (n_pretokens + n_threads - 1) / n_threads;
  auto work = [&](int t) {
    int64_t lo = (int64_t)t * chunk;
    int64_t hi = std::min(n_pretokens, lo + chunk);
    if (lo >= hi) return;
    counts[(size_t)t].assign((size_t)vocab_size, 0.0);
    lls[(size_t)t] = uni_expected_counts_range(
        m, text, offsets, lo, hi, weights, counts[(size_t)t].data());
  };
  for (int t = 0; t < n_threads; ++t) workers.emplace_back(work, t);
  for (auto& w : workers) w.join();
  double total_ll = 0.0;
  for (int t = 0; t < n_threads; ++t) {
    total_ll += lls[(size_t)t];
    if (!counts[(size_t)t].empty()) {
      const double* src = counts[(size_t)t].data();
      for (int64_t i = 0; i < vocab_size; ++i) out_counts[i] += src[i];
    }
  }
  return total_ll;
}

static double uni_expected_counts_range(UnigramModel* m, const uint8_t* text,
                                        const int64_t* offsets, int64_t lo,
                                        int64_t hi, const double* weights,
                                        double* out_counts) {
  constexpr double NEG = -std::numeric_limits<double>::infinity();
  double total_ll = 0.0;
  std::vector<double> alpha, beta;
  struct Edge { int32_t begin, end, pid; double score; };
  std::vector<Edge> edges;
  for (int64_t t = lo; t < hi; ++t) {
    const uint8_t* s = text + offsets[t];
    size_t n = (size_t)(offsets[t + 1] - offsets[t]);
    if (n == 0) continue;
    double w = weights[t];
    edges.clear();
    for (size_t begin = 0; begin < n; ++begin) {
      int32_t node = 0;
      bool has_single = false;
      size_t max_end = std::min(n, begin + m->max_piece_len);
      for (size_t end = begin; end < max_end; ++end) {
        node = m->nodes[node].children[s[end]];
        if (node < 0) break;
        int32_t pid = m->nodes[node].piece_id;
        if (pid >= 0) {
          if (end == begin) has_single = true;
          edges.push_back({(int32_t)begin, (int32_t)(end + 1), pid, m->scores[pid]});
        }
      }
      if (!has_single) {
        edges.push_back({(int32_t)begin, (int32_t)(begin + 1), -1, m->unk_score});
      }
    }
    alpha.assign(n + 1, NEG);
    beta.assign(n + 1, NEG);
    alpha[0] = 0.0;
    auto logadd = [](double a, double b) {
      if (a == NEG) return b;
      if (b == NEG) return a;
      double hi = a > b ? a : b;
      return hi + std::log(std::exp(a - hi) + std::exp(b - hi));
    };
    for (const Edge& e : edges) {
      // edges are sorted by begin ascending; alpha[e.begin] is final because
      // every incoming edge into `begin` has begin' < begin
      if (alpha[e.begin] != NEG)
        alpha[e.end] = logadd(alpha[e.end], alpha[e.begin] + e.score);
    }
    beta[n] = 0.0;
    for (int64_t i = (int64_t)edges.size() - 1; i >= 0; --i) {
      const Edge& e = edges[i];
      if (beta[e.end] != NEG)
        beta[e.begin] = logadd(beta[e.begin], beta[e.end] + e.score);
    }
    double Z = alpha[n];
    if (Z == NEG) continue;
    total_ll += w * Z;
    for (const Edge& e : edges) {
      if (e.pid < 0 || alpha[e.begin] == NEG || beta[e.end] == NEG) continue;
      double post = std::exp(alpha[e.begin] + e.score + beta[e.end] - Z);
      out_counts[e.pid] += w * post;
    }
  }
  return total_ll;
}

// --------------------------------------------------------------------------
// GPT-2 split-regex pretokenizer (native scanner)
//
// Hand-coded leftmost-first scanner for
//   's|'t|'re|'ve|'m|'ll|'d| ?[\p{L}\p{M}]+| ?\p{N}+| ?[^\s\p{L}\p{N}]+
//   |\s+(?!\S)|\s+
// (reference: zett/utils.py:29 SPLIT_REGEX; the no-\p{M} variant at
// rust_utils/src/lib.rs:27 is selected by letters_mask). Character classes
// come from a caller-provided table generated with the Python `regex`
// module (one byte per codepoint; bits: 1=\s, 2=\p{L}, 4=\p{M}, 8=\p{N}),
// so class semantics match the Python fallback path by construction.
// --------------------------------------------------------------------------

enum { ZC_SPACE = 1, ZC_L = 2, ZC_M = 4, ZC_N = 8 };

static inline uint32_t u8_decode(const uint8_t* s, size_t n, size_t i,
                                 size_t* adv) {
  uint8_t b = s[i];
  if (b < 0x80) { *adv = 1; return b; }
  if ((b & 0xE0) == 0xC0 && i + 1 < n && (s[i + 1] & 0xC0) == 0x80) {
    *adv = 2;
    return ((uint32_t)(b & 0x1F) << 6) | (s[i + 1] & 0x3F);
  }
  if ((b & 0xF0) == 0xE0 && i + 2 < n && (s[i + 1] & 0xC0) == 0x80 &&
      (s[i + 2] & 0xC0) == 0x80) {
    *adv = 3;
    return ((uint32_t)(b & 0x0F) << 12) | ((uint32_t)(s[i + 1] & 0x3F) << 6) |
           (s[i + 2] & 0x3F);
  }
  if ((b & 0xF8) == 0xF0 && i + 3 < n && (s[i + 1] & 0xC0) == 0x80 &&
      (s[i + 2] & 0xC0) == 0x80 && (s[i + 3] & 0xC0) == 0x80) {
    *adv = 4;
    return ((uint32_t)(b & 0x07) << 18) | ((uint32_t)(s[i + 1] & 0x3F) << 12) |
           ((uint32_t)(s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
  }
  *adv = 1;
  return 0xFFFD;  // invalid byte: class "other" (never produced by Python str)
}

static inline uint8_t cls_at(const uint8_t* s, size_t n, size_t i,
                             const uint8_t* ctab, size_t* adv) {
  uint32_t cp = u8_decode(s, n, i, adv);
  return ctab[cp];
}

// End offset of the pretoken starting at byte i (i < n). letters_mask is
// ZC_L|ZC_M for the \p{M}-including regex, ZC_L for the no-marks variant.
static size_t pretoken_end(const uint8_t* s, size_t n, size_t i,
                           const uint8_t* ctab, uint8_t letters_mask) {
  const uint8_t kStops = ZC_SPACE | ZC_L | ZC_N;  // "other" = none of these
  size_t adv;
  uint8_t c0 = cls_at(s, n, i, ctab, &adv);
  uint8_t b = s[i];
  // branch 1: contractions (exact lowercase ASCII)
  if (b == '\'' && i + 1 < n) {
    uint8_t c1 = s[i + 1];
    if (c1 == 's' || c1 == 't' || c1 == 'm' || c1 == 'd') return i + 2;
    if (i + 2 < n) {
      uint8_t c2 = s[i + 2];
      if ((c1 == 'r' && c2 == 'e') || (c1 == 'v' && c2 == 'e') ||
          (c1 == 'l' && c2 == 'l'))
        return i + 3;
    }
  }
  size_t j = i + adv;
  uint8_t run_mask = 0;
  bool run_other = false;
  if (b == ' ') {
    if (j >= n) return n;  // trailing space: \s+(?!\S) to end
    size_t adv2;
    uint8_t c2 = cls_at(s, n, j, ctab, &adv2);
    if (c2 & letters_mask) { run_mask = letters_mask; j += adv2; }
    else if (c2 & ZC_N) { run_mask = ZC_N; j += adv2; }
    else if (!(c2 & kStops)) { run_other = true; j += adv2; }
    // else: whitespace run (falls through with run_mask=0, run_other=false)
  } else if (c0 & letters_mask) {
    run_mask = letters_mask;
  } else if (c0 & ZC_N) {
    run_mask = ZC_N;
  } else if (!(c0 & kStops)) {
    run_other = true;
  }
  if (run_mask) {
    while (j < n) {
      size_t a;
      uint8_t c = cls_at(s, n, j, ctab, &a);
      if (!(c & run_mask)) break;
      j += a;
    }
    return j;
  }
  if (run_other) {
    // [^\s\p{L}\p{N}]+ — note \p{M} continues this run in BOTH variants
    while (j < n) {
      size_t a;
      uint8_t c = cls_at(s, n, j, ctab, &a);
      if (c & kStops) break;
      j += a;
    }
    return j;
  }
  // whitespace branches: \s+(?!\S) (greedy run minus its last char when
  // followed by non-space) | \s+
  size_t last = i;
  j = i;
  while (j < n) {
    size_t a;
    uint8_t c = cls_at(s, n, j, ctab, &a);
    if (!(c & ZC_SPACE)) break;
    last = j;
    j += a;
  }
  if (j < n && last > i) return last;  // backtracked lookahead match
  return j;  // run to end, or a single whitespace char before non-space
}

// Split one text into pretokens; writes end offsets. Returns count or -1 on
// insufficient capacity. (Primarily a differential-test hook.)
int64_t split_pretokens(const uint8_t* text, int64_t n, const uint8_t* ctab,
                        int32_t letters_mask, int64_t* out_ends, int64_t cap) {
  int64_t cnt = 0;
  size_t i = 0;
  while ((int64_t)i < n) {
    size_t j = pretoken_end(text, (size_t)n, i, ctab, (uint8_t)letters_mask);
    if (cnt >= cap) return -1;
    out_ends[cnt++] = (int64_t)j;
    i = j;
  }
  return cnt;
}

// Fused split + Viterbi encode over whole texts: the collator hot path in
// one native call (reference splits in the HF Rust pre-tokenizer and
// encodes in the Unigram model, zett/collator.py:166-175). Texts are
// independent -> thread-sharded with thread-local memo caches keyed on
// pretoken bytes. Writes flat ids + per-TEXT token counts. Returns total
// ids, or -1 on insufficient capacity.
int64_t uni_encode_texts(void* handle, const uint8_t* text,
                         const int64_t* offsets, int64_t n_texts,
                         const uint8_t* ctab, int32_t letters_mask,
                         int32_t* out_ids, int64_t out_cap,
                         int64_t* out_text_tokens, int32_t n_threads) {
  auto* m = (UnigramModel*)handle;
  if (n_threads <= 1 || n_texts < 64) n_threads = 1;
  std::vector<std::vector<int32_t>> results((size_t)n_threads);
  std::vector<std::thread> workers;
  int64_t chunk = (n_texts + n_threads - 1) / n_threads;
  auto work = [&](int t) {
    MemoCache cache;
    ViterbiScratch sc;
    std::vector<int32_t>& out = results[(size_t)t];
    std::vector<int32_t> buf;
    int64_t lo = t * chunk, hi = std::min(n_texts, (t + 1) * chunk);
    for (int64_t ti = lo; ti < hi; ++ti) {
      const uint8_t* s = text + offsets[ti];
      size_t n = (size_t)(offsets[ti + 1] - offsets[ti]);
      int64_t n_tok = 0;
      size_t i = 0;
      while (i < n) {
        size_t j = pretoken_end(s, n, i, ctab, (uint8_t)letters_mask);
        uint32_t h = MemoCache::fnv1a(s + i, j - i);
        const MemoCache::Slot* sl = cache.find(h, s + i, j - i);
        MemoCache::Slot tmp;
        if (!sl) {
          buf.clear();
          uni_viterbi(m, s + i, j - i, buf, sc);
          tmp = cache.insert(h, s + i, j - i, buf);
          sl = &tmp;
        }
        out.insert(out.end(), cache.ids.data() + sl->ids_off,
                   cache.ids.data() + sl->ids_off + sl->ids_len);
        n_tok += (int64_t)sl->ids_len;
        i = j;
      }
      out_text_tokens[ti] = n_tok;
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    for (int t = 0; t < n_threads; ++t) workers.emplace_back(work, t);
    for (auto& w : workers) w.join();
  }
  int64_t total = 0;
  for (auto& r : results) total += (int64_t)r.size();
  if (total > out_cap) return -1;
  int64_t pos = 0;
  for (auto& r : results) {
    std::memcpy(out_ids + pos, r.data(), r.size() * sizeof(int32_t));
    pos += (int64_t)r.size();
  }
  return total;
}

// --------------------------------------------------------------------------
// BPE merge encode (reference: HF tokenizers Rust BPE, the encode path the
// reference's fixed-tokenizer workloads hit through zett/collator.py:166-175
// for BPE tokenizer.json files). Semantics match the Python model
// (tokenization/models.py BPE._merge_word): repeatedly merge the globally
// lowest-ranked adjacent pair, all occurrences left-to-right — which is the
// GPT-2 algorithm and is differential-tested against HF at 50k scale.
// Symbols are vocab ids: merge (a_id, b_id) -> (rank, merged_id).
// --------------------------------------------------------------------------

struct BPEModel {
  // (a<<32 | b) -> packed (rank, merged_id)
  std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> merge_map;
  std::unordered_map<std::string, int32_t> vocab_map;  // for ignore_merges
  int32_t byte_to_id[256];
  int32_t unk_id;      // -1 = drop unknown bytes silently
  bool ignore_merges;  // whole-pretoken vocab hit short-circuits (llama-3)
};

void* bpe_new(const uint8_t* piece_data, const int64_t* piece_offsets,
              const int32_t* piece_ids, int64_t n_pieces,
              const int32_t* merge_left, const int32_t* merge_right,
              const int32_t* merge_out, int64_t n_merges, int32_t unk_id,
              int32_t ignore_merges) {
  auto* m = new BPEModel();
  for (int i = 0; i < 256; ++i) m->byte_to_id[i] = -1;
  m->vocab_map.reserve((size_t)n_pieces * 2);
  for (int64_t i = 0; i < n_pieces; ++i) {
    const char* begin = (const char*)piece_data + piece_offsets[i];
    size_t len = (size_t)(piece_offsets[i + 1] - piece_offsets[i]);
    m->vocab_map.emplace(std::string(begin, len), piece_ids[i]);
    if (len == 1) m->byte_to_id[(uint8_t)begin[0]] = piece_ids[i];
  }
  m->merge_map.reserve((size_t)n_merges * 2);
  for (int64_t r = 0; r < n_merges; ++r) {
    uint64_t key = ((uint64_t)(uint32_t)merge_left[r] << 32) |
                   (uint64_t)(uint32_t)merge_right[r];
    // first (lowest) rank wins on duplicates, like the Python dict build
    m->merge_map.emplace(key, std::make_pair((int32_t)r, merge_out[r]));
  }
  m->unk_id = unk_id;
  m->ignore_merges = ignore_merges != 0;
  return m;
}

void bpe_free(void* handle) { delete (BPEModel*)handle; }

// Merge one pretoken; appends ids to out. Returns count appended.
static size_t bpe_merge_word(BPEModel* m, const uint8_t* s, size_t n,
                             std::vector<int32_t>& out,
                             std::vector<int32_t>& word) {
  size_t start_size = out.size();
  if (m->ignore_merges) {
    auto it = m->vocab_map.find(std::string((const char*)s, n));
    if (it != m->vocab_map.end()) {
      out.push_back(it->second);
      return 1;
    }
  }
  word.clear();
  for (size_t i = 0; i < n; ++i) {
    int32_t id = m->byte_to_id[s[i]];
    if (id >= 0) {
      word.push_back(id);
    } else if (m->unk_id >= 0) {
      word.push_back(m->unk_id);
    }
    // else: drop silently (byte-complete vocabs never hit this)
  }
  while (word.size() > 1) {
    int32_t best_rank = INT32_MAX;
    uint64_t best_key = 0;
    int32_t best_out = -1;
    for (size_t i = 0; i + 1 < word.size(); ++i) {
      uint64_t key = ((uint64_t)(uint32_t)word[i] << 32) |
                     (uint64_t)(uint32_t)word[i + 1];
      auto it = m->merge_map.find(key);
      if (it != m->merge_map.end() && it->second.first < best_rank) {
        best_rank = it->second.first;
        best_key = key;
        best_out = it->second.second;
      }
    }
    if (best_out < 0) break;
    int32_t a = (int32_t)(best_key >> 32), b = (int32_t)(uint32_t)best_key;
    size_t w = 0;
    for (size_t i = 0; i < word.size();) {
      if (i + 1 < word.size() && word[i] == a && word[i + 1] == b) {
        word[w++] = best_out;
        i += 2;
      } else {
        word[w++] = word[i++];
      }
    }
    word.resize(w);
  }
  out.insert(out.end(), word.begin(), word.end());
  return out.size() - start_size;
}

// Fused split + BPE merge encode over whole texts — the BPE counterpart of
// uni_encode_texts (same threading + thread-local memo cache; BPE pretokens
// repeat just as heavily). Returns total ids, or -1 on insufficient capacity.
int64_t bpe_encode_texts(void* handle, const uint8_t* text,
                         const int64_t* offsets, int64_t n_texts,
                         const uint8_t* ctab, int32_t letters_mask,
                         int32_t* out_ids, int64_t out_cap,
                         int64_t* out_text_tokens, int32_t n_threads) {
  auto* m = (BPEModel*)handle;
  if (n_threads <= 1 || n_texts < 64) n_threads = 1;
  std::vector<std::vector<int32_t>> results((size_t)n_threads);
  std::vector<std::thread> workers;
  int64_t chunk = (n_texts + n_threads - 1) / n_threads;
  auto work = [&](int t) {
    MemoCache cache;
    std::vector<int32_t>& out = results[(size_t)t];
    std::vector<int32_t> buf, word;
    int64_t lo = t * chunk, hi = std::min(n_texts, (t + 1) * chunk);
    for (int64_t ti = lo; ti < hi; ++ti) {
      const uint8_t* s = text + offsets[ti];
      size_t n = (size_t)(offsets[ti + 1] - offsets[ti]);
      int64_t n_tok = 0;
      size_t i = 0;
      while (i < n) {
        size_t j = pretoken_end(s, n, i, ctab, (uint8_t)letters_mask);
        uint32_t h = MemoCache::fnv1a(s + i, j - i);
        const MemoCache::Slot* sl = cache.find(h, s + i, j - i);
        MemoCache::Slot tmp;
        if (!sl) {
          buf.clear();
          bpe_merge_word(m, s + i, j - i, buf, word);
          tmp = cache.insert(h, s + i, j - i, buf);
          sl = &tmp;
        }
        out.insert(out.end(), cache.ids.data() + sl->ids_off,
                   cache.ids.data() + sl->ids_off + sl->ids_len);
        n_tok += (int64_t)sl->ids_len;
        i = j;
      }
      out_text_tokens[ti] = n_tok;
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    for (int t = 0; t < n_threads; ++t) workers.emplace_back(work, t);
    for (auto& w : workers) w.join();
  }
  int64_t total = 0;
  for (auto& r : results) total += (int64_t)r.size();
  if (total > out_cap) return -1;
  int64_t pos = 0;
  for (auto& r : results) {
    std::memcpy(out_ids + pos, r.data(), r.size() * sizeof(int32_t));
    pos += (int64_t)r.size();
  }
  return total;
}

// Batch variant over pre-split pretokens (differential-test hook, mirrors
// uni_encode_batch).
int64_t bpe_encode_batch(void* handle, const uint8_t* text,
                         const int64_t* offsets, int64_t n_pretokens,
                         int32_t* out_ids, int64_t out_cap,
                         int32_t* out_lens) {
  auto* m = (BPEModel*)handle;
  std::vector<int32_t> out, word;
  out.reserve((size_t)std::min<int64_t>(out_cap, 1 << 20));
  for (int64_t i = 0; i < n_pretokens; ++i) {
    const uint8_t* s = text + offsets[i];
    size_t n = (size_t)(offsets[i + 1] - offsets[i]);
    out_lens[i] = (int32_t)bpe_merge_word(m, s, n, out, word);
  }
  if ((int64_t)out.size() > out_cap) return -1;
  std::memcpy(out_ids, out.data(), out.size() * sizeof(int32_t));
  return (int64_t)out.size();
}

// --------------------------------------------------------------------------
// Substring enumeration for tokenizer sampling
// --------------------------------------------------------------------------

// Open-addressing substring counter (same design as MemoCache): keys live in
// a flat arena, hashes are computed INCREMENTALLY along substring length in
// the enumeration loops (extending s[start..k) to s[start..k+1) is O(1)), so
// a count update costs one probe + memcmp instead of a std::string
// construction + node-based map insert.
struct CountMap {
  struct Slot {
    uint32_t hash;
    uint32_t key_off, key_len;  // key_len == 0 marks an empty slot
    uint64_t value;
  };
  std::vector<Slot> slots;
  std::string keys;
  size_t count = 0;
  size_t mask;

  explicit CountMap(size_t init_pow2 = 1 << 16) {
    slots.assign(init_pow2, Slot{0, 0, 0, 0});
    mask = init_pow2 - 1;
    keys.reserve(init_pow2 * 4);
  }

  static inline uint32_t mix(uint32_t h) {
    h ^= h >> 15;
    h *= 0x2C1B3C6Du;
    h ^= h >> 12;
    return h;
  }

  void grow() {
    std::vector<Slot> old;
    old.swap(slots);
    slots.assign(old.size() * 2, Slot{0, 0, 0, 0});
    mask = slots.size() - 1;
    for (const Slot& sl : old) {
      if (!sl.key_len) continue;
      size_t i = mix(sl.hash) & mask;
      while (slots[i].key_len) i = (i + 1) & mask;
      slots[i] = sl;
    }
  }

  // h must be the raw incremental hash of s[0..n)
  inline void add(const uint8_t* s, uint32_t h, size_t n, uint64_t w) {
    size_t i = mix(h) & mask;
    while (true) {
      Slot& sl = slots[i];
      if (!sl.key_len) {
        if ((count + 1) * 4 >= slots.size() * 3) {
          grow();
          add(s, h, n, w);
          return;
        }
        // uint32_t offset ceiling (see MemoCache::insert)
        assert(keys.size() <= UINT32_MAX);
        if (keys.size() > UINT32_MAX) abort();
        sl.hash = h;
        sl.key_off = (uint32_t)keys.size();
        sl.key_len = (uint32_t)n;
        keys.append((const char*)s, n);
        sl.value = w;
        ++count;
        return;
      }
      if (sl.hash == h && sl.key_len == (uint32_t)n &&
          std::memcmp(keys.data() + sl.key_off, s, n) == 0) {
        sl.value += w;
        return;
      }
      i = (i + 1) & mask;
    }
  }
};

// incremental substring hash step (must match CountMap::add callers)
static inline uint32_t ch_step(uint32_t h, uint8_t b) {
  return h * 0x01000193u + b + 1;
}

// byte weight table: GPT-2 keeps '!'..'~', 0xA1..0xAC, 0xAE..0xFF as
// 1-char (latin-1 chars are 2 utf-8 bytes when >= 0x80)
static const uint8_t* byte_weight_tab() {
  static uint8_t wtab[256];
  static bool init = false;
  if (!init) {
    for (int b = 0; b < 256; ++b) {
      bool keep = (b >= '!' && b <= '~') || (b >= 0xA1 && b <= 0xAC) ||
                  (b >= 0xAE && b <= 0xFF);
      // kept bytes >= 0x80 map to themselves as latin-1 chars (2 utf-8
      // bytes); shifted bytes map into U+0100.. (2 utf-8 bytes); kept ASCII
      // maps to 1 byte
      wtab[b] = (keep && b < 0x80) ? 1 : 2;
    }
    init = true;
  }
  return wtab;
}

// Enumerate substrings of each pretoken starting at every `stride`-th
// char-start boundary, byte-lengths 1..max_length-1. Score contribution =
// weight * byte_weight(piece) where byte_weight = utf-8 length of the
// byte-CHAR representation (1 for printable-latin bytes, 2 otherwise) —
// matching rust_utils/src/lib.rs:148-149 token.len() on the mapped string.
//
// char_starts: byte positions (relative to each pretoken) where original
// characters start, concatenated; char_start_offsets delimits per pretoken.
void* count_substrings(const uint8_t* text, const int64_t* offsets,
                       int64_t n_pretokens, const int32_t* weights,
                       const int32_t* char_starts,
                       const int64_t* char_start_offsets, int32_t max_length,
                       int32_t stride) {
  const uint8_t* wtab = byte_weight_tab();
  auto* cm = new CountMap(1 << 20);
  for (int64_t i = 0; i < n_pretokens; ++i) {
    const uint8_t* s = text + offsets[i];
    int64_t n = offsets[i + 1] - offsets[i];
    uint64_t w = (uint64_t)weights[i];
    const int32_t* cs = char_starts + char_start_offsets[i];
    int64_t n_chars = char_start_offsets[i + 1] - char_start_offsets[i];
    for (int64_t ci = 0; ci < n_chars; ci += stride) {
      int64_t start = cs[ci];
      int64_t upper = std::min((int64_t)(max_length - 1), n - start);
      uint64_t wsum = 0;
      uint32_t h = 0x811C9DC5u;
      for (int64_t k = 1; k <= upper; ++k) {
        uint8_t b = s[start + k - 1];
        wsum += wtab[b];
        h = ch_step(h, b);
        cm->add(s + start, h, (size_t)k, w * wsum);
      }
    }
  }
  return cm;
}

// Fused variant: split whole texts with the native scanner (no-marks regex,
// matching rust_utils/src/lib.rs:27) and derive codepoint starts from the
// UTF-8 decode — the entire sampler counting stage in one native call
// (replaces Python pretokenize_bytes + per-piece char-start lists).
void* count_substrings_texts(const uint8_t* text, const int64_t* offsets,
                             int64_t n_texts, const int32_t* weights,
                             const uint8_t* ctab, int32_t letters_mask,
                             int32_t max_length, int32_t stride) {
  const uint8_t* wtab = byte_weight_tab();
  auto* cm = new CountMap(1 << 20);
  std::vector<int32_t> starts;
  for (int64_t ti = 0; ti < n_texts; ++ti) {
    const uint8_t* s = text + offsets[ti];
    size_t n = (size_t)(offsets[ti + 1] - offsets[ti]);
    uint64_t w = (uint64_t)weights[ti];
    size_t i = 0;
    while (i < n) {
      size_t j = pretoken_end(s, n, i, ctab, (uint8_t)letters_mask);
      starts.clear();
      size_t p = i;
      while (p < j) {
        starts.push_back((int32_t)(p - i));
        size_t a;
        u8_decode(s, j, p, &a);
        p += a;
      }
      const uint8_t* ps = s + i;
      int64_t plen = (int64_t)(j - i);
      for (size_t ci = 0; ci < starts.size(); ci += (size_t)stride) {
        int64_t start = starts[ci];
        int64_t upper = std::min((int64_t)(max_length - 1), plen - start);
        uint64_t wsum = 0;
        uint32_t h = 0x811C9DC5u;
        for (int64_t k = 1; k <= upper; ++k) {
          uint8_t b = ps[start + k - 1];
          wsum += wtab[b];
          h = ch_step(h, b);
          cm->add(ps + start, h, (size_t)k, w * wsum);
        }
      }
      i = j;
    }
  }
  return cm;
}

// Sum several count maps into a fresh one (the sliding-window merge,
// reference rust_utils/src/lib.rs:193-206 — previously reconstructed as
// Python dicts, which dominated sample_tokenizer time).
void* countmap_merge(void** handles, int64_t n) {
  size_t total = 0;
  for (int64_t i = 0; i < n; ++i) total += ((CountMap*)handles[i])->count;
  size_t cap = 1 << 16;
  while (cap * 3 < total * 4) cap *= 2;  // pre-size past the 75% load factor
  auto* out = new CountMap(cap);
  for (int64_t i = 0; i < n; ++i) {
    auto* in = (CountMap*)handles[i];
    for (const auto& sl : in->slots) {
      if (!sl.key_len) continue;
      out->add((const uint8_t*)in->keys.data() + sl.key_off, sl.hash,
               sl.key_len, sl.value);
    }
  }
  return out;
}

int64_t countmap_size(void* handle) {
  auto* cm = (CountMap*)handle;
  return (int64_t)cm->count;
}

// Serialize: fills offsets (n+1), values (n) and returns total key bytes.
// Call with keys=nullptr first to get the size, then with buffers.
int64_t countmap_serialize(void* handle, uint8_t* keys, int64_t* offsets,
                           uint64_t* values) {
  auto* cm = (CountMap*)handle;
  if (keys == nullptr) return (int64_t)cm->keys.size();
  int64_t pos = 0, i = 0;
  for (const auto& sl : cm->slots) {
    if (!sl.key_len) continue;
    offsets[i] = pos;
    std::memcpy(keys + pos, cm->keys.data() + sl.key_off, sl.key_len);
    pos += (int64_t)sl.key_len;
    values[i] = sl.value;
    ++i;
  }
  offsets[i] = pos;
  return pos;
}

void countmap_free(void* handle) { delete (CountMap*)handle; }

// --------------------------------------------------------------------------
// Cuckoo vocab-table build for the device retokenizer
// (ops/device_viterbi.py build_vocab_table — a new table is built per
// sampled tokenizer, i.e. once per training batch, so the Python kick loop
// was on the hot path)
// --------------------------------------------------------------------------

static inline uint32_t zmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Fills table_a/table_b (M, 4) int32 rows [key1, key2, score_bits, piece_id].
// Returns 1 on success, 0 if placement failed (caller doubles M and
// retries), writing the max piece byte-length to out_maxlen. Mirrors the
// Python reference implementation exactly (same fingerprints, same kick
// order) so the tables are bit-identical.
int32_t cuckoo_build(const uint8_t* piece_data, const int64_t* offsets,
                     const float* scores, int64_t n_pieces, int64_t M,
                     int32_t max_kicks, int32_t* table_a, int32_t* table_b,
                     int32_t* out_maxlen) {
  std::memset(table_a, 0, (size_t)M * 4 * sizeof(int32_t));
  std::memset(table_b, 0, (size_t)M * 4 * sizeof(int32_t));
  auto* ta = (uint32_t*)table_a;
  auto* tb = (uint32_t*)table_b;
  std::unordered_map<uint64_t, bool> seen;
  seen.reserve((size_t)n_pieces * 2);
  int32_t max_len = 1;
  const uint32_t P1 = 0x01000193u, P2 = 0x85EBCA6Bu;
  const uint32_t OFF1 = 0x811C9DC5u, OFF2 = 0x9E3779B9u, SALT_B = 0x7FEB352Du;
  for (int64_t pid = 0; pid < n_pieces; ++pid) {
    const uint8_t* begin = piece_data + offsets[pid];
    const uint8_t* end = piece_data + offsets[pid + 1];
    if (begin == end) continue;
    uint32_t h1 = OFF1, h2 = OFF2;
    for (const uint8_t* p = begin; p != end; ++p) {
      h1 = h1 * P1 + (uint32_t)(*p) + 1u;
      h2 = h2 * P2 + (uint32_t)(*p) + 1u;
    }
    if (h1 == 0) h1 = 1;
    uint64_t fp = ((uint64_t)h1 << 32) | h2;
    if (seen.count(fp)) continue;  // first occurrence wins
    seen.emplace(fp, true);
    if ((int32_t)(end - begin) > max_len) max_len = (int32_t)(end - begin);
    uint32_t score_bits;
    float s = scores[pid];
    std::memcpy(&score_bits, &s, 4);
    uint32_t cur[4] = {h1, h2, score_bits, (uint32_t)pid};
    int side = 0;
    bool placed = false;
    for (int32_t kick = 0; kick < max_kicks; ++kick) {
      uint32_t* t = side == 0 ? ta : tb;
      uint32_t key = side == 0 ? cur[0] : (cur[1] ^ SALT_B);
      uint64_t slot = (uint64_t)(zmix32(key) % (uint32_t)M) * 4;
      if (t[slot] == 0) {
        std::memcpy(t + slot, cur, 16);
        placed = true;
        break;
      }
      uint32_t tmp[4];
      std::memcpy(tmp, t + slot, 16);
      std::memcpy(t + slot, cur, 16);
      std::memcpy(cur, tmp, 16);
      side = 1 - side;
    }
    if (!placed) return 0;
  }
  *out_maxlen = max_len;
  return 1;
}

// Single-gather vocab table for the device retokenizer: (M, 16) int32 rows =
// 4 entries of [key1, key2, score_bits, piece_id]; slot = fmix32(h1 ^ salt)
// % M. One span lookup is ONE row-gather (TPU gathers are latency-bound, so
// halving the gather count vs the two-choice cuckoo layout halves the span
// phase). Returns 1 on success, 0 if any bucket overflows 4 entries (caller
// bumps the salt or doubles M). Bit-identical to the Python fallback.
int32_t bucket4_build(const uint8_t* piece_data, const int64_t* offsets,
                      const float* scores, int64_t n_pieces, int64_t M,
                      uint32_t salt, int32_t* table, int32_t* out_maxlen) {
  std::memset(table, 0, (size_t)M * 16 * sizeof(int32_t));
  auto* t = (uint32_t*)table;
  std::unordered_map<uint64_t, bool> seen;
  seen.reserve((size_t)n_pieces * 2);
  int32_t max_len = 1;
  const uint32_t P1 = 0x01000193u, P2 = 0x85EBCA6Bu;
  const uint32_t OFF1 = 0x811C9DC5u, OFF2 = 0x9E3779B9u;
  for (int64_t pid = 0; pid < n_pieces; ++pid) {
    const uint8_t* begin = piece_data + offsets[pid];
    const uint8_t* end = piece_data + offsets[pid + 1];
    if (begin == end) continue;
    uint32_t h1 = OFF1, h2 = OFF2;
    for (const uint8_t* p = begin; p != end; ++p) {
      h1 = h1 * P1 + (uint32_t)(*p) + 1u;
      h2 = h2 * P2 + (uint32_t)(*p) + 1u;
    }
    if (h1 == 0) h1 = 1;
    uint64_t fp = ((uint64_t)h1 << 32) | h2;
    if (seen.count(fp)) continue;  // first occurrence wins
    seen.emplace(fp, true);
    if ((int32_t)(end - begin) > max_len) max_len = (int32_t)(end - begin);
    uint32_t score_bits;
    float s = scores[pid];
    std::memcpy(&score_bits, &s, 4);
    uint64_t base = (uint64_t)(zmix32(h1 ^ salt) % (uint32_t)M) * 16;
    bool placed = false;
    for (int e = 0; e < 4; ++e) {
      if (t[base + e * 4] == 0) {
        t[base + e * 4] = h1;
        t[base + e * 4 + 1] = h2;
        t[base + e * 4 + 2] = score_bits;
        t[base + e * 4 + 3] = (uint32_t)pid;
        placed = true;
        break;
      }
    }
    if (!placed) return 0;
  }
  *out_maxlen = max_len;
  return 1;
}

// --------------------------------------------------------------------------
// Aho-Corasick multi-pattern counting (substring prior)
// --------------------------------------------------------------------------

struct AcNode {
  int32_t children[256];
  int32_t fail;
  int32_t out_head;  // index into out_values/out_next linked list, -1 = none
};

struct AhoCorasick {
  std::vector<AcNode> nodes;
  std::vector<int32_t> out_values;
  std::vector<int32_t> out_next;
};

static int32_t ac_add_node(AhoCorasick* ac) {
  ac->nodes.emplace_back();
  AcNode& n = ac->nodes.back();
  std::memset(n.children, -1, sizeof(n.children));
  n.fail = 0;
  n.out_head = -1;
  return (int32_t)(ac->nodes.size() - 1);
}

void* ac_new(const uint8_t* pattern_data, const int64_t* pattern_offsets,
             const int32_t* values, int64_t n_patterns) {
  auto* ac = new AhoCorasick();
  ac->nodes.reserve(1 << 16);
  ac_add_node(ac);
  for (int64_t i = 0; i < n_patterns; ++i) {
    const uint8_t* begin = pattern_data + pattern_offsets[i];
    const uint8_t* end = pattern_data + pattern_offsets[i + 1];
    if (begin == end) continue;
    int32_t node = 0;
    for (const uint8_t* p = begin; p != end; ++p) {
      int32_t nxt = ac->nodes[node].children[*p];
      if (nxt < 0) {
        nxt = ac_add_node(ac);
        ac->nodes[node].children[*p] = nxt;
      }
      node = nxt;
    }
    ac->out_values.push_back(values[i]);
    ac->out_next.push_back(ac->nodes[node].out_head);
    ac->nodes[node].out_head = (int32_t)(ac->out_values.size() - 1);
  }
  // BFS failure links; convert children to goto function (automaton form)
  std::vector<int32_t> queue;
  for (int b = 0; b < 256; ++b) {
    int32_t c = ac->nodes[0].children[b];
    if (c < 0) {
      ac->nodes[0].children[b] = 0;
    } else {
      ac->nodes[c].fail = 0;
      queue.push_back(c);
    }
  }
  for (size_t qi = 0; qi < queue.size(); ++qi) {
    int32_t node = queue[qi];
    // merge fail output chain
    int32_t f = ac->nodes[node].fail;
    if (ac->nodes[node].out_head < 0) {
      ac->nodes[node].out_head = ac->nodes[f].out_head;
    } else {
      int32_t tail = ac->nodes[node].out_head;
      while (ac->out_next[tail] >= 0) tail = ac->out_next[tail];
      ac->out_next[tail] = ac->nodes[f].out_head;
    }
    for (int b = 0; b < 256; ++b) {
      int32_t c = ac->nodes[node].children[b];
      if (c < 0) {
        ac->nodes[node].children[b] = ac->nodes[f].children[b];
      } else {
        ac->nodes[c].fail = ac->nodes[f].children[b];
        queue.push_back(c);
      }
    }
  }
  return ac;
}

void ac_free(void* handle) { delete (AhoCorasick*)handle; }

// Count pattern occurrences over weighted texts into acc (int64, caller
// allocates with max(value)+1 entries).
void ac_count(void* handle, const uint8_t* text, const int64_t* offsets,
              int64_t n_texts, const int64_t* weights, int64_t* acc) {
  auto* ac = (AhoCorasick*)handle;
  for (int64_t i = 0; i < n_texts; ++i) {
    const uint8_t* s = text + offsets[i];
    int64_t n = offsets[i + 1] - offsets[i];
    int64_t w = weights[i];
    int32_t node = 0;
    for (int64_t j = 0; j < n; ++j) {
      node = ac->nodes[node].children[s[j]];
      for (int32_t o = ac->nodes[node].out_head; o >= 0; o = ac->out_next[o]) {
        acc[ac->out_values[o]] += w;
      }
    }
  }
}

}  // extern "C"
