// Kernel 6: the batched Unigram Viterbi DP, and the same DP fused with the
// bucket-4 lookup of its span scores.
//
// Replaces the TPU kernel zett_tpu/ops/pallas_viterbi.py _viterbi_dp_kernel /
// viterbi_dp_pallas (:25, :68), and the lax.scan DP of
// zett_tpu/ops/device_viterbi.py viterbi_device (:250-268), which share one
// contract. Inputs: span scores S (B, L, K) f32 (NEG = -1e30 where a span is
// absent) and piece ids I (B, L, K) int32. Outputs dp (B, L+K) f32, bk and bi
// (B, L+K) int32. dp[0] = 0, every other dp entry NEG, bk 0, bi -1; then for
// j = 0..L-1 in order, dp[j+1+k] = dp[j] + S[j,k] where that is strictly
// greater, which also sets bk = k+1 and bi = I[j,k]. Each candidate is one
// f32 add (no FMA) and ties keep the earlier writer, so the result is
// bit-identical to the plain PyTorch loop (ops/viterbi_dp.py).
//
// zt_viterbi_dp (the DP alone) is bound by memory: it reads each S and I
// entry once and writes each output once; at B = 65536, L = 48, K = 16 that
// is 402.7 MB of S + I and 50.3 MB of dp/bk/bi, >= 0.135 ms at 3.35 TB/s,
// against 50 M f32 adds. The DP is a sequential scan over j with
// data-dependent stores.
//
// Design: a group of G lanes (8 for K <= 8, else 16) owns one row; lane t
// handles the span lengths k = t, t + G, ... (KPL of them). The window of
// positions j+1 .. j+K lives in registers, one slot per k: at step j each lane
// relaxes its slots from dp[j] and S[b, j, k] (G lanes read one contiguous
// K-float run), position j+1 is then final and lane 0 writes it, and the
// window shifts down one position through a group shuffle. The next step's S
// and I are loaded before the current step's relax. The TPU kernel's (L, K, B)
// sublane layout, aligned windows and one-hot roll were Mosaic workarounds and
// have no counterpart.
//
// zt_viterbi_spans_dp is the device Viterbi's main path
// (ops/device_viterbi.py viterbi_device): the same DP, with S and I computed
// in the kernel from the pretoken bytes instead of read, so neither reaches
// device memory. Its inputs are rows (B, L) int32 bytes, lens (B,) int32 in
// 0..L and the vocab's bucket-4 hash table (M, 16) int32 (M a power of two;
// four entries [key1, key2, score bits, piece id] a row); its outputs are
// bit-identical to zt_viterbi_dp on compute_span_scores' S and I. Each group
// stages its row's bytes in shared memory (16-byte loads where L % 4 == 0)
// and the two lanes 0 and 1 roll the prefix hashes H[p] = H[p-1] * P + b + 1
// (mod 2^32) of the FNV-style fingerprints, so the fingerprint of span
// (j, k) is (OFF - H[j]) * P^k + H[j+k] (mod 2^32) for each of the two
// multipliers: two multiply-adds per lane and step. A span inside the
// pretoken (j + k <= len) looks up its bucket (fmix32 of the first
// fingerprint ^ salt, masked to M) from L2 (the table is a few MB) and
// compares both fingerprints with its entries, two 16-byte loads at a time:
// a bucket's entries fill in order and its keys are unique, so a hit or an
// empty entry ends the search and the bucket's second 32-byte sector is read
// only behind two full entries; single bytes with no piece take unk_score
// and id -2. A span past
// the pretoken's end is never looked up: its S is NEG, and a NEG candidate
// dp[j] + NEG cannot beat a window entry (>= NEG) unless dp[j] >= 2^75, far
// above any sum of Unigram scores, so it is skipped; the scan stops at len
// and the positions past len keep NEG, 0, -1. The next step's lookups are
// started before the current step's relax. Bound: the bytes of rows, lens and
// dp/bk/bi, and the table once: 1.0 GB at B = 1,035,514, L = 48, K = 16,
// >= 0.30 ms; the lookups (one per span inside a pretoken, 32 or 64 bytes
// each) hit L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;

template <int G, int KPL>
__global__ void __launch_bounds__(kThreads)
viterbi_dp_kernel(const float* __restrict__ S, const int* __restrict__ I, float* __restrict__ dp,
                  int* __restrict__ bk, int* __restrict__ bi, long long B, int L, int K) {
  const int lane = threadIdx.x % G;
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  if (row >= B) return;  // a whole group leaves together
  const unsigned group_mask = (G == 32 ? 0xffffffffu : ((1u << G) - 1u))
                              << ((threadIdx.x % 32) / G * G);
  const long long W = (long long)L + K;
  const float* s_row = S + row * L * K;
  const int* i_row = I + row * L * K;
  float* dp_row = dp + row * W;
  int* bk_row = bk + row * W;
  int* bi_row = bi + row * W;

  float win[KPL];
  int wk[KPL], wi[KPL];
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    win[m] = kNeg;
    wk[m] = 0;
    wi[m] = -1;
  }
  if (lane == 0) {
    dp_row[0] = 0.0f;
    bk_row[0] = 0;
    bi_row[0] = -1;
  }
  float s_next[KPL];
  int i_next[KPL];
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    const int k = lane + G * m;
    const bool ok = k < K && L > 0;
    s_next[m] = ok ? __ldg(s_row + k) : kNeg;
    i_next[m] = ok ? __ldg(i_row + k) : -1;
  }
  float dj = 0.0f;
  for (int j = 0; j < L; ++j) {
    float s_cur[KPL];
    int i_cur[KPL];
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      s_cur[m] = s_next[m];
      i_cur[m] = i_next[m];
      const int k = lane + G * m;
      const bool ok = k < K && j + 1 < L;
      const long long off = (long long)(j + 1) * K + k;
      s_next[m] = ok ? __ldg(s_row + off) : kNeg;
      i_next[m] = ok ? __ldg(i_row + off) : -1;
    }
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      const int k = lane + G * m;
      if (k < K) {
        const float cand = __fadd_rn(dj, s_cur[m]);
        if (cand > win[m]) {
          win[m] = cand;
          wk[m] = k + 1;
          wi[m] = i_cur[m];
        }
      }
    }
    // position j+1 is final: its last writer was this step (k = 0)
    dj = __shfl_sync(group_mask, win[0], 0, G);
    if (lane == 0) {
      dp_row[j + 1] = win[0];
      bk_row[j + 1] = wk[0];
      bi_row[j + 1] = wi[0];
    }
    // shift the window down one position: slot k takes slot k+1
    const int src = (lane + 1) % G;
    float f_in[KPL];
    int k_in[KPL], i_in[KPL];
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      f_in[m] = __shfl_sync(group_mask, win[m], src, G);
      k_in[m] = __shfl_sync(group_mask, wk[m], src, G);
      i_in[m] = __shfl_sync(group_mask, wi[m], src, G);
    }
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      if (lane < G - 1) {
        win[m] = f_in[m];
        wk[m] = k_in[m];
        wi[m] = i_in[m];
      } else if (m + 1 < KPL) {  // lane G-1 takes lane 0's next slot
        win[m] = f_in[m + 1];
        wk[m] = k_in[m + 1];
        wi[m] = i_in[m + 1];
      } else {
        win[m] = kNeg;
        wk[m] = 0;
        wi[m] = -1;
      }
      if (lane + G * m >= K) {  // slots past K stay empty
        win[m] = kNeg;
        wk[m] = 0;
        wi[m] = -1;
      }
    }
  }
  // the window now holds positions L+1 .. L+K; the outputs end at L+K-1
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    const int k = lane + G * m;
    if (k < K - 1) {
      dp_row[L + 1 + k] = win[m];
      bk_row[L + 1 + k] = wk[m];
      bi_row[L + 1 + k] = wi[m];
    }
  }
}

template <int G, int KPL>
cudaError_t launch(const float* S, const int* I, float* dp, int* bk, int* bi, long long B, int L,
                   int K, cudaStream_t stream) {
  const long long rows_per_block = kThreads / G;
  const long long blocks = (B + rows_per_block - 1) / rows_per_block;
  viterbi_dp_kernel<G, KPL><<<(unsigned)blocks, kThreads, 0, stream>>>(S, I, dp, bk, bi, B, L, K);
  return cudaGetLastError();
}

// ------------------------------------------------ spans fused into the DP
constexpr unsigned kP1 = 0x01000193u, kP2 = 0x85EBCA6Bu;  // fingerprint multipliers
constexpr unsigned kOff1 = 0x811C9DC5u, kOff2 = 0x9E3779B9u;

__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ unsigned pow32(unsigned p, int k) {
  unsigned r = 1u;
  for (int i = 0; i < k; ++i) r *= p;
  return r;
}

// Bytes of one row's shared memory: the prefix hashes H1, H2 (L + 1 each)
// and the row's L values.
__host__ __device__ inline int spans_row_bytes(int L) { return 8 * (L + 1) + 4 * L; }

// S and I of span (j, k), 1-based length k, inside the pretoken.
__device__ __forceinline__ void span_lookup(const int4* __restrict__ table, unsigned mmask,
                                            unsigned salt, float unk, const unsigned* H1,
                                            const unsigned* H2, int j, int k, unsigned p1k,
                                            unsigned p2k, float& s, int& id) {
  unsigned h1 = (kOff1 - H1[j]) * p1k + H1[j + k];
  const unsigned h2 = (kOff2 - H2[j]) * p2k + H2[j + k];
  if (h1 == 0u) h1 = 1u;
  const int4* bucket = table + 4 * (size_t)(fmix32(h1 ^ salt) & mmask);
  s = kNeg;
  id = -1;
  // a bucket's entries fill in order and its keys are unique (as
  // build_vocab_table makes them): a hit or an empty entry (key1 0) ends the
  // search, so the second 32-byte half is read only behind two full entries
  bool done = false;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (done) break;
    const int4 e0 = __ldg(bucket + 2 * half), e1 = __ldg(bucket + 2 * half + 1);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int4 ent = e ? e1 : e0;
      if (ent.x == (int)h1 && ent.y == (int)h2) {
        s = fmaxf(s, __int_as_float(ent.z));
        id = max(id, ent.w);
        done = true;
      }
    }
    done = done || e1.x == 0;
  }
  if (k == 1) {  // the unk fallback of single bytes
    if (s <= kNeg / 2) s = unk;
    if (id < 0) id = -2;
  }
}

template <int G, int KPL>
__global__ void __launch_bounds__(kThreads)
viterbi_spans_dp_kernel(const int* __restrict__ rows, const int* __restrict__ lens,
                        const int4* __restrict__ table, unsigned mmask, unsigned salt, float unk,
                        float* __restrict__ dp, int* __restrict__ bk, int* __restrict__ bi,
                        long long B, int L, int K) {
  extern __shared__ __align__(16) unsigned char spans_smem[];
  const int lane = threadIdx.x % G;
  const int slot = threadIdx.x / G;  // this group's row within the block
  const long long row = (long long)blockIdx.x * (kThreads / G) + slot;
  if (row >= B) return;  // a whole group leaves together
  const unsigned group_mask = (G == 32 ? 0xffffffffu : ((1u << G) - 1u))
                              << ((threadIdx.x % 32) / G * G);
  unsigned* H1 = reinterpret_cast<unsigned*>(spans_smem + (size_t)slot * spans_row_bytes(L));
  unsigned* H2 = H1 + L + 1;
  unsigned* bytes = H2 + L + 1;
  const long long W = (long long)L + K;
  float* dp_row = dp + row * W;
  int* bk_row = bk + row * W;
  int* bi_row = bi + row * W;
  const int len = min(max(__ldg(lens + row), 0), L);

  // the row's bytes, read once
  const int* r = rows + row * L;
  if ((L & 3) == 0) {
    for (int c = lane; c < L / 4; c += G) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(r) + c);
      bytes[4 * c] = (unsigned)v.x;
      bytes[4 * c + 1] = (unsigned)v.y;
      bytes[4 * c + 2] = (unsigned)v.z;
      bytes[4 * c + 3] = (unsigned)v.w;
    }
  } else {
    for (int c = lane; c < L; c += G) bytes[c] = (unsigned)__ldg(r + c);
  }
  __syncwarp(group_mask);
  if (lane < 2) {  // lane 0 rolls H1, lane 1 H2
    unsigned* H = lane ? H2 : H1;
    const unsigned P = lane ? kP2 : kP1;
    unsigned acc = 0u;
    H[0] = 0u;
    for (int p = 0; p < len; ++p) {
      acc = acc * P + bytes[p] + 1u;
      H[p + 1] = acc;
    }
  }
  __syncwarp(group_mask);

  unsigned p1k[KPL], p2k[KPL];
  float win[KPL];
  int wk[KPL], wi[KPL];
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    p1k[m] = pow32(kP1, lane + G * m + 1);
    p2k[m] = pow32(kP2, lane + G * m + 1);
    win[m] = kNeg;
    wk[m] = 0;
    wi[m] = -1;
  }
  if (lane == 0) {
    dp_row[0] = 0.0f;
    bk_row[0] = 0;
    bi_row[0] = -1;
  }
  // spans (j, k) inside the pretoken: j + k <= len, k = lane + G m + 1 <= K
  float s_next[KPL];
  int i_next[KPL];
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    const int k = lane + G * m + 1;
    s_next[m] = kNeg;
    i_next[m] = -1;
    if (k <= K && k <= len)
      span_lookup(table, mmask, salt, unk, H1, H2, 0, k, p1k[m], p2k[m], s_next[m], i_next[m]);
  }
  float dj = 0.0f;
  for (int j = 0; j < len; ++j) {
    float s_cur[KPL];
    int i_cur[KPL];
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      s_cur[m] = s_next[m];
      i_cur[m] = i_next[m];
      const int k = lane + G * m + 1;
      s_next[m] = kNeg;
      i_next[m] = -1;
      if (k <= K && j + 1 + k <= len)
        span_lookup(table, mmask, salt, unk, H1, H2, j + 1, k, p1k[m], p2k[m], s_next[m],
                    i_next[m]);
    }
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      const int k = lane + G * m + 1;
      if (k <= K && j + k <= len) {
        const float cand = __fadd_rn(dj, s_cur[m]);
        if (cand > win[m]) {
          win[m] = cand;
          wk[m] = k;
          wi[m] = i_cur[m];
        }
      }
    }
    // position j+1 is final: its last writer was this step (k = 1)
    dj = __shfl_sync(group_mask, win[0], 0, G);
    if (lane == 0) {
      dp_row[j + 1] = win[0];
      bk_row[j + 1] = wk[0];
      bi_row[j + 1] = wi[0];
    }
    // shift the window down one position: slot k takes slot k+1
    const int src = (lane + 1) % G;
    float f_in[KPL];
    int k_in[KPL], i_in[KPL];
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      f_in[m] = __shfl_sync(group_mask, win[m], src, G);
      k_in[m] = __shfl_sync(group_mask, wk[m], src, G);
      i_in[m] = __shfl_sync(group_mask, wi[m], src, G);
    }
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      if (lane < G - 1) {
        win[m] = f_in[m];
        wk[m] = k_in[m];
        wi[m] = i_in[m];
      } else if (m + 1 < KPL) {  // lane G-1 takes lane 0's next slot
        win[m] = f_in[m + 1];
        wk[m] = k_in[m + 1];
        wi[m] = i_in[m + 1];
      } else {
        win[m] = kNeg;
        wk[m] = 0;
        wi[m] = -1;
      }
    }
  }
  // no span inside the pretoken reaches past len: those positions keep
  // their initial values
  for (long long p = len + 1 + lane; p < W; p += G) {
    dp_row[p] = kNeg;
    bk_row[p] = 0;
    bi_row[p] = -1;
  }
}

template <int G, int KPL>
cudaError_t launch_spans(const int* rows, const int* lens, const int4* table, unsigned mmask,
                         unsigned salt, float unk, float* dp, int* bk, int* bi, long long B,
                         int L, int K, cudaStream_t stream) {
  const long long rows_per_block = kThreads / G;
  const long long blocks = (B + rows_per_block - 1) / rows_per_block;
  const int smem = (int)rows_per_block * spans_row_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(viterbi_spans_dp_kernel<G, KPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  viterbi_spans_dp_kernel<G, KPL><<<(unsigned)blocks, kThreads, smem, stream>>>(
      rows, lens, table, mmask, salt, unk, dp, bk, bi, B, L, K);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = success); cudaErrorInvalidValue for K outside
// 1..128 (the wrapper checks first).
extern "C" int zt_viterbi_dp(const float* S, const int* I, float* dp, int* bk, int* bi,
                             long long B, int L, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0) return 0;
  if (K <= 8) return (int)launch<8, 1>(S, I, dp, bk, bi, B, L, K, s);
  if (K <= 16) return (int)launch<16, 1>(S, I, dp, bk, bi, B, L, K, s);
  if (K <= 32) return (int)launch<16, 2>(S, I, dp, bk, bi, B, L, K, s);
  if (K <= 64) return (int)launch<16, 4>(S, I, dp, bk, bi, B, L, K, s);
  if (K <= 128) return (int)launch<16, 8>(S, I, dp, bk, bi, B, L, K, s);
  return (int)cudaErrorInvalidValue;
}

// rows (B, L) int32 bytes (16-byte aligned), lens (B,) int32 in 0..L, table
// (M, 16) int32 with M a power of two. Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for K outside 1..128 or a row's shared memory past
// the SM's (the wrapper checks first).
extern "C" int zt_viterbi_spans_dp(const int* rows, const int* lens, const int* table, int M,
                                   unsigned int salt, float unk_score, float* dp, int* bk,
                                   int* bi, long long B, int L, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0) return 0;
  if (M < 1 || (M & (M - 1)) || L < 1 || 32 * spans_row_bytes(L) > 232448)
    return (int)cudaErrorInvalidValue;
  const int4* t = reinterpret_cast<const int4*>(table);
  const unsigned mm = (unsigned)M - 1u;
  if (K <= 8) return (int)launch_spans<8, 1>(rows, lens, t, mm, salt, unk_score, dp, bk, bi, B, L, K, s);
  if (K <= 16) return (int)launch_spans<16, 1>(rows, lens, t, mm, salt, unk_score, dp, bk, bi, B, L, K, s);
  if (K <= 32) return (int)launch_spans<16, 2>(rows, lens, t, mm, salt, unk_score, dp, bk, bi, B, L, K, s);
  if (K <= 64) return (int)launch_spans<16, 4>(rows, lens, t, mm, salt, unk_score, dp, bk, bi, B, L, K, s);
  if (K <= 128) return (int)launch_spans<16, 8>(rows, lens, t, mm, salt, unk_score, dp, bk, bi, B, L, K, s);
  return (int)cudaErrorInvalidValue;
}
