// Masked per-head softmax attention over very short rows (the hypernet's
// surface forms: at most 32 query and 32 key positions, head width D = 64 or
// 128: every function below is a template on D, one code for both).
//
// Shared by encoder_layer.cu (kernel 1, the attention inside a whole encoder
// layer), attention_core.cu (kernel 2, the tier-4 core), attention_block.cu
// (kernel 4, the attention inside the tier-2 block) and merged_attention.cu
// (kernel 5, the tier-1 core). Nothing of a row leaves the SM between the
// score and the context: the score plane never touches device memory, as in
// the TPU kernels this replaces. attention_head, one head of one row from
// operands already in shared memory, is the body of attention_row below and
// runs, as it stands, in kernel 1's [q|k|v] GEMM epilogue on the GEMM's
// output tile (bf16); kernel 1's f32 path launches attention_kernel.
//
// What bounds it on an H100: memory. At the training shapes (B = 32896,
// Lq*h = Lk*h = 84, bf16) it reads q, k, v and writes the context, 1.4 GB
// (>= 0.43 ms at 3.35 TB/s), against 0.3 GFLOP of products. At rate > 0 a
// head with no valid key draws a Philox word for each of its queries' Lk*h
// merged keys: at 32 heads those integer instructions, not the bytes, bound
// a batch's all-padding rows.
//
// bf16 design (attention_mma_kernel): a CTA works on one surface-form row
// at a time, one warp per head. Past 16 heads (up to kMaxHeads = 32, one
// m16 query tile) at D = 64, attention_mma2_kernel runs the same code with
// 16 warps, warp w taking heads w and w + 16, so the 512-thread launch
// bound, and with it the 128 registers a thread, holds. It stages the row's
// q, k and v positions (all heads) in shared memory with 16-byte cp.async
// loads, one padded row per position (conflict-free ldmatrix); CTAs are
// persistent, and while one row is computed the next one's loads are in
// flight in a second buffer (where two fit in shared memory), so the loads
// never wait on the products. Each warp computes its head's S = Q K^T and
// O = P V with mma.sync m16n8k16 (bf16 in, f32 accumulate): queries padded
// to m16 tiles, keys to n8 tiles, the depth of D in D/16 k16 steps, and PV
// produces its D output columns 32 at a time (so the accumulators a lane
// holds do not grow with D: at D = 128 a row's 16 heads stage 86 KB, two
// buffers 172 KB, one CTA an SM). The
// rounding, the division by sqrt(d), the key bias, the mask select, the
// softmax (max and sum over the lane quad that holds a query's keys) and the
// dropout act on the accumulator fragments in registers, each lane knowing
// its (query, key); P's fragments, cast to bf16, are PV's A operand as they
// stand, and V comes in through ldmatrix.trans. Rows past Lq or Lk are never
// stored: their ldmatrix addresses point at one zero row. The context goes
// through the warp's q slice to coalesced 16-byte stores. A head with no
// valid key (below) takes the row's mean over all merged value rows at rate
// 0, summed once by the whole CTA; at rate > 0 its warp builds the dropped
// uniform weights of its queries over all Lk*h merged keys as A fragments in
// registers, one Philox word per entry, drawn once (the key step outside,
// all D output columns inside: 64 accumulators a lane at D = 128), and
// multiplies them with the merged V rows on the tensor cores.
//
// Past 16 heads at D = 128 (attention_cluster_kernel): 32 heads stage up to
// 213 KB a row, one buffer of the SM's 227 KB, so one CTA a row would load,
// compute and store one after another (such a kernel took 11.3 us a
// transfer CLS row on each SM of an H100, where the row's bytes take 5.2
// at the SM's share of the card's bandwidth). So a row is split over a cluster of two CTAs (three for an odd
// head count's longest rows), each holding its heads' share of a position
// (16 heads of 128: 4 KB) in a ring of 2-4 stages filled by bulk copies
// (cp.async.bulk) on mbarriers: a row's products start when its stage has
// landed, with no CTA-wide barrier, while the next rows' loads are in
// flight. The terms that cross the shares (a head with no valid key weights
// every head's values) go through distributed shared memory: at rate 0 each
// CTA's per-head value sums, at rate > 0 each peer's value share copied in
// turn into the CTA's free k slots, accumulated in f32 before the one cast.
// f32 keeps the scalar path (attention_kernel:
// one warp a (row, head) pair, f32 operands in shared memory, fmaf loops),
// the full-precision reference.
//
// Numerics follow zett_tpu/ops/pallas_attention.py:39-45 and its merged-head
// formulation exactly:
//   scores: f32 accumulation, cast to T, then divided by sqrt(d) in T;
//   key bias (kernels 4 and 5, when given): added in T after the division;
//   masking: one select to the lowest finite value of T (never -inf);
//   softmax in f32 with max subtraction, weights cast to T before PV;
//   PV: f32 accumulation, cast to T.
// The merged formulation masks other heads' keys with the same lowest value,
// so a query whose own head has no valid key sees every merged entry equal
// and averages uniformly over ALL Lk*h merged value rows (every head). That
// row is reproduced here exactly (the all-padding surface form case).
//
// Dropout of the softmax weights (kernel 2 on the training route) draws its
// keep mask from a counter-based generator instead of the TPU kernel's
// per-tile Mosaic PRNG: Philox4x32-10 keyed by (seed, 0) at the counter
// (row_offset + b, merged query index, merged key index, 0), row_offset
// being the launch's first row within the whole batch (nonzero where a rank
// runs its share of the batch's rows). Each entry of the merged (B, Lq*h,
// Lk*h) weight plane thus has its own bits, independent of how the batch is
// tiled or split, and the backward (kernel 3) regenerates the same mask. An
// entry is kept when its first output word is below keep_threshold =
// round((1 - rate) * 2^32); kept weights are divided by 1 - rate in T.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sync.cuh"

namespace zt {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 64;  // kernels 4 and 5, and kernel 1's fused route
constexpr int kAttnWarps = 4;
// the f32 path's staged rows: D + 1 floats, conflict-free column reads
__host__ __device__ constexpr int row_pad(int D) { return D + 1; }

template <typename T> struct Num;

template <> struct Num<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float lowest() { return -FLT_MAX; }
};

template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  // finfo(bfloat16).min = -(2 - 2^-7) * 2^127
  static __device__ __forceinline__ float lowest() { return -3.38953139e38f; }
};

// Strides are in elements of T. A head's D values sit at offset head*D of
// a position's row, in both layouts this code serves: (B, L, h*D) and the
// position-major merged (B, L*h, D).
struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const float* mask;  // > 0 means the key is valid; null: every key is valid
  int B, Lq, Lk, h;
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl;
  long long m_sb, m_sl, m_sh;
  // additive key bias in T (null: none), indexed like the mask
  const void* kbias = nullptr;
  long long kb_sb = 0, kb_sl = 0, kb_sh = 0;
  // dropout of the weights (dropout != 0): see the header note
  int dropout = 0;
  unsigned int seed = 0;
  unsigned int keep_threshold = 0;
  float keep_div = 1.0f;  // 1 - rate, rounded to T
  unsigned int row_offset = 0;  // the launch's first row within the whole batch
};

// Philox4x32-10 (Salmon et al., SC'11), first output word.
__host__ __device__ inline unsigned int philox_word0(unsigned int c0, unsigned int c1,
                                                     unsigned int c2, unsigned int c3,
                                                     unsigned int k0, unsigned int k1) {
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned long long p0 = 0xD2511F53ull * c0;
    const unsigned long long p1 = 0xCD9E8D57ull * c2;
    const unsigned int n0 = (unsigned int)(p1 >> 32) ^ c1 ^ k0;
    const unsigned int n2 = (unsigned int)(p0 >> 32) ^ c3 ^ k1;
    c1 = (unsigned int)p1;
    c3 = (unsigned int)p0;
    c0 = n0;
    c2 = n2;
  }
  return c0;
}

// Whether merged weight (b, qi, kj) survives dropout.
__device__ __forceinline__ bool dropout_keep(unsigned int seed, unsigned int threshold,
                                             unsigned int b, int qi, int kj) {
  return philox_word0(b, (unsigned int)qi, (unsigned int)kj, 0u, seed, 0u) <
         threshold;
}

// ------------------------------------- tensor-core helpers (kernels 2 to 5)
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr(dst)), "l"(src));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// c[16 x 8] += a[16 x 16] * b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------ f32: scalar path
__host__ __device__ inline int attn_smem_floats_per_warp(int Lq, int Lk, int D) {
  return (Lq + 2 * Lk) * row_pad(D) + Lq * (Lk + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kAttnWarps * 32, 1) attention_kernel(AttnArgs a) {
  constexpr int kRowPad = row_pad(D), kC = D / 32;  // kC: a lane's columns
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long pair = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (pair >= (long long)a.B * a.h) return;  // whole warp leaves together
  const int b = (int)(pair / a.h);
  const int hd = (int)(pair % a.h);
  const int Lq = a.Lq, Lk = a.Lk;

  float* sq = smem + (size_t)warp * attn_smem_floats_per_warp(Lq, Lk, D);
  float* sk = sq + Lq * kRowPad;
  float* sv = sk + Lk * kRowPad;
  float* sp = sv + Lk * kRowPad;  // [Lq][Lk + 1]

  const T* qb = (const T*)a.q + b * a.q_sb + hd * D;
  const T* kb = (const T*)a.k + b * a.k_sb + hd * D;
  const T* vb = (const T*)a.v + b * a.v_sb + hd * D;
  for (int i = 0; i < Lq; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c)
      sq[i * kRowPad + lane + 32 * c] = Num<T>::to_f(qb[i * a.q_sl + lane + 32 * c]);
  for (int j = 0; j < Lk; ++j)
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      sk[j * kRowPad + lane + 32 * c] = Num<T>::to_f(kb[j * a.k_sl + lane + 32 * c]);
      sv[j * kRowPad + lane + 32 * c] = Num<T>::to_f(vb[j * a.v_sl + lane + 32 * c]);
    }
  const bool key_ok =
      lane < Lk && (a.mask == nullptr || a.mask[b * a.m_sb + lane * a.m_sl + hd * a.m_sh] > 0.0f);
  const unsigned valid = __ballot_sync(0xffffffffu, key_ok);
  __syncwarp();

  if (valid == 0u) {
    // every merged score equals lowest(T): uniform weights over all Lk*h
    // merged value rows, cast to T as the softmax output is
    const float w = Num<T>::round(1.0f / (float)(Lk * a.h));
    const T* vrow = (const T*)a.v + b * a.v_sb;
    if (a.dropout) {
      // each merged weight has its own keep bit, so every query differs
      const float wd = Num<T>::round(w / a.keep_div);
      for (int i = 0; i < Lq; ++i)
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int dim = lane + 32 * c;
          float acc = 0.0f;
          for (int j = 0; j < Lk; ++j)
            for (int hh = 0; hh < a.h; ++hh)
              if (dropout_keep(a.seed, a.keep_threshold, a.row_offset + b, i * a.h + hd,
                               j * a.h + hh))
                acc += wd * Num<T>::to_f(vrow[j * a.v_sl + hh * D + dim]);
          ((T*)a.out)[b * a.o_sb + i * a.o_sl + hd * D + dim] = Num<T>::from_f(acc);
        }
      return;
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int dim = lane + 32 * c;
      float acc = 0.0f;
      for (int j = 0; j < Lk; ++j)
        for (int hh = 0; hh < a.h; ++hh)
          acc += w * Num<T>::to_f(vrow[j * a.v_sl + hh * D + dim]);
      const T o = Num<T>::from_f(acc);
      for (int i = 0; i < Lq; ++i)
        ((T*)a.out)[b * a.o_sb + i * a.o_sl + hd * D + dim] = o;
    }
    return;
  }

  const float sqrt_d = sqrtf((float)D);
  const float lowest = Num<T>::lowest();
  const T* kbias = a.kbias ? (const T*)a.kbias + b * a.kb_sb + hd * a.kb_sh : nullptr;
  for (int idx = lane; idx < Lq * Lk; idx += 32) {
    const int i = idx / Lk;
    const int j = idx % Lk;
    float acc = 0.0f;
#pragma unroll 16
    for (int t = 0; t < D; ++t) acc = fmaf(sq[i * kRowPad + t], sk[j * kRowPad + t], acc);
    float s = Num<T>::round(Num<T>::round(acc) / sqrt_d);
    if (kbias) s = Num<T>::round(s + Num<T>::to_f(kbias[j * a.kb_sl]));
    sp[i * (Lk + 1) + j] = ((valid >> j) & 1u) ? s : lowest;
  }
  __syncwarp();
  if (lane < Lq) {
    float* row = sp + lane * (Lk + 1);
    float m = row[0];
    for (int j = 1; j < Lk; ++j) m = fmaxf(m, row[j]);
    float sum = 0.0f;
    for (int j = 0; j < Lk; ++j) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int j = 0; j < Lk; ++j) row[j] = Num<T>::round(row[j] / sum);
  }
  __syncwarp();
  if (a.dropout) {
    for (int idx = lane; idx < Lq * Lk; idx += 32) {
      const int i = idx / Lk;
      const int j = idx % Lk;
      float* wij = sp + i * (Lk + 1) + j;
      *wij = dropout_keep(a.seed, a.keep_threshold, a.row_offset + b, i * a.h + hd,
                          j * a.h + hd)
                 ? Num<T>::round(*wij / a.keep_div)
                 : 0.0f;
    }
    __syncwarp();
  }
  for (int i = 0; i < Lq; ++i) {
    const float* row = sp + i * (Lk + 1);
    float acc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = 0.0f;
    for (int j = 0; j < Lk; ++j)
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = fmaf(row[j], sv[j * kRowPad + lane + 32 * c], acc[c]);
    T* ob = (T*)a.out + b * a.o_sb + i * a.o_sl + hd * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) ob[lane + 32 * c] = Num<T>::from_f(acc[c]);
  }
}

// ------------------------------------------------- bf16: tensor-core path
constexpr int kAttnCtaWarps = 16;  // warps of a CTA at most
constexpr int kMaxHeads = 32;      // heads of a row: two a warp past 16
constexpr int kAttnSmemMax = 232448;
// Two CTAs an SM (64 registers a thread) only where two fit: D = 64 and
// short keys.
__host__ __device__ constexpr bool attn_two_ctas(int MQ, int NK8, int D) {
  return D == 64 && MQ == 1 && NK8 <= 2;
}

// the zero row every padded row reads at head width D: ldmatrix reads up
// to D columns of it
__host__ __device__ constexpr int zero_bytes(int D) { return 2 * D; }

// Shared memory of a CTA: the zero row, the per-warp partial sums of the
// all-padding mean (D/64 float2 a lane), and nbuf buffers of one staged row:
// its q, k and v positions, each h*D + 8 bf16 wide (the 16-byte pad makes
// ldmatrix conflict-free).
__host__ __device__ inline int attn_row_stride(int h, int D) { return h * D + 8; }
__host__ __device__ inline int attn_row_elems(int Lq, int Lk, int h, int D) {
  return (Lq + 2 * Lk) * attn_row_stride(h, D);
}
__host__ __device__ inline int attn_part_bytes(int h, int D) { return h * 32 * 8 * (D / 64); }
__host__ __device__ inline int attn_mma_smem(int Lq, int Lk, int h, int nbuf, int D) {
  return zero_bytes(D) + attn_part_bytes(h, D) + 2 * nbuf * attn_row_elems(Lq, Lk, h, D);
}

// Start the 16-byte cp.async loads of row b (every position's h heads) into
// the buffer at sq. A CTA has h*32 threads and a position h*D/8 chunks, so
// thread t copies chunk t % (hD/8) of positions t / (hD/8), + 256/D, ...
template <int D>
__device__ __forceinline__ void stage_row(const AttnArgs& a, int b, bf16* sq, int RS) {
  const int Lq = a.Lq, Lk = a.Lk;
  const int cpr = a.h * (D / 8);  // chunks of a position
  const int ch = (threadIdx.x % cpr) * 8;
  const bf16* qb = (const bf16*)a.q + b * a.q_sb + ch;
  const bf16* kb = (const bf16*)a.k + b * a.k_sb + ch;
  const bf16* vb = (const bf16*)a.v + b * a.v_sb + ch;
  for (int r = threadIdx.x / cpr; r < Lq + 2 * Lk; r += 256 / D) {
    const bf16* src = r < Lq ? qb + r * a.q_sl
                             : (r < Lq + Lk ? kb + (r - Lq) * a.k_sl : vb + (r - Lq - Lk) * a.v_sl);
    cp_async16(sq + r * RS + ch, src);  // q, k, v positions lie back to back
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// stage_row for a CTA of any thread count (two heads a warp): thread t
// copies chunks t, t + blockDim.x, ... of the row's positions.
template <int D>
__device__ __forceinline__ void stage_row_strided(const AttnArgs& a, int b, bf16* sq, int RS) {
  const int Lq = a.Lq, Lk = a.Lk;
  const int cpr = a.h * (D / 8);  // chunks of a position
  for (int c = threadIdx.x; c < (Lq + 2 * Lk) * cpr; c += blockDim.x) {
    const int r = c / cpr, ch = (c % cpr) * 8;
    const bf16* src =
        r < Lq ? (const bf16*)a.q + b * a.q_sb + r * a.q_sl
               : (r < Lq + Lk ? (const bf16*)a.k + b * a.k_sb + (r - Lq) * a.k_sl
                              : (const bf16*)a.v + b * a.v_sb + (r - Lq - Lk) * a.v_sl);
    cp_async16(sq + r * RS + ch, src + ch);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Rows [0, Lq) of this warp's head of the output from its staged slice so
// (row stride RS), with coalesced 16-byte stores.
template <int D>
__device__ __forceinline__ void store_head(const bf16* so, int RS, int Lq, bf16* dst,
                                           long long o_sl, int lane) {
  __syncwarp();
  for (int c = lane; c < Lq * (D / 8); c += 32) {
    const int r = c / (D / 8), ch = (c % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * o_sl + ch) =
        *reinterpret_cast<const uint4*>(so + r * RS + ch);
  }
}

// One head of one row, with at least one valid key (bit j of valid: key j),
// from staged operands: the head's q, k and v positions at hq, hk and hv,
// row stride RS (elements). Its Lq context rows go to dst (row stride
// o_sl), staged through hq. a supplies the key bias and dropout (kernels 2,
// 4 and 5) and h; kernel 1's fused [q|k|v] epilogue passes neither.
template <int MQ, int NK8, int D = kHeadDim>
__device__ __forceinline__ void attention_head(const AttnArgs& a, int b, int hd, int Lq, int Lk,
                                               bf16* hq, const bf16* hk, const bf16* hv, int RS,
                                               const bf16* zero, unsigned valid, bf16* dst,
                                               long long o_sl) {
  constexpr int MK = (NK8 + 1) / 2;  // k16 steps of PV over the keys
  // two query tiles at D 64 (128 registers: the loops over d below stay
  // rolled, else ptxas spills)
  constexpr int kUnrollD = MQ > 1 && D == 64 ? 1 : D / 32;
  const int h = a.h, lane = threadIdx.x % 32;
  const int lr = lane & 7, mat = lane >> 3, g = lane >> 2, q4 = lane & 3;
  // S = Q K^T over d = D
  float sacc[MQ][NK8][4];
#pragma unroll
  for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
    for (int nt = 0; nt < NK8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[mt][nt][e] = 0.0f;
#pragma unroll (kUnrollD)
  for (int hk2 = 0; hk2 < D / 32; ++hk2) {  // d in [32 hk2, 32 hk2 + 32): two k16 steps
    uint32_t bk[NK8][4];
#pragma unroll
    for (int nt = 0; nt < NK8; ++nt) {
      const int j = 8 * nt + lr, col = 32 * hk2 + 8 * mat;
      ldsm_x4(bk[nt], saddr(j < Lk ? hk + j * RS + col : zero + col));
    }
#pragma unroll
    for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int i = 16 * mt + lr + 8 * (mat & 1), col = 32 * hk2 + 16 * kk + 8 * (mat >> 1);
        uint32_t aq[4];
        ldsm_x4(aq, saddr(i < Lq ? hq + i * RS + col : zero + col));
#pragma unroll
        for (int nt = 0; nt < NK8; ++nt) mma16816(sacc[mt][nt], aq, bk[nt][2 * kk], bk[nt][2 * kk + 1]);
      }
  }

  // the weights on the fragments: accumulator e of tile (mt, nt) is query
  // 16 mt + g + 8 (e / 2), key 8 nt + 2 q4 + (e % 2); a query's keys lie in
  // the lane's quad
  float kbv[NK8][2];
#pragma unroll
  for (int nt = 0; nt < NK8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * nt + 2 * q4 + e;
      kbv[nt][e] = (a.kbias && j < Lk)
                       ? Num<bf16>::to_f(((const bf16*)a.kbias)[b * a.kb_sb + j * a.kb_sl +
                                                                hd * a.kb_sh])
                       : 0.0f;
    }
  const float sqrt_d = sqrtf((float)D);
  const float lowest = Num<bf16>::lowest();
#pragma unroll
  for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (16 * mt + 8 * hh >= Lq) continue;  // no query of this half tile: its P is unused
      const int i = 16 * mt + g + 8 * hh;
      float m = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NK8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * q4 + e;
          float s = Num<bf16>::round(Num<bf16>::round(sacc[mt][nt][2 * hh + e]) / sqrt_d);
          if (a.kbias) s = Num<bf16>::round(s + kbv[nt][e]);
          s = j < Lk ? (((valid >> j) & 1u) ? s : lowest) : -INFINITY;
          sacc[mt][nt][2 * hh + e] = s;
          m = fmaxf(m, s);
        }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NK8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * q4 + e;
          const float x = j < Lk ? expf(sacc[mt][nt][2 * hh + e] - m) : 0.0f;
          sacc[mt][nt][2 * hh + e] = x;
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
      for (int nt = 0; nt < NK8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * q4 + e;
          float w = Num<bf16>::round(sacc[mt][nt][2 * hh + e] / sum);
          if (a.dropout && i < Lq && j < Lk)
            w = dropout_keep(a.seed, a.keep_threshold, a.row_offset + b, i * h + hd,
                             j * h + hd)
                    ? Num<bf16>::round(w / a.keep_div)
                    : 0.0f;
          sacc[mt][nt][2 * hh + e] = w;
        }
    }

  // O = P V: P's fragments are the A operand as they stand (C row g, keys
  // 2 q4 + {0, 1} of n8 tile 2 ks, then of tile 2 ks + 1)
  uint32_t pf[MQ][MK][4];
#pragma unroll
  for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
    for (int ks = 0; ks < MK; ++ks)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        pf[mt][ks][r] = pack_bf16(sacc[mt][2 * ks][2 * r], sacc[mt][2 * ks][2 * r + 1]);
        pf[mt][ks][r + 2] = 2 * ks + 1 < NK8 ? pack_bf16(sacc[mt][2 * ks + 1][2 * r],
                                                         sacc[mt][2 * ks + 1][2 * r + 1])
                                             : 0u;
      }
#pragma unroll (kUnrollD)
  for (int half = 0; half < D / 32; ++half) {  // 32 of the D output columns at a time
    float acc[MQ][4][4];
#pragma unroll
    for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < MK; ++ks)
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        const int j = 16 * ks + lr + 8 * (mat & 1);
        const int col = 32 * half + 16 * pp + 8 * (mat >> 1);
        uint32_t bf[4];
        ldsm_x4_t(bf, saddr(j < Lk ? hv + j * RS + col : zero + col));
#pragma unroll
        for (int mt = 0; mt < MQ; ++mt) {
          mma16816(acc[mt][2 * pp], pf[mt][ks], bf[0], bf[1]);
          mma16816(acc[mt][2 * pp + 1], pf[mt][ks], bf[2], bf[3]);
        }
      }
    if (half == 0) __syncwarp();  // every lane's q reads are done: hq stages the output
#pragma unroll
    for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 16 * mt + g + 8 * r;
        if (i < Lq)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            *reinterpret_cast<uint32_t*>(hq + i * RS + 32 * half + 8 * n + 2 * q4) =
                pack_bf16(acc[mt][n][2 * r], acc[mt][n][2 * r + 1]);
      }
  }
  store_head<D>(hq, RS, Lq, dst, o_sl, lane);
}

// Head hd's value slice hv summed over the Lk positions into its D/64
// float2 partial sums (lane t: dims 2t + 64c, 2t + 64c + 1), the all-padding
// mean's share of the head.
template <int D>
__device__ __forceinline__ void value_sums(const bf16* hv, int RS, int Lk, float2* part,
                                           int lane) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (int j = 0; j < Lk; ++j) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(hv + j * RS + 64 * c + 2 * lane));
      acc.x += v.x;
      acc.y += v.y;
    }
    part[c * 32 + lane] = acc;
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
}

// A head with no valid key at rate > 0: its queries weight every merged key
// of the row alike, each weight dropped by its own Philox word, and the
// dropped weights multiply the merged value rows on the tensor cores. The
// keys come in groups (a CTA's heads [kk0, kk0 + hg) of each of the Lk
// positions), enumerated head by head: key t of a group is position j = t %
// Lk of head kk0 + t / Lk, merged key j h + kk0 + t / Lk, its value row at
// v0 + j RS + (t / Lk) D. So the 8 rows of an ldmatrix are 8 positions of a
// head, RS apart (conflict-free), not 8 heads of a position, D apart (every
// row in the same banks: 8 ways). Two passes a query tile mt: draw_keep_bits
// draws each (query, key) word once into a warp's scratch words, with no
// accumulator live; dropped_uniform_acc then builds the A fragments from
// those bits, with all D output columns in registers (64 floats at D 128).
struct KeyGroup {
  int hg, kk0;       // heads kk0 .. kk0 + hg - 1 of every position
  const bf16* v0;    // the group's value rows (position stride RS, head stride D)
};
// A warp's scratch of u32 words: word k of lane l at slot 32 k + l, slots
// `per_row` to a row of `stride` words (a padded shared-memory row).
struct BitScratch {
  uint32_t* base;
  int row_shift, stride;  // per_row = 1 << row_shift
  __device__ __forceinline__ uint32_t* at(int k, int lane) const {
    const int slot = 32 * k + lane;
    return base + (slot >> row_shift) * stride + (slot & ((1 << row_shift) - 1));
  }
};
// t / Lk for the t < 2048 of a group, as (t * m) >> 16 with m = ceil(2^16 /
// Lk): exact there for every Lk <= 32
__device__ __forceinline__ int div_lk(int t, int m) { return (t * m) >> 16; }

// Keep bits a k16 step: 4 where the tile's second 8 queries lie past Lq
// (bit 2 kh + u), else 8 (bit 4 r + 2 kh + u): entry (query 16 mt + g + 8 r,
// key 16 ks + 8 kh + 2 q4 + u) of the lane.
__device__ __forceinline__ int keep_bits_a_step(int Lq, int mt) {
  return Lq - 16 * mt > 8 ? 8 : 4;
}

// k16 steps over a group of hg heads' keys
__device__ __forceinline__ int key_steps(const AttnArgs& a, int hg) { return (a.Lk * hg + 15) / 16; }

// Pass 1: the lane's keep bits of query tile mt over the keys of c groups in
// turn, one stream of k16 steps packed into scratch words 0, 1, ...: group
// o holds heads [q hl, min(h, (q + 1) hl)), q = (rank + o) % c, of every
// position (a cluster's CTAs from this one on; c = 1, hl = h: the whole
// row). Two words at a time, keys t and t + 1 (16 warps an SM keep the
// integer pipes busy without more in flight).
__device__ __forceinline__ void draw_keep_bits(const AttnArgs& a, int b, int hd, int mt, int c,
                                               int rank, int hl, const BitScratch& sc) {
  const int Lq = a.Lq, Lk = a.Lk, h = a.h, lane = threadIdx.x % 32;
  const int g = lane >> 2, q4 = lane & 3, m = (65536 + Lk - 1) / Lk;
  const int nbits = keep_bits_a_step(Lq, mt), steps = 32 / nbits;
  const unsigned row = a.row_offset + b;
  uint32_t word = 0u;
  int filled = 0, k = 0;  // k16 steps in word, words stored
  for (int o = 0; o < c; ++o) {
    const int q = (rank + o) % c, hg = h - q * hl < hl ? h - q * hl : hl, nk = Lk * hg;
    for (int ks = 0; ks < key_steps(a, hg); ++ks) {
#pragma unroll 1
      for (int pr = 0; pr < nbits / 2; ++pr) {  // bits 2 pr, 2 pr + 1: (r, kh) = (pr / 2, pr % 2)
        const int i = 16 * mt + g + 8 * (pr >> 1), t = 16 * ks + 8 * (pr & 1) + 2 * q4;
        if (i >= Lq || t >= nk) continue;
        const int hh = div_lk(t, m), j = t - hh * Lk;
        const int kk = q * hl + j * h + hh;  // merged keys of t and t + 1
        const int kk1 = j + 1 < Lk ? kk + h : q * hl + hh + 1;
        const unsigned qi = (unsigned)(i * h + hd);
        const bool k0 = dropout_keep(a.seed, a.keep_threshold, row, qi, kk);
        const bool k1 = t + 1 < nk && dropout_keep(a.seed, a.keep_threshold, row, qi, kk1);
        word |= ((k0 ? 1u : 0u) | (k1 ? 2u : 0u)) << (filled * nbits + 2 * pr);
      }
      if (++filled == steps) {
        *sc.at(k++, lane) = word;
        word = 0u;
        filled = 0;
      }
    }
  }
  if (filled) *sc.at(k, lane) = word;
}

// Pass 2 for one group: acc (an m16 query tile: the lane's rows g and g + 8;
// NC output columns from c0, as NC/8 n8 tiles) += the dropped weights (wd
// where kept) times the group's value rows. The bits of the stream's k16
// steps ks0, ks0 + 1, ...: rows 0-7 from stream lo, rows 8-15 from stream hi
// (4 bits a step each, 2 kh + u; a null base: no such rows), or, with 8 bits
// a step, both from lo (rows 8-15 in the high nibble).
template <int NC>
__device__ __forceinline__ void dropped_uniform_acc(const AttnArgs& a, const KeyGroup& grp,
                                                    const BitScratch& lo, const BitScratch& hi,
                                                    int nbits, int ks0, int RS, int c0,
                                                    const bf16* zero, float wd,
                                                    float (&acc)[NC / 8][4], int D) {
  const int Lk = a.Lk, nk = Lk * grp.hg, lane = threadIdx.x % 32;
  const int lr = lane & 7, mat = lane >> 3, m = (65536 + Lk - 1) / Lk;
  const int steps = 32 / nbits;
  for (int ks = 0; ks < (nk + 15) / 16; ++ks) {
    const int word = (ks0 + ks) / steps, shift = (ks0 + ks) % steps * nbits;
    const uint32_t bl = lo.base ? *lo.at(word, lane) >> shift : 0u;
    const uint32_t bh = nbits == 8 ? bl >> 4 : (hi.base ? *hi.at(word, lane) >> shift : 0u);
    // A fragments: entry (row g + 8 r, keys 16 ks + 8 kh + 2 q4 + {0, 1}) in
    // register r + 2 kh
    uint32_t af[4];
    af[0] = pack_bf16(bl & 1u ? wd : 0.0f, bl & 2u ? wd : 0.0f);
    af[1] = pack_bf16(bh & 1u ? wd : 0.0f, bh & 2u ? wd : 0.0f);
    af[2] = pack_bf16(bl & 4u ? wd : 0.0f, bl & 8u ? wd : 0.0f);
    af[3] = pack_bf16(bh & 4u ? wd : 0.0f, bh & 8u ? wd : 0.0f);
    const int t = 16 * ks + lr + 8 * (mat & 1);
    const int hh = div_lk(t, m);
    const bf16* vrow = t < nk ? grp.v0 + (t - hh * Lk) * RS + hh * D + c0 : zero;
#pragma unroll
    for (int pp = 0; pp < NC / 16; ++pp) {  // 16 of the NC output columns at a time
      uint32_t bf[4];
      ldsm_x4_t(bf, saddr(vrow + 16 * pp + 8 * (mat >> 1)));
      mma16816(acc[2 * pp], af, bf[0], bf[1]);
      mma16816(acc[2 * pp + 1], af, bf[2], bf[3]);
    }
  }
}

// Rows [q0, q0 + 8) of tile rows 8 r (r = 0, 1) below Lq of acc (NC columns
// from c0), cast to bf16, into the staged slices o0 (tile rows 0-7) and o1
// (rows 8-15; null: not stored), row stride RS, for store_head / store_cols.
template <int NC>
__device__ __forceinline__ void stage_acc_rows(const float (&acc)[NC / 8][4], int q0, int Lq,
                                               bf16* o0, bf16* o1, int RS, int c0, int lane) {
  const int g = lane >> 2, q4 = lane & 3, i = q0 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* o = r ? o1 : o0;
    if (o != nullptr && i + (o0 == o1 ? 8 * r : 0) < Lq)
#pragma unroll
      for (int n = 0; n < NC / 8; ++n)
        *reinterpret_cast<uint32_t*>(o + (i + (o0 == o1 ? 8 * r : 0)) * RS + c0 + 8 * n +
                                     2 * q4) = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// Rows [0, Lq) and columns [c0, c0 + NC) of a head's staged slice so (row
// stride RS) to dst (row stride o_sl), with 16-byte stores.
template <int NC>
__device__ __forceinline__ void store_cols(const bf16* so, int RS, int Lq, int c0, bf16* dst,
                                           long long o_sl, int lane) {
  __syncwarp();
  for (int ch = lane; ch < Lq * (NC / 8); ch += 32) {
    const int r = ch / (NC / 8), col = c0 + (ch % (NC / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * o_sl + col) =
        *reinterpret_cast<const uint4*>(so + r * RS + col);
  }
}

// One staged row b (buffer sq) through head hd: valid holds the head's
// valid keys, any_padding whether some head of the row has none. MQ: m16
// tiles over the queries (Lq <= 16 * MQ); NK8: n8 tiles over the keys (Lk
// <= 8 * NK8). kRowSums: the warp sums head hd's values into part for the
// all-padding mean and waits for the CTA here; without it the caller has
// summed every head's (two heads a warp).
template <int MQ, int NK8, int D, bool kRowSums = true>
__device__ __forceinline__ void attention_row(const AttnArgs& a, int b, int hd, bf16* sq, int RS,
                                              const bf16* zero, float2* part, unsigned valid,
                                              int any_padding) {
  const int h = a.h, Lq = a.Lq, Lk = a.Lk;
  const bf16* sk = sq + Lq * RS;
  const bf16* sv = sk + Lk * RS;
  const int lane = threadIdx.x % 32;
  bf16* hq = sq + hd * D;  // this head's slices; hq stages the output
  const bf16* hk = sk + hd * D;
  const bf16* hv = sv + hd * D;
  bf16* dst = (bf16*)a.out + b * a.o_sb + hd * D;
  const float w_uniform = Num<bf16>::round(1.0f / (float)(Lk * h));

  if (any_padding && !a.dropout) {
    // uniform weights over all Lk*h merged value rows: the row's sum, once
    // (warp w sums head w's slice over the positions, lane t dims 2t + 64c,
    // 2t + 64c + 1 for c < D/64)
    constexpr int kP = D / 64;
    if constexpr (kRowSums) {
      value_sums<D>(hv, RS, Lk, part + hd * kP * 32, lane);
      __syncthreads();
    }
    if (valid == 0u) {
#pragma unroll
      for (int c = 0; c < kP; ++c) {
        float2 tot = make_float2(0.0f, 0.0f);
        for (int w = 0; w < h; ++w) {
          tot.x += part[(w * kP + c) * 32 + lane].x;
          tot.y += part[(w * kP + c) * 32 + lane].y;
        }
        const uint32_t o = pack_bf16(tot.x * w_uniform, tot.y * w_uniform);
        for (int i = 0; i < Lq; ++i)
          *reinterpret_cast<uint32_t*>(dst + i * a.o_sl + 64 * c + 2 * lane) = o;
      }
      return;
    }
  }

  if (valid == 0u) {
    // dropout on a head with no valid key: its queries' dropped uniform
    // weights over all Lk*h merged keys times the merged V rows, a query
    // tile at a time (each word drawn once into the bits, then read by each
    // pass of NC output columns: all D of them, or 32 where two CTAs share
    // an SM's registers)
    // the head's k slice, which nothing reads, holds its keep bits: D/2
    // words a row of RS/2
    constexpr int NC = attn_two_ctas(MQ, NK8, D) ? 32 : D;
    const float wd = Num<bf16>::round(w_uniform / a.keep_div);
    const KeyGroup grp{h, 0, sv};
    const BitScratch sc{reinterpret_cast<uint32_t*>(const_cast<bf16*>(hk)), D == 64 ? 5 : 6,
                        RS / 2};
#pragma unroll 1
    for (int mt = 0; mt < MQ; ++mt) {
      draw_keep_bits(a, b, hd, mt, 1, 0, h, sc);
#pragma unroll 1
      for (int c0 = 0; c0 < D; c0 += NC) {
        float acc[NC / 8][4];
        zero_acc<NC>(acc);
        dropped_uniform_acc<NC>(a, grp, sc, BitScratch{nullptr, 0, 0}, keep_bits_a_step(Lq, mt),
                                0, RS, c0, zero, wd, acc, D);
        stage_acc_rows<NC>(acc, 16 * mt, Lq, hq, hq, RS, c0, lane);
      }
    }
    store_head<D>(hq, RS, Lq, dst, a.o_sl, lane);
    return;
  }

  attention_head<MQ, NK8, D>(a, b, hd, Lq, Lk, hq, hk, hv, RS, zero, valid, dst, a.o_sl);
}

// Whether key `lane` of head hd in row b is valid (lanes past Lk: no).
__device__ __forceinline__ bool key_valid(const AttnArgs& a, int b, int hd, int lane) {
  return lane < a.Lk &&
         (a.mask == nullptr || a.mask[b * a.m_sb + lane * a.m_sl + hd * a.m_sh] > 0.0f);
}

// Persistent: each CTA walks rows blockIdx.x, + gridDim.x, ...; with two
// buffers (nbuf == 2) the next row's loads (and its key mask) are in flight
// while this one is computed, and one barrier a row both publishes the row
// and frees the other buffer.
template <int MQ, int NK8, int D>
__global__ void __launch_bounds__(kAttnCtaWarps * 32, attn_two_ctas(MQ, NK8, D) ? 2 : 1)
attention_mma_kernel(AttnArgs a, int nbuf) {
  extern __shared__ __align__(16) uint8_t attn_smem[];
  const int RS = attn_row_stride(a.h, D);
  const int row_elems = attn_row_elems(a.Lq, a.Lk, a.h, D);
  bf16* zero = reinterpret_cast<bf16*>(attn_smem);
  float2* part = reinterpret_cast<float2*>(attn_smem + zero_bytes(D));  // [h][D/64][32]
  bf16* rows =
      reinterpret_cast<bf16*>(attn_smem + zero_bytes(D) + attn_part_bytes(a.h, D));
  const int hd = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = threadIdx.x; t < D; t += blockDim.x) zero[t] = __float2bfloat16_rn(0.0f);
  bool ok_next = false;
  if (blockIdx.x < a.B) {
    stage_row<D>(a, blockIdx.x, rows, RS);
    ok_next = key_valid(a, blockIdx.x, hd, lane);
  }
  int it = 0;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x, ++it) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // row b's loads
    const unsigned valid = __ballot_sync(0xffffffffu, ok_next);
    // publishes row b, and every thread is done with row b - gridDim.x;
    // whether any head of row b has no valid key
    const int any_padding = __syncthreads_or(valid == 0u);
    const int nb = b + gridDim.x;
    if (nbuf == 2 && nb < a.B) {
      stage_row<D>(a, nb, rows + ((it + 1) & 1) * row_elems, RS);
      ok_next = key_valid(a, nb, hd, lane);
    }
    attention_row<MQ, NK8, D>(a, b, hd, rows + (nbuf == 2 ? (it & 1) * row_elems : 0), RS, zero,
                              part, valid, any_padding);
    if (nbuf == 1 && nb < a.B) {
      __syncthreads();  // row b's buffer is free
      stage_row<D>(a, nb, rows, RS);
      ok_next = key_valid(a, nb, hd, lane);
    }
  }
}

// Past 16 heads, one m16 query tile: 16 warps, warp w runs heads w and w +
// 16 of each row (attention_mma_kernel's loop otherwise). Where some head of
// the row has no valid key at rate 0, each warp sums both its heads' values
// before the CTA's one barrier, so the all-padding mean still covers every
// head.
template <int NK8, int D>
__global__ void __launch_bounds__(kAttnCtaWarps * 32, 1)
attention_mma2_kernel(AttnArgs a, int nbuf) {
  extern __shared__ __align__(16) uint8_t attn_smem[];
  constexpr int kP = D / 64;
  const int RS = attn_row_stride(a.h, D);
  const int row_elems = attn_row_elems(a.Lq, a.Lk, a.h, D);
  bf16* zero = reinterpret_cast<bf16*>(attn_smem);
  float2* part = reinterpret_cast<float2*>(attn_smem + zero_bytes(D));  // [h][D/64][32]
  bf16* rows =
      reinterpret_cast<bf16*>(attn_smem + zero_bytes(D) + attn_part_bytes(a.h, D));
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h2 = w + kAttnCtaWarps;  // the warp's second head
  const bool two = h2 < a.h;
  for (int t = threadIdx.x; t < D; t += blockDim.x) zero[t] = __float2bfloat16_rn(0.0f);
  bool ok0 = false, ok1 = false;
  if (blockIdx.x < a.B) {
    stage_row_strided<D>(a, blockIdx.x, rows, RS);
    ok0 = key_valid(a, blockIdx.x, w, lane);
    ok1 = two && key_valid(a, blockIdx.x, h2, lane);
  }
  int it = 0;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x, ++it) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // row b's loads
    const unsigned v0 = __ballot_sync(0xffffffffu, ok0);
    const unsigned v1 = __ballot_sync(0xffffffffu, ok1);
    const int any_padding = __syncthreads_or(v0 == 0u || (two && v1 == 0u));
    const int nb = b + gridDim.x;
    if (nbuf == 2 && nb < a.B) {
      stage_row_strided<D>(a, nb, rows + ((it + 1) & 1) * row_elems, RS);
      ok0 = key_valid(a, nb, w, lane);
      ok1 = two && key_valid(a, nb, h2, lane);
    }
    bf16* sq = rows + (nbuf == 2 ? (it & 1) * row_elems : 0);
    if (any_padding && !a.dropout) {
      const bf16* sv = sq + (a.Lq + a.Lk) * RS;
      value_sums<D>(sv + w * D, RS, a.Lk, part + w * kP * 32, lane);
      if (two) value_sums<D>(sv + h2 * D, RS, a.Lk, part + h2 * kP * 32, lane);
      __syncthreads();  // every head's sums
    }
#pragma unroll 1
    for (int s = 0; s < 2; ++s) {
      if (s == 1 && !two) break;
      attention_row<1, NK8, D, false>(a, b, s ? h2 : w, sq, RS, zero, part, s ? v1 : v0,
                                      any_padding);
    }
    if (nbuf == 1 && nb < a.B) {
      __syncthreads();  // row b's buffer is free
      stage_row_strided<D>(a, nb, rows, RS);
      ok0 = key_valid(a, nb, w, lane);
      ok1 = two && key_valid(a, nb, h2, lane);
    }
  }
}

// ------------------------------------- past 16 heads of 128: CTA clusters
// A row of h heads over a cluster of c CTAs: CTA r takes heads [r hl,
// min(h, (r + 1) hl)), hl = ceil(h / c), one warp a head (attention_head
// with one m16 query tile, as attention_mma_kernel runs it). Each CTA holds
// a ring of stages, each its heads' share of one row's q, k and v positions
// (hl D + 8 bf16 a position: ldmatrix stays conflict-free), filled with a
// bulk copy a position (cp.async.bulk, issued by the warps in turn) that
// completes on the stage's full mbarrier; the warps arrive on its empty
// mbarrier when done.
// Shared memory of a CTA: the stages, its heads' value sums ([hl][D/64][32]
// float2) and two parities of every CTA's total of them ([2][c][D/64][32]
// float2; the all-padding mean), the zero row, for each stage a full and an
// empty mbarrier and a flag word a warp, and a word a warp.
constexpr int kClusterMaxStages = 4;
constexpr int kClusterMaxCtas = 3;  // attn_cluster_plan's largest cluster
__host__ __device__ inline int attn_cluster_fixed_bytes(int hl, int D) {
  return attn_part_bytes(hl, D) + 2 * attn_part_bytes(kClusterMaxCtas, D) + zero_bytes(D) +
         kClusterMaxStages * (2 * 8 + kAttnCtaWarps * 4) + kAttnCtaWarps * 4;
}
// Warps of a CTA: one a head, an even count (the rate > 0 padding heads go
// in warp pairs)
__host__ __device__ inline int attn_cluster_warps(int hl) { return (hl + 1) / 2 * 2; }
struct ClusterPlan {
  int c, hl, stages, smem;  // CTAs a cluster, heads a CTA, stages, bytes a CTA
};
// Two CTAs a row, or three where two stages of a half row do not fit (an
// odd head count's larger half at the longest rows admitted); up to
// kClusterMaxStages stages. Every row that attn_mma_smem admits gets two
// or more (three at 32 heads of 128 with Lq 1, Lk <= 8).
__host__ __device__ inline ClusterPlan attn_cluster_plan(int Lq, int Lk, int h, int D) {
  ClusterPlan p{0, 0, 0, 0};
  for (int c = 2; c <= 3; ++c) {
    const int hl = (h + c - 1) / c;
    const int fixed = attn_cluster_fixed_bytes(hl, D);
    const int stage = 2 * attn_row_elems(Lq, Lk, hl, D);
    int s = (kAttnSmemMax - fixed) / stage;
    if (s > kClusterMaxStages) s = kClusterMaxStages;
    p = ClusterPlan{c, hl, s, fixed + s * stage};
    if (s >= 2) break;
  }
  return p;
}

// Warp w's part of row b's share (heads [h0, h0 + share / (2 D)) of each q,
// k and v position) into the stage at dst (row stride RS): positions w, w +
// nw, ..., one bulk copy each, their bytes added to bar's phase first; by
// one lane. Spread over the warps, the copies' issue (a few hundred clocks
// each, address arithmetic and the uniform registers the bulk copy takes)
// stays off any one warp's path.
template <int D>
__device__ __forceinline__ void stage_share(const AttnArgs& a, int b, bf16* dst, int RS, int h0,
                                            unsigned share, uint64_t* bar, int w, int nw) {
  const int Lq = a.Lq, Lk = a.Lk, P = Lq + 2 * Lk;
  if (w >= P) return;
  mbar_add_tx(bar, (unsigned)((P - w + nw - 1) / nw) * share);
  for (int r = w; r < P; r += nw) {
    const bf16* src = r < Lq ? (const bf16*)a.q + b * a.q_sb + r * a.q_sl
                             : (r < Lq + Lk ? (const bf16*)a.k + b * a.k_sb + (r - Lq) * a.k_sl
                                            : (const bf16*)a.v + b * a.v_sb + (r - Lq - Lk) * a.v_sl);
    bulk_load(dst + r * RS, src + h0 * D, share, bar);
  }
}

// Key `lane` of row b for this warp's heads w, w + hl, ... (c of them: the
// CTA's hl warps cover every head of the row), loaded ahead into m; 1 where
// there is no mask or no such head.
__device__ __forceinline__ void load_key_mask(const AttnArgs& a, int b, int w, int hl, int c,
                                              int lane, float (&m)[kClusterMaxCtas]) {
#pragma unroll
  for (int k = 0; k < kClusterMaxCtas; ++k) {
    const int head = w + k * hl;
    m[k] = 1.0f;
    // a volatile load: issued here, a row before its use, not sunk to it
    if (k < c && head < a.h && lane < a.Lk && a.mask != nullptr)
      asm volatile("ld.global.nc.f32 %0, [%1];\n"
                   : "=f"(m[k])
                   : "l"(a.mask + b * a.m_sb + lane * a.m_sl + head * a.m_sh));
  }
}

// Publishes whether one of the warp's heads in m has no valid key (the
// flag word, then an arrival on the stage's full barrier, which releases
// it); returns the valid keys of the warp's own head, w + rank hl.
__device__ __forceinline__ unsigned publish_key_mask(const AttnArgs& a,
                                                     const float (&m)[kClusterMaxCtas], int w,
                                                     int hl, int c, int rank, int lane,
                                                     uint32_t* flag, uint64_t* full) {
  unsigned own = 0u, pad = 0u;
#pragma unroll
  for (int k = 0; k < kClusterMaxCtas; ++k) {
    if (k >= c || w + k * hl >= a.h) continue;  // uniform across the warp
    const unsigned v = __ballot_sync(0xffffffffu, lane < a.Lk && m[k] > 0.0f);
    if (v == 0u) pad = 1u;
    if (k == rank) own = v;
  }
  if (lane == 0) {
    *flag = pad;
    mbar_arrive(full);
  }
  return own;
}

// Persistent clusters: cluster i walks rows i, + nclusters, ...; within a
// row no CTA-wide barrier. The warps keep the ring full: as soon as every
// warp has released row n - 1's stage, each issues its positions of row
// n - 1 + stages into it, so while a row is computed the next one or more
// rows' loads are in flight. Each warp loads row n + 2's key mask into
// registers while row n is computed, for heads w, w + hl, ... (the CTA's
// warps cover every head of the row, so each CTA knows whether some head
// has no valid key without an exchange), and publishes that for row n + 1
// in the stage's flag word before arriving on its full barrier. Rows where
// some head has no valid key cross the cluster:
// - rate 0: every warp sums its head's values (value_sums); after a CTA
//   barrier the first warps add them into the CTA's total, which they store
//   into every CTA's tot[parity][rank] (st.shared::cluster: no round trip),
//   and all arrive on the cluster barrier; the heads with a valid key run
//   meanwhile; after the wait a head without one adds the c totals from its
//   own shared memory. The parity flips each such row, so a peer writes
//   tot[p] again only after this CTA passed the next such row's barrier,
//   i.e. after it read tot[p].
// - rate > 0: a head without a valid key weights all Lk h merged keys, a
//   CTA holding only its share of their values: the heads with one run;
//   after a cluster barrier (every peer's stage landed and its valid heads
//   done) the CTA copies each peer's value share in turn into its own k
//   region (free by then) and the warp accumulates, in f32 registers, its
//   own share's keys and each peer's; one cast at the end. Each Philox word
//   is drawn once, by the warp of the query's head. A last cluster barrier
//   keeps the stage until the peers' copies are done.
template <int NK8, int D>
__global__ void __launch_bounds__(kAttnCtaWarps * 32, 1)
attention_cluster_kernel(AttnArgs a, int hl, int nstage) {
  extern __shared__ __align__(16) uint8_t attn_smem[];
  constexpr int kP = D / 64;
  const int h = a.h, Lq = a.Lq, Lk = a.Lk;
  const int RS = attn_row_stride(hl, D);
  const int stage_elems = attn_row_elems(Lq, Lk, hl, D);
  bf16* stages = reinterpret_cast<bf16*>(attn_smem);
  float2* part = reinterpret_cast<float2*>(stages + nstage * stage_elems);  // [hl][kP][32]
  float2* tot = part + hl * kP * 32;  // [2][kClusterMaxCtas][kP][32]
  bf16* zero = reinterpret_cast<bf16*>(tot + 2 * kClusterMaxCtas * kP * 32);
  uint64_t* full = reinterpret_cast<uint64_t*>(zero + D);
  uint64_t* empty = full + kClusterMaxStages;
  uint32_t* flags = reinterpret_cast<uint32_t*>(empty + kClusterMaxStages);  // [stage][warp]
  uint32_t* uni = flags + kClusterMaxStages * kAttnCtaWarps;  // [warp]: a head without a valid key

  const int rank = (int)cluster_reg(0), c = (int)cluster_reg(1);
  const int cid = (int)cluster_reg(2), ncl = (int)cluster_reg(3);
  const int nw = blockDim.x / 32, w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = rank * hl;
  const int hr = h - h0 < hl ? h - h0 : hl;  // this CTA's heads: warps w >= hr have none
  const int hd = h0 + w;                     // this warp's head
  const bool mine = w < hr;
  // whether this cluster has an n-th row (cid < B: the grid has at most B
  // clusters); from a.B, so that nothing more stays live across a row
  auto has_row = [&](int n) { return cid + n * ncl < a.B; };
  auto heads_of = [&](int q) { return h - q * hl < hl ? h - q * hl : hl; };  // CTA q's heads
  const unsigned share = (unsigned)(hr * D * 2);  // bytes of a position's share

  for (int t = threadIdx.x; t < D; t += blockDim.x) zero[t] = __float2bfloat16_rn(0.0f);
  if (threadIdx.x == 0) {
    for (int s = 0; s < nstage; ++s) {
      mbar_init(&full[s], nw);  // each warp's flags, after its copies' bytes
      mbar_init(&empty[s], nw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the barriers and the zero row; every peer runs before any access to its
  // shared memory
  cluster_sync();

  // this warp's part of row n's share into stage n % nstage, by lane 0
  auto produce = [&](int n) {
    const int s = n % nstage;
    stage_share<D>(a, cid + n * ncl, stages + s * stage_elems, RS, h0, share, &full[s], w, nw);
  };
  float m[kClusterMaxCtas];  // this warp's share of a later row's key mask
  auto publish = [&](int n) {
    const int s = n % nstage;
    return publish_key_mask(a, m, w, hl, c, rank, lane, &flags[s * kAttnCtaWarps + w], &full[s]);
  };
  if (lane == 0)
    for (int n = 0; n < nstage && has_row(n); ++n) produce(n);
  load_key_mask(a, cid, w, hl, c, lane, m);  // every cluster has a row
  unsigned valid_next = publish(0);
  if (has_row(1)) load_key_mask(a, cid + ncl, w, hl, c, lane, m);
  int npad = 0;  // rate-0 rows so far whose mean crossed the cluster
  for (int n = 0; has_row(n); ++n) {
    const int b = cid + n * ncl, s = n % nstage;
    if (lane == 0 && n >= 1 && has_row(n - 1 + nstage)) {
      mbar_wait(&empty[(n - 1) % nstage], ((n - 1) / nstage) & 1);
      produce(n - 1 + nstage);
    }
    const unsigned valid = valid_next;
    mbar_wait(&full[s], (n / nstage) & 1);
    const int any_padding =
        __any_sync(0xffffffffu, lane < nw && flags[s * kAttnCtaWarps + lane] != 0u);
    // row n + 1's flags, from its mask loaded a row ago (every warp has read
    // this slot's previous row: it arrived for row n after reading row n -
    // 1's); row n + 2's mask in flight through row n
    if (has_row(n + 1)) {
      valid_next = publish(n + 1);
      if (has_row(n + 2)) load_key_mask(a, b + 2 * ncl, w, hl, c, lane, m);
    }

    bf16* sq = stages + s * stage_elems;
    bf16* sk = sq + Lq * RS;
    const bf16* sv = sk + Lk * RS;
    bf16* hq = sq + w * D;  // this head's slices; hq stages the output
    bf16* dst = (bf16*)a.out + b * a.o_sb + hd * D;
    const bool run = mine && valid != 0u;  // a head with a valid key
    const bool uniform = mine && valid == 0u;
    if (!any_padding) {
      if (mine) attention_head<1, NK8, D>(a, b, hd, Lq, Lk, hq, sk + w * D, sv + w * D, RS, zero,
                                          valid, dst, a.o_sl);
    } else if (!a.dropout) {
      float2* tp = tot + (npad & 1) * kClusterMaxCtas * kP * 32;  // [c][kP][32]
      if (mine) value_sums<D>(sv + w * D, RS, Lk, part + w * kP * 32, lane);
      __syncthreads();
      if (w < kP) {  // warp w: the CTA's total of columns 2 lane + 64 w, + 1
        float2 t = make_float2(0.0f, 0.0f);
        for (int k = 0; k < hr; ++k) {
          const float2 v = part[(k * kP + w) * 32 + lane];
          t.x += v.x;
          t.y += v.y;
        }
        float2* at = tp + (rank * kP + w) * 32 + lane;
        *at = t;
        for (int q = 0; q < c; ++q)
          if (q != rank) st_cluster_f2(map_rank(smem_u32(at), q), t);
      }
      cluster_arrive();
      if (run) attention_head<1, NK8, D>(a, b, hd, Lq, Lk, hq, sk + w * D, sv + w * D, RS, zero,
                                         valid, dst, a.o_sl);
      cluster_wait();
      if (uniform) {
        const float w_uniform = Num<bf16>::round(1.0f / (float)(Lk * h));
#pragma unroll
        for (int cc = 0; cc < kP; ++cc) {
          float2 t = make_float2(0.0f, 0.0f);
          for (int q = 0; q < c; ++q) {
            const float2 v = tp[(q * kP + cc) * 32 + lane];
            t.x += v.x;
            t.y += v.y;
          }
          const uint32_t o = pack_bf16(t.x * w_uniform, t.y * w_uniform);
          for (int i = 0; i < Lq; ++i)
            *reinterpret_cast<uint32_t*>(dst + i * a.o_sl + 64 * cc + 2 * lane) = o;
        }
      }
      ++npad;
    } else {
      if (run) attention_head<1, NK8, D>(a, b, hd, Lq, Lk, hq, sk + w * D, sv + w * D, RS, zero,
                                         valid, dst, a.o_sl);
      // the keep bits of every group first (needing no values), in this
      // warp's share of part and tot (unused at rate > 0): the local share's
      // keys, then each peer's in turn
      // a head's warp's share of part and tot, in words of 32 lanes
      const int bits_words =
          (attn_part_bytes(hl, D) + 2 * attn_part_bytes(kClusterMaxCtas, D)) / 4 / hl / 32;
      auto bits_of = [&](int e, bool use) {  // warp e's bits
        return BitScratch{use ? reinterpret_cast<uint32_t*>(part) + e * bits_words * 32 : nullptr,
                          30, 0};
      };
      if (uniform) draw_keep_bits(a, b, hd, 0, c, rank, hl, bits_of(w, true));
      if (lane == 0) uni[w] = uniform ? 1u : 0u;
      cluster_sync();  // every stage landed, every valid head done, every warp's bits drawn
      // warps 2p and 2p + 1 take the pair's heads (local 2p and 2p + 1)
      // together, each half of the D columns: at Lq <= 8 both heads'
      // queries in one m16 tile (rows 0-7 and 8-15), else a head at a time.
      // So each value row is read and multiplied once for two heads.
      const int p2 = w & ~1, c0 = (w & 1) * (D / 2);
      const bool ua = uni[p2] != 0u, ub = uni[p2 + 1] != 0u;
      const bool stacked = Lq <= 8;
      const float wd = Num<bf16>::round(Num<bf16>::round(1.0f / (float)(Lk * h)) / a.keep_div);
      int pulled = -1;  // the peer whose value share sits in the k region
#pragma unroll 1
      for (int e = 0; e < (stacked ? 1 : 2); ++e) {
        const int ha = p2 + e;  // the tile's head (stacked: and p2 + 1)
        const bool use = e ? ub : ua, use_b = stacked && ub;
        const BitScratch none{nullptr, 0, 0};
        float acc[D / 16][4];
        zero_acc<D / 2>(acc);
        int ks0 = 0;  // this group's first k16 step in the bits' stream
        for (int o = 0; o < c; ++o) {
          const int src = (rank + o) % c, hs = heads_of(src);
          if (o > 0 && pulled != src) {
            // the peer's value share, position j into this CTA's k slot j
            __syncthreads();  // the k region's last values are read
            const int cpp = hs * D / 8;  // 16-byte chunks of a position's share
            const uint32_t from = map_rank(smem_u32(sv), src);
            for (int t = threadIdx.x; t < Lk * cpp; t += blockDim.x) {
              const int j = t / cpp, e8 = (t % cpp) * 8;
              *reinterpret_cast<uint4*>(sk + j * RS + e8) =
                  ld_cluster_v4(from + 2 * (j * RS + e8));
            }
            __syncthreads();
            pulled = src;
          }
          if (use || use_b)
            dropped_uniform_acc<D / 2>(a, KeyGroup{hs, src * hl, o ? sk : sv}, bits_of(ha, use),
                                       stacked ? bits_of(p2 + 1, use_b) : none, stacked ? 4 : 8,
                                       ks0, RS, c0, zero, wd, acc, D);
          ks0 += key_steps(a, hs);
        }
        bf16* oa = use ? sq + ha * D : nullptr;
        bf16* ob = stacked ? (use_b ? sq + (p2 + 1) * D : nullptr) : oa;
        stage_acc_rows<D / 2>(acc, 0, Lq, oa, ob, RS, c0, lane);
        bf16* out_row = (bf16*)a.out + b * a.o_sb + h0 * D;
        if (oa) store_cols<D / 2>(oa, RS, Lq, c0, out_row + ha * D, a.o_sl, lane);
        if (stacked && ob) store_cols<D / 2>(ob, RS, Lq, c0, out_row + (p2 + 1) * D, a.o_sl, lane);
      }
      cluster_sync();  // the peers' copies of this CTA's values are done
    }
    fence_proxy_async();  // this thread's writes to the stage before its next bulk copies
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  cluster_sync();  // no CTA leaves while a peer may read its shared memory
}

// attention_cluster_kernel's launch at plan p (attr must outlive cfg), and
// how many of its clusters the card holds at once (fit).
template <int NK8, int D>
cudaError_t cluster_config(const ClusterPlan& p, cudaStream_t stream, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg, int* fit) {
  void (*kernel)(AttnArgs, int, int) = attention_cluster_kernel<NK8, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)p.c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)p.c);
  cfg->blockDim = dim3((unsigned)(attn_cluster_warps(p.hl) * 32));
  cfg->dynamicSmemBytes = (size_t)p.smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(fit, kernel, cfg);
  if (err != cudaSuccess) return err;
  return *fit < 1 ? cudaErrorInvalidValue : cudaSuccess;
}
template <int NK8, int D>
cudaError_t cluster_fit(const ClusterPlan& p, int* fit) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  return cluster_config<NK8, D>(p, 0, attr, &cfg, fit);
}

// attention_cluster_kernel over every row: attn_cluster_plan's cluster and
// stages, as many clusters as the card holds at once (at most one a row).
// A launch the card refuses returns its error.
template <int NK8, int D>
cudaError_t launch_attention_cluster(const AttnArgs& a, cudaStream_t stream) {
  const ClusterPlan p = attn_cluster_plan(a.Lq, a.Lk, a.h, D);
  if (p.stages < 2) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int fit = 0;  // clusters resident at once
  cudaError_t err = cluster_config<NK8, D>(p, stream, attr, &cfg, &fit);
  if (err != cudaSuccess) return err;
  const long long clusters = fit < a.B ? fit : a.B;
  cfg.gridDim = dim3((unsigned)(clusters * p.c));
  err = cudaLaunchKernelEx(&cfg, attention_cluster_kernel<NK8, D>, a, p.hl, p.stages);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Persistent CTAs of `threads` threads over the rows, as many as fit an SM
// (at most one a row), with two row buffers where they fit.
template <int D>
cudaError_t launch_rows(void (*kernel)(AttnArgs, int), const AttnArgs& a, int threads,
                        cudaStream_t stream) {
  const int nbuf = attn_mma_smem(a.Lq, a.Lk, a.h, 2, D) <= kAttnSmemMax ? 2 : 1;
  const int smem = attn_mma_smem(a.Lq, a.Lk, a.h, nbuf, D);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const long long grid = (long long)sms * per_sm < a.B ? (long long)sms * per_sm : a.B;
  kernel<<<(unsigned)grid, threads, smem, stream>>>(a, nbuf);
  return cudaGetLastError();
}

template <int MQ, int NK8, int D>
cudaError_t launch_attention_mma(const AttnArgs& a, cudaStream_t stream) {
  if (a.h <= kAttnCtaWarps)
    return launch_rows<D>(attention_mma_kernel<MQ, NK8, D>, a, a.h * 32, stream);
  // Past 16 heads (one m16 query tile): at D 128 a row stages up to 213 KB
  // of the SM's 227, one buffer, so the next row's loads would wait for
  // this one's products: the row is split over a cluster. At D 64 (32 heads
  // stage 61-107 KB a row at Lq + 2 Lk 15-26) two buffers fit, and
  // attention_mma2_kernel keeps the next row in flight itself.
  if constexpr (MQ == 1) {
    if constexpr (D == 128) return launch_attention_cluster<NK8, D>(a, stream);
    else return launch_rows<D>(attention_mma2_kernel<NK8, D>, a, kAttnCtaWarps * 32, stream);
  }
  return cudaErrorInvalidValue;  // past 16 heads at most 16 queries
}

// bf16 operands: position rows and the output 16-byte aligned (the wrappers'
// layouts are); h <= kMaxHeads (32), Lq <= 16 past 16 heads, and the staged
// row within the SM's shared memory.
template <int D>
inline cudaError_t launch_attention_bf16(const AttnArgs& a, cudaStream_t s) {
  if (a.B <= 0) return cudaSuccess;
  if (a.h < 1 || a.h > kMaxHeads || attn_mma_smem(a.Lq, a.Lk, a.h, 1, D) > kAttnSmemMax)
    return cudaErrorInvalidValue;
  const int mq = (a.Lq + 15) / 16, nk = (a.Lk + 7) / 8;
  if (mq == 1) {
    switch (nk) {
      case 1: return launch_attention_mma<1, 1, D>(a, s);
      case 2: return launch_attention_mma<1, 2, D>(a, s);
      case 3: return launch_attention_mma<1, 3, D>(a, s);
      case 4: return launch_attention_mma<1, 4, D>(a, s);
    }
  } else if (mq == 2) {
    switch (nk) {
      case 1: return launch_attention_mma<2, 1, D>(a, s);
      case 2: return launch_attention_mma<2, 2, D>(a, s);
      case 3: return launch_attention_mma<2, 3, D>(a, s);
      case 4: return launch_attention_mma<2, 4, D>(a, s);
    }
  }
  return cudaErrorInvalidValue;  // Lq, Lk outside 1..32
}

// Warps of an f32 block: kAttnWarps, or as many as the SM's shared memory
// holds (long rows at D = 128).
__host__ __device__ inline int f32_warps(size_t bytes_per_warp) {
  const size_t fit = (size_t)kAttnSmemMax / bytes_per_warp;
  return fit < (size_t)kAttnWarps ? (int)fit : kAttnWarps;
}

template <int D>
inline cudaError_t launch_attention_f32(const AttnArgs& a, cudaStream_t stream) {
  const size_t per_warp = sizeof(float) * (size_t)attn_smem_floats_per_warp(a.Lq, a.Lk, D);
  const int warps = f32_warps(per_warp);
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t smem = warps * per_warp;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long pairs = (long long)a.B * a.h;
  const unsigned grid = (unsigned)((pairs + warps - 1) / warps);
  attention_kernel<float, D><<<grid, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// At head width D (kernels 4 and 5 take the default, 64).
template <typename T, int D = kHeadDim>
inline cudaError_t launch_attention(const AttnArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) return launch_attention_f32<D>(a, stream);
  else return launch_attention_bf16<D>(a, stream);
}

// At a head width chosen at run time: 64 or 128 (kernel 2; kernel 1's
// seven-launch routes).
template <typename T>
inline cudaError_t launch_attention_d(const AttnArgs& a, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_attention<T, 64>(a, stream);
    case 128: return launch_attention<T, 128>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace zt
