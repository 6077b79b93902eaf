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
// (>= 0.43 ms at 3.35 TB/s), against 0.3 GFLOP of products.
//
// bf16 design (attention_mma_kernel): a CTA works on one surface-form row
// at a time, one warp per head. Past 16 heads (up to kMaxHeads = 32, one
// m16 query tile) attention_mma2_kernel runs the same code with 16 warps,
// warp w taking heads w and w + 16, so the 512-thread launch bound, and
// with it the 128 registers a thread, holds. It stages the row's q, k and v positions
// (all heads) in shared memory with 16-byte cp.async loads, one padded row
// per position (conflict-free ldmatrix); CTAs are persistent, and while one
// row is computed the next one's loads are in flight in a second buffer
// (where two fit in shared memory), so the loads never wait on the
// products. Each warp computes its head's S = Q K^T and
// O = P V with mma.sync m16n8k16 (bf16 in, f32 accumulate): queries padded
// to m16 tiles, keys to n8 tiles, the depth of D in D/16 k16 steps, and PV
// produces its D output columns 32 at a time (so the accumulators a lane
// holds do not grow with D: at D = 128 a row's 16 heads stage 86 KB, two
// buffers 172 KB, one CTA an SM; 32 heads of 128 stage up to 197 KB at L 8,
// so one buffer, and the next row's loads wait for this row). The
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
// registers, one Philox word per entry, and multiplies them with the merged
// V rows on the tensor cores. f32 keeps the scalar path (attention_kernel:
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
__global__ void __launch_bounds__(kAttnWarps * 32) attention_kernel(AttnArgs a) {
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
#pragma unroll
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
#pragma unroll
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

  const int lr = lane & 7, mat = lane >> 3, g = lane >> 2, q4 = lane & 3;
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
    // weights over all Lk*h merged keys, built as A fragments in registers
    // (entry (i, kk) kept by its own Philox word), times the merged V rows;
    // 64 output columns at a time (at D = 128 the fragments are drawn twice)
    const int Lkh = Lk * h;
    const float wd = Num<bf16>::round(w_uniform / a.keep_div);
    for (int c64 = 0; c64 < D; c64 += 64) {
      float acc[MQ][8][4];
#pragma unroll
      for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.0f;
      for (int ks = 0; ks < (Lkh + 15) / 16; ++ks) {
        uint32_t af[MQ][4];
#pragma unroll
        for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int kh = 0; kh < 2; ++kh) {
              const int i = 16 * mt + g + 8 * r, kk = 16 * ks + 8 * kh + 2 * q4;
              float e[2];
#pragma unroll
              for (int t = 0; t < 2; ++t)
                e[t] = (i < Lq && kk + t < Lkh &&
                        dropout_keep(a.seed, a.keep_threshold, a.row_offset + b, i * h + hd,
                                     kk + t))
                           ? wd
                           : 0.0f;
              af[mt][r + 2 * kh] = pack_bf16(e[0], e[1]);
            }
        const int kk = 16 * ks + lr + 8 * (mat & 1);
        const bf16* vrow = kk < Lkh ? sv + (kk / h) * RS + (kk % h) * D + c64 : zero;
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {  // 16 of the 64 output columns at a time
          uint32_t bf[4];
          ldsm_x4_t(bf, saddr(vrow + 16 * pp + 8 * (mat >> 1)));
#pragma unroll
          for (int mt = 0; mt < MQ; ++mt) {
            mma16816(acc[mt][2 * pp], af[mt], bf[0], bf[1]);
            mma16816(acc[mt][2 * pp + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 16 * mt + g + 8 * r;
          if (i < Lq)
#pragma unroll
            for (int n = 0; n < 8; ++n)
              *reinterpret_cast<uint32_t*>(hq + i * RS + c64 + 8 * n + 2 * q4) =
                  pack_bf16(acc[mt][n][2 * r], acc[mt][n][2 * r + 1]);
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
// Two CTAs an SM (64 registers a thread) only where two fit: D = 64 and
// short keys.
template <int MQ, int NK8, int D>
__global__ void __launch_bounds__(kAttnCtaWarps * 32, (D == 64 && MQ == 1 && NK8 <= 2) ? 2 : 1)
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
  if constexpr (MQ == 1)
    return launch_rows<D>(attention_mma2_kernel<NK8, D>, a, kAttnCtaWarps * 32, stream);
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
