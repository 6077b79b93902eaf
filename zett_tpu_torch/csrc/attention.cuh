// Masked per-head softmax attention over very short rows (the hypernet's
// surface forms: at most 32 query and 32 key positions, head width 64).
//
// Shared by encoder_layer.cu (kernel 1, the attention inside a whole encoder
// layer), attention_core.cu (kernel 2, the tier-4 core), attention_block.cu
// (kernel 4, the attention inside the tier-2 block) and merged_attention.cu
// (kernel 5, the tier-1 core). One warp owns one (row, head) pair: it stages that head's q, k and
// v rows in shared memory as f32, computes every query-key score, runs the
// softmax per query and writes the context. Nothing of a row leaves the SM
// between the score and the context: the score plane never touches device
// memory, as in the TPU kernels this replaces.
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
// (row b, merged query index, merged key index, 0). Each entry of the merged
// (B, Lq*h, Lk*h) weight plane thus has its own bits, independent of how the
// batch is tiled, and the backward (kernel 3) regenerates the same mask. An
// entry is kept when its first output word is below keep_threshold =
// round((1 - rate) * 2^32); kept weights are divided by 1 - rate in T.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace zt {

constexpr int kHeadDim = 64;
constexpr int kAttnWarps = 4;
constexpr int kRowPad = kHeadDim + 1;  // 65: conflict-free column reads

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

// Strides are in elements of T. A head's 64 values sit at offset head*64 of
// a position's row, in both layouts this code serves: (B, L, h*64) and the
// position-major merged (B, L*h, 64).
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
__device__ __forceinline__ bool dropout_keep(unsigned int seed, unsigned int threshold, int b,
                                             int qi, int kj) {
  return philox_word0((unsigned int)b, (unsigned int)qi, (unsigned int)kj, 0u, seed, 0u) <
         threshold;
}

__host__ __device__ inline int attn_smem_floats_per_warp(int Lq, int Lk) {
  return (Lq + 2 * Lk) * kRowPad + Lq * (Lk + 1);
}

template <typename T>
__global__ void __launch_bounds__(kAttnWarps * 32) attention_kernel(AttnArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long pair = (long long)blockIdx.x * kAttnWarps + warp;
  if (pair >= (long long)a.B * a.h) return;  // whole warp leaves together
  const int b = (int)(pair / a.h);
  const int hd = (int)(pair % a.h);
  const int Lq = a.Lq, Lk = a.Lk;

  float* sq = smem + (size_t)warp * attn_smem_floats_per_warp(Lq, Lk);
  float* sk = sq + Lq * kRowPad;
  float* sv = sk + Lk * kRowPad;
  float* sp = sv + Lk * kRowPad;  // [Lq][Lk + 1]

  const T* qb = (const T*)a.q + b * a.q_sb + hd * kHeadDim;
  const T* kb = (const T*)a.k + b * a.k_sb + hd * kHeadDim;
  const T* vb = (const T*)a.v + b * a.v_sb + hd * kHeadDim;
  for (int i = 0; i < Lq; ++i) {
    sq[i * kRowPad + lane] = Num<T>::to_f(qb[i * a.q_sl + lane]);
    sq[i * kRowPad + lane + 32] = Num<T>::to_f(qb[i * a.q_sl + lane + 32]);
  }
  for (int j = 0; j < Lk; ++j) {
    sk[j * kRowPad + lane] = Num<T>::to_f(kb[j * a.k_sl + lane]);
    sk[j * kRowPad + lane + 32] = Num<T>::to_f(kb[j * a.k_sl + lane + 32]);
    sv[j * kRowPad + lane] = Num<T>::to_f(vb[j * a.v_sl + lane]);
    sv[j * kRowPad + lane + 32] = Num<T>::to_f(vb[j * a.v_sl + lane + 32]);
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
        for (int c = 0; c < 2; ++c) {
          const int dim = lane + 32 * c;
          float acc = 0.0f;
          for (int j = 0; j < Lk; ++j)
            for (int hh = 0; hh < a.h; ++hh)
              if (dropout_keep(a.seed, a.keep_threshold, b, i * a.h + hd, j * a.h + hh))
                acc += wd * Num<T>::to_f(vrow[j * a.v_sl + hh * kHeadDim + dim]);
          ((T*)a.out)[b * a.o_sb + i * a.o_sl + hd * kHeadDim + dim] = Num<T>::from_f(acc);
        }
      return;
    }
    for (int c = 0; c < 2; ++c) {
      const int dim = lane + 32 * c;
      float acc = 0.0f;
      for (int j = 0; j < Lk; ++j)
        for (int hh = 0; hh < a.h; ++hh)
          acc += w * Num<T>::to_f(vrow[j * a.v_sl + hh * kHeadDim + dim]);
      const T o = Num<T>::from_f(acc);
      for (int i = 0; i < Lq; ++i)
        ((T*)a.out)[b * a.o_sb + i * a.o_sl + hd * kHeadDim + dim] = o;
    }
    return;
  }

  const float sqrt_d = sqrtf((float)kHeadDim);
  const float lowest = Num<T>::lowest();
  const T* kbias = a.kbias ? (const T*)a.kbias + b * a.kb_sb + hd * a.kb_sh : nullptr;
  for (int idx = lane; idx < Lq * Lk; idx += 32) {
    const int i = idx / Lk;
    const int j = idx % Lk;
    float acc = 0.0f;
#pragma unroll 16
    for (int t = 0; t < kHeadDim; ++t) acc = fmaf(sq[i * kRowPad + t], sk[j * kRowPad + t], acc);
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
      *wij = dropout_keep(a.seed, a.keep_threshold, b, i * a.h + hd, j * a.h + hd)
                 ? Num<T>::round(*wij / a.keep_div)
                 : 0.0f;
    }
    __syncwarp();
  }
  for (int i = 0; i < Lq; ++i) {
    const float* row = sp + i * (Lk + 1);
    float acc0 = 0.0f, acc1 = 0.0f;
    for (int j = 0; j < Lk; ++j) {
      acc0 = fmaf(row[j], sv[j * kRowPad + lane], acc0);
      acc1 = fmaf(row[j], sv[j * kRowPad + lane + 32], acc1);
    }
    T* ob = (T*)a.out + b * a.o_sb + i * a.o_sl + hd * kHeadDim;
    ob[lane] = Num<T>::from_f(acc0);
    ob[lane + 32] = Num<T>::from_f(acc1);
  }
}

template <typename T>
cudaError_t launch_attention(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)kAttnWarps * attn_smem_floats_per_warp(a.Lq, a.Lk);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long pairs = (long long)a.B * a.h;
  const unsigned grid = (unsigned)((pairs + kAttnWarps - 1) / kAttnWarps);
  attention_kernel<T><<<grid, kAttnWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace zt
