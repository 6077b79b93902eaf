// Kernel 3: the merged-head attention core backward, with the forward's
// seeded dropout mask regenerated.
//
// Replaces the TPU kernel zett_tpu/ops/pallas_attention.py
// _core_train_bwd_kernel / _core_train_bwd_pallas (:254, :369), the backward
// of merged_attention_train. Operands are kernel 2's: qm (B, Lq*h, d),
// km/vm (B, Lk*h, d) position-major merged, kmaskf (B, Lk*h) f32, plus
// dout (B, Lq*h, d); it writes dqm, dkm, dvm of the operands' shapes. The
// head width d is a template parameter, D = 64 or 128.
//
// Per (row, head) pair it recomputes the forward's weights exactly as the
// forward does (attention.cuh), regenerates the keep mask from the same
// Philox counters, and computes per query i, key j:
//   wd   = keep ? w * (1/(1-rate) in T) : 0            (rounded to T)
//   dv_j = sum_i wd_ij dout_i
//   dw   = keep ? (dout_i . v_j) * f32(1/(1-rate)) : 0 (f32)
//   ds   = valid_j ? w_ij (dw_ij - sum_j' dw_ij' w_ij') / sqrt(d) : 0
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i
// with f32 accumulation and one cast to T per output, as the TPU kernel.
// The score plane never leaves the SM.
//
// ds is zero on masked entries: the gradient of the forward's select. The
// TPU kernel omits that select, which changes nothing where a row has a
// valid key (the weights of masked entries are exactly 0 there) but gives
// all-padding rows nonzero dq/dk; this kernel follows the differentiated
// reference (jax.vjp of _core_train_fallback), whose dq/dk there are 0. An
// all-padding row's weights are uniform over all Lk*h merged entries (every
// head), so its dv sums the dout of every query head.
//
// What bounds it on an H100: at the training shapes (B = 32896, Lq*h = Lk*h
// = 84, bf16) it reads q, k, v, dout and writes dq, dk, dv, ~2.5 GB against
// ~0.1 TFLOP: memory-bound, >= 0.74 ms at 3.35 TB/s.
//
// bf16 design: the five products run on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate; wgmma's 64-row tiles would waste 57 of
// 64 rows at Lq = 7). One warp owns one pair; a block holds up to 16 warps,
// two blocks an SM (32 warps resident). The warp stages its q, dout, k and v
// rows in shared memory as bf16 with 16-byte cp.async loads, in 144-byte
// rows (conflict-free ldmatrix); rows past Lq or Lk are never stored: their
// ldmatrix addresses point at one zero row. S = Q K^T and dP = dO V^T run
// over d = D with Lq padded to 16 and Lk to 8; the softmax, the select to
// lowest, the Philox mask and the roundings act on the accumulator
// fragments, each lane knowing its (i, j). (At D = 128 the two depth loops
// take eight k16 steps and each output product runs four passes of 32
// columns, so a lane holds no more accumulators than at 64; a warp's
// staged rows take 272 bytes, so ten warps a block.) ds and wd, rounded to T (so the
// products see the values the scalar form multiplies), go to a small tile in
// shared memory, from which ldmatrix (.trans for the transposed operand)
// feeds dQ = dS K, dK = dS^T Q and dV = Wd^T dO; each output goes through a
// staging tile to coalesced 16-byte stores. Padded rows and keys are zero,
// so they add nothing. f32 keeps the scalar path (one warp a pair, f32
// operands in shared memory, fmaf loops), the full-precision reference.
#include "attention.cuh"

#include <math.h>
#include <stdint.h>

namespace zt {

struct AttnBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* mask;
  int B, Lq, Lk, h;
  int dropout;
  unsigned int seed, keep_threshold;
  float keep_scale;    // 1/(1-rate) rounded to T
  float keep_scale32;  // 1/(1-rate) in f32
  unsigned int row_offset;  // the launch's first row within the whole batch
};

// All-padding row (no valid key of head hd in row b): uniform weights over
// all Lk*h merged entries; the select gives dq = dk = 0, and dv_(j,hd) sums
// every query head's dout.
template <typename T, int D>
__device__ void all_padding_bwd(const AttnBwdArgs& a, int b, int hd, int lane) {
  const int Lq = a.Lq, Lk = a.Lk, h = a.h;
  const long long sl = (long long)h * D;
  const long long q_sb = Lq * sl, k_sb = Lk * sl;
  T* dqb = (T*)a.dq + b * q_sb + hd * D;
  T* dkb = (T*)a.dk + b * k_sb + hd * D;
  T* dvb = (T*)a.dv + b * k_sb + hd * D;
  const float w = Num<T>::round(1.0f / (float)(Lk * h));
  const float wd = a.dropout ? Num<T>::round(w * a.keep_scale) : w;
  const T* grow = (const T*)a.dout + b * q_sb;
  for (int c = 0; c < D / 32; ++c) {
    const int dim = lane + 32 * c;
    for (int j = 0; j < Lk; ++j) {
      float acc = 0.0f;
      for (int i = 0; i < Lq; ++i)
        for (int hh = 0; hh < h; ++hh)
          if (!a.dropout ||
              dropout_keep(a.seed, a.keep_threshold, a.row_offset + b, i * h + hh,
                           j * h + hd))
            acc += wd * Num<T>::to_f(grow[i * sl + hh * D + dim]);
      dvb[j * sl + dim] = Num<T>::from_f(acc);
      dkb[j * sl + dim] = Num<T>::from_f(0.0f);
    }
    for (int i = 0; i < Lq; ++i) dqb[i * sl + dim] = Num<T>::from_f(0.0f);
  }
}

// ------------------------------------------------------- f32: scalar path
__host__ __device__ inline int bwd_smem_floats_per_warp(int Lq, int Lk, int D) {
  return (2 * Lq + 2 * Lk) * row_pad(D) + 3 * Lq * (Lk + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kAttnWarps * 32) attention_bwd_kernel(AttnBwdArgs a) {
  constexpr int kRowPad = row_pad(D), kC = D / 32;  // kC: a lane's columns
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long pair = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (pair >= (long long)a.B * a.h) return;  // whole warp leaves together
  const int b = (int)(pair / a.h);
  const int hd = (int)(pair % a.h);
  const int Lq = a.Lq, Lk = a.Lk, h = a.h;
  const long long sl = (long long)h * D;  // one position's row
  const long long q_sb = Lq * sl, k_sb = Lk * sl;
  const long long off_q = b * q_sb + hd * D;
  const long long off_k = b * k_sb + hd * D;

  const T* qb = (const T*)a.q + off_q;
  const T* kb = (const T*)a.k + off_k;
  const T* vb = (const T*)a.v + off_k;
  const T* gb = (const T*)a.dout + off_q;
  T* dqb = (T*)a.dq + off_q;
  T* dkb = (T*)a.dk + off_k;
  T* dvb = (T*)a.dv + off_k;

  const bool key_ok = lane < Lk && a.mask[(long long)b * Lk * h + lane * h + hd] > 0.0f;
  const unsigned valid = __ballot_sync(0xffffffffu, key_ok);

  if (valid == 0u) {
    all_padding_bwd<T, D>(a, b, hd, lane);
    return;
  }

  float* sq = smem + (size_t)warp * bwd_smem_floats_per_warp(Lq, Lk, D);
  float* sk = sq + Lq * kRowPad;
  float* sv = sk + Lk * kRowPad;
  float* sg = sv + Lk * kRowPad;
  float* sw = sg + Lq * kRowPad;  // weights w, [Lq][Lk + 1]
  float* swd = sw + Lq * (Lk + 1);  // dropped weights wd
  float* sds = swd + Lq * (Lk + 1);  // dw, then ds
  for (int i = 0; i < Lq; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      sq[i * kRowPad + lane + 32 * c] = Num<T>::to_f(qb[i * sl + lane + 32 * c]);
      sg[i * kRowPad + lane + 32 * c] = Num<T>::to_f(gb[i * sl + lane + 32 * c]);
    }
  for (int j = 0; j < Lk; ++j)
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      sk[j * kRowPad + lane + 32 * c] = Num<T>::to_f(kb[j * sl + lane + 32 * c]);
      sv[j * kRowPad + lane + 32 * c] = Num<T>::to_f(vb[j * sl + lane + 32 * c]);
    }
  __syncwarp();

  // the forward's weights, recomputed in the same order
  const float sqrt_d = sqrtf((float)D);
  const float lowest = Num<T>::lowest();
  for (int idx = lane; idx < Lq * Lk; idx += 32) {
    const int i = idx / Lk;
    const int j = idx % Lk;
    float acc = 0.0f;
#pragma unroll 16
    for (int t = 0; t < D; ++t) acc = fmaf(sq[i * kRowPad + t], sk[j * kRowPad + t], acc);
    const float s = Num<T>::round(Num<T>::round(acc) / sqrt_d);
    sw[i * (Lk + 1) + j] = ((valid >> j) & 1u) ? s : lowest;
  }
  __syncwarp();
  if (lane < Lq) {
    float* row = sw + lane * (Lk + 1);
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

  for (int idx = lane; idx < Lq * Lk; idx += 32) {
    const int i = idx / Lk;
    const int j = idx % Lk;
    float dwd = 0.0f;
#pragma unroll 16
    for (int t = 0; t < D; ++t) dwd = fmaf(sg[i * kRowPad + t], sv[j * kRowPad + t], dwd);
    const float w = sw[i * (Lk + 1) + j];
    float wd = w, dw = dwd;
    if (a.dropout) {
      const bool kept =
          dropout_keep(a.seed, a.keep_threshold, a.row_offset + b, i * h + hd, j * h + hd);
      wd = kept ? Num<T>::round(w * a.keep_scale) : 0.0f;
      dw = kept ? dwd * a.keep_scale32 : 0.0f;
    }
    swd[i * (Lk + 1) + j] = wd;
    sds[i * (Lk + 1) + j] = dw;
  }
  __syncwarp();
  if (lane < Lq) {
    const float* wrow = sw + lane * (Lk + 1);
    float* drow = sds + lane * (Lk + 1);
    float dot = 0.0f;
    for (int j = 0; j < Lk; ++j) dot += drow[j] * wrow[j];
    const float inv_sqrt_d = 1.0f / sqrt_d;
    for (int j = 0; j < Lk; ++j)
      drow[j] = ((valid >> j) & 1u) ? Num<T>::round(wrow[j] * (drow[j] - dot) * inv_sqrt_d)
                                    : 0.0f;
  }
  __syncwarp();

  for (int i = 0; i < Lq; ++i) {
    const float* drow = sds + i * (Lk + 1);
    float acc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = 0.0f;
    for (int j = 0; j < Lk; ++j)
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = fmaf(drow[j], sk[j * kRowPad + lane + 32 * c], acc[c]);
#pragma unroll
    for (int c = 0; c < kC; ++c) dqb[i * sl + lane + 32 * c] = Num<T>::from_f(acc[c]);
  }
  for (int j = 0; j < Lk; ++j) {
    float kacc[kC], vacc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) kacc[c] = vacc[c] = 0.0f;
    for (int i = 0; i < Lq; ++i) {
      const float ds = sds[i * (Lk + 1) + j];
      const float wd = swd[i * (Lk + 1) + j];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        kacc[c] = fmaf(ds, sq[i * kRowPad + lane + 32 * c], kacc[c]);
        vacc[c] = fmaf(wd, sg[i * kRowPad + lane + 32 * c], vacc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      dkb[j * sl + lane + 32 * c] = Num<T>::from_f(kacc[c]);
      dvb[j * sl + lane + 32 * c] = Num<T>::from_f(vacc[c]);
    }
  }
}

// ------------------------------------------------- bf16: tensor-core path
constexpr int kBwdWarps = 16;               // warps of a block, at most
constexpr int kBwdBlockSmem = 232448 / 2;   // two blocks an SM
// staged rows of D + 8 bf16 (144 bytes at D = 64, 272 at 128)
__host__ __device__ constexpr int srow(int D) { return D + 8; }
// bytes of the shared zero row
__host__ __device__ constexpr int zero_row_bytes(int D) { return srow(D) * 2; }

// Bytes of one warp's tiles: q, dout (Lq rows), k, v (Lk rows), the output
// staging tile, and the ds and wd tiles (16*MQ rows of 16*ceil(NK8/2) + 8).
__host__ __device__ inline int bwd_mma_bytes_per_warp(int Lq, int Lk, int MQ, int NK8, int D) {
  const int ps = 16 * ((NK8 + 1) / 2) + 8;
  return 2 * ((2 * Lq + 2 * Lk + (Lq > Lk ? Lq : Lk)) * srow(D) + 2 * 16 * MQ * ps);
}

// Rows [0, out_rows) of one head of dst from out = A X over MT m16 tiles and
// KS k16 steps. A is a weight tile p (row stride ps), read as stored
// ([m][k]) or, with A_T, transposed (stored [k][m]); X is a staged operand
// (rows k, D wide), rows past x_rows read as zeros. Staged through so.
template <int MT, int KS, bool A_T, int D>
__device__ __forceinline__ void grad_product(const bf16* p, int ps, const bf16* x, int x_rows,
                                             const bf16* zero, bf16* so, int out_rows,
                                             bf16* dst, long long sl, int lane) {
  constexpr int kSRow = srow(D);
  const int lr = lane & 7, mat = lane >> 3, g = lane >> 2, q4 = lane & 3;
  uint32_t af[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (A_T)
        ldsm_x4_t(af[mt][ks],
                  saddr(p + (16 * ks + lr + 8 * (mat >> 1)) * ps + 16 * mt + 8 * (mat & 1)));
      else
        ldsm_x4(af[mt][ks],
                saddr(p + (16 * mt + lr + 8 * (mat & 1)) * ps + 16 * ks + 8 * (mat >> 1)));
    }
#pragma unroll
  for (int half = 0; half < D / 32; ++half) {  // 32 of the D output columns at a time
    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        const int k = 16 * ks + lr + 8 * (mat & 1);
        const int col = 32 * half + 16 * pp + 8 * (mat >> 1);
        uint32_t bf[4];
        ldsm_x4_t(bf, saddr(k < x_rows ? x + k * kSRow + col : zero + col));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][2 * pp], af[mt][ks], bf[0], bf[1]);
          mma16816(acc[mt][2 * pp + 1], af[mt][ks], bf[2], bf[3]);
        }
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 16 * mt + g + 8 * hh;
        if (m < out_rows)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            *reinterpret_cast<uint32_t*>(so + m * kSRow + 32 * half + 8 * n + 2 * q4) =
                pack_bf16(acc[mt][n][2 * hh], acc[mt][n][2 * hh + 1]);
      }
  }
  __syncwarp();
  for (int c = lane; c < out_rows * (D / 8); c += 32) {
    const int r = c / (D / 8), ch = (c % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * sl + ch) =
        *reinterpret_cast<const uint4*>(so + r * kSRow + ch);
  }
  __syncwarp();
}

// MQ: m16 tiles over the queries (Lq <= 16 * MQ); NK8: n8 tiles over the
// keys (Lk <= 8 * NK8).
template <int MQ, int NK8, int D>
__global__ void __launch_bounds__(kBwdWarps * 32, (MQ == 1 && NK8 <= 2) ? 2 : 1)
attention_bwd_mma_kernel(AttnBwdArgs a) {
  constexpr int MK = (NK8 + 1) / 2;  // m16 tiles / k16 steps over the keys
  constexpr int PS = 16 * MK + 8;    // row stride of the ds and wd tiles
  constexpr int kSRow = srow(D), kZeroRow = zero_row_bytes(D);
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  bf16* zero = reinterpret_cast<bf16*>(bwd_smem);  // every padded row reads here
  for (int t = threadIdx.x; t < kSRow; t += blockDim.x) zero[t] = __float2bfloat16_rn(0.0f);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Lq = a.Lq, Lk = a.Lk, h = a.h;
  const long long pair = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (pair >= (long long)a.B * h) return;  // whole warp leaves together
  const int b = (int)(pair / h), hd = (int)(pair % h);

  const bool key_ok = lane < Lk && a.mask[(long long)b * Lk * h + lane * h + hd] > 0.0f;
  const unsigned valid = __ballot_sync(0xffffffffu, key_ok);
  if (valid == 0u) {
    all_padding_bwd<bf16, D>(a, b, hd, lane);
    return;
  }

  const long long sl = (long long)h * D;  // one position's row
  const long long off_q = (long long)b * Lq * sl + hd * D;
  const long long off_k = (long long)b * Lk * sl + hd * D;
  const int rows_out = Lq > Lk ? Lq : Lk;
  bf16* sq = reinterpret_cast<bf16*>(bwd_smem + kZeroRow +
                                     (size_t)warp * bwd_mma_bytes_per_warp(Lq, Lk, MQ, NK8, D));
  bf16* sg = sq + Lq * kSRow;
  bf16* sk = sg + Lq * kSRow;
  bf16* sv = sk + Lk * kSRow;
  bf16* so = sv + Lk * kSRow;
  bf16* sds = so + rows_out * kSRow;
  bf16* swd = sds + 16 * MQ * PS;

  {
    const bf16* qb = (const bf16*)a.q + off_q;
    const bf16* gb = (const bf16*)a.dout + off_q;
    const bf16* kb = (const bf16*)a.k + off_k;
    const bf16* vb = (const bf16*)a.v + off_k;
    constexpr int kCh = D / 8;  // 16-byte chunks of a staged row
    for (int c = lane; c < Lq * kCh; c += 32) {
      const int r = c / kCh, ch = (c % kCh) * 8;
      cp_async16(sq + r * kSRow + ch, qb + r * sl + ch);
      cp_async16(sg + r * kSRow + ch, gb + r * sl + ch);
    }
    for (int c = lane; c < Lk * kCh; c += 32) {
      const int r = c / kCh, ch = (c % kCh) * 8;
      cp_async16(sk + r * kSRow + ch, kb + r * sl + ch);
      cp_async16(sv + r * kSRow + ch, vb + r * sl + ch);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
  }

  const int lr = lane & 7, mat = lane >> 3, g = lane >> 2, q4 = lane & 3;
  // S = Q K^T and dP = dO V^T over d = D
  float sacc[MQ][NK8][4], pacc[MQ][NK8][4];
#pragma unroll
  for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
    for (int nt = 0; nt < NK8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[mt][nt][e] = pacc[mt][nt][e] = 0.0f;
#pragma unroll
  for (int hk = 0; hk < D / 32; ++hk) {  // d in [32 hk, 32 hk + 32): two k16 steps
    uint32_t bk[NK8][4], bv[NK8][4];
#pragma unroll
    for (int nt = 0; nt < NK8; ++nt) {
      const int j = 8 * nt + lr, col = 32 * hk + 8 * mat;
      ldsm_x4(bk[nt], saddr(j < Lk ? sk + j * kSRow + col : zero + col));
      ldsm_x4(bv[nt], saddr(j < Lk ? sv + j * kSRow + col : zero + col));
    }
#pragma unroll
    for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int i = 16 * mt + lr + 8 * (mat & 1), col = 32 * hk + 16 * kk + 8 * (mat >> 1);
        uint32_t aq[4], ag[4];
        ldsm_x4(aq, saddr(i < Lq ? sq + i * kSRow + col : zero + col));
        ldsm_x4(ag, saddr(i < Lq ? sg + i * kSRow + col : zero + col));
#pragma unroll
        for (int nt = 0; nt < NK8; ++nt) {
          mma16816(sacc[mt][nt], aq, bk[nt][2 * kk], bk[nt][2 * kk + 1]);
          mma16816(pacc[mt][nt], ag, bv[nt][2 * kk], bv[nt][2 * kk + 1]);
        }
      }
  }

  // the forward's weights and the gradient of the scores, on the fragments:
  // accumulator e of tile (mt, nt) is query 16 mt + g + 8 (e / 2), key
  // 8 nt + 2 q4 + (e % 2); a query's keys lie in the lane's quad
  const float sqrt_d = sqrtf((float)D);
  const float inv_sqrt_d = 1.0f / sqrt_d;
  const float lowest = Num<bf16>::lowest();
#pragma unroll
  for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = 16 * mt + g + 8 * hh;
      float w[NK8][2], dw[NK8][2], wd[NK8][2];
      float m = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NK8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * q4 + e;
          const float s = Num<bf16>::round(Num<bf16>::round(sacc[mt][nt][2 * hh + e]) / sqrt_d);
          w[nt][e] = j < Lk ? (((valid >> j) & 1u) ? s : lowest) : -INFINITY;
          m = fmaxf(m, w[nt][e]);
        }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NK8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * q4 + e;
          w[nt][e] = j < Lk ? expf(w[nt][e] - m) : 0.0f;
          sum += w[nt][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      float dot = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NK8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * q4 + e;
          const float wij = j < Lk ? Num<bf16>::round(w[nt][e] / sum) : 0.0f;
          float wdij = wij, dwij = pacc[mt][nt][2 * hh + e];
          if (a.dropout && i < Lq && j < Lk) {
            const bool kept =
          dropout_keep(a.seed, a.keep_threshold, a.row_offset + b, i * h + hd, j * h + hd);
            wdij = kept ? Num<bf16>::round(wij * a.keep_scale) : 0.0f;
            dwij = kept ? dwij * a.keep_scale32 : 0.0f;
          }
          w[nt][e] = wij;
          wd[nt][e] = wdij;
          dw[nt][e] = dwij;
          dot += dwij * wij;
        }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
#pragma unroll
      for (int nt = 0; nt < NK8; ++nt) {
        float ds[2], wdo[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * q4 + e;
          const bool live = i < Lq && ((valid >> j) & 1u);
          ds[e] = live ? Num<bf16>::round(w[nt][e] * (dw[nt][e] - dot) * inv_sqrt_d) : 0.0f;
          wdo[e] = i < Lq ? wd[nt][e] : 0.0f;
        }
        const int col = 8 * nt + 2 * q4;
        *reinterpret_cast<uint32_t*>(sds + i * PS + col) = pack_bf16(ds[0], ds[1]);
        *reinterpret_cast<uint32_t*>(swd + i * PS + col) = pack_bf16(wdo[0], wdo[1]);
      }
      if (NK8 & 1) {  // the k16 step's upper 8 keys do not exist
        const int col = 8 * NK8 + 2 * q4;
        *reinterpret_cast<uint32_t*>(sds + i * PS + col) = 0u;
        *reinterpret_cast<uint32_t*>(swd + i * PS + col) = 0u;
      }
    }
  __syncwarp();

  grad_product<MQ, MK, false, D>(sds, PS, sk, Lk, zero, so, Lq, (bf16*)a.dq + off_q, sl, lane);
  grad_product<MK, MQ, true, D>(sds, PS, sq, Lq, zero, so, Lk, (bf16*)a.dk + off_k, sl, lane);
  grad_product<MK, MQ, true, D>(swd, PS, sg, Lq, zero, so, Lk, (bf16*)a.dv + off_k, sl, lane);
}

template <int MQ, int NK8, int D>
cudaError_t launch_bwd_mma(const AttnBwdArgs& a, cudaStream_t stream) {
  const int per_warp = bwd_mma_bytes_per_warp(a.Lq, a.Lk, MQ, NK8, D);
  int warps = (kBwdBlockSmem - zero_row_bytes(D)) / per_warp;
  warps = warps < 1 ? 1 : (warps > kBwdWarps ? kBwdWarps : warps);
  const size_t smem = zero_row_bytes(D) + (size_t)warps * per_warp;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_mma_kernel<MQ, NK8, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long pairs = (long long)a.B * a.h;
  const unsigned grid = (unsigned)((pairs + warps - 1) / warps);
  attention_bwd_mma_kernel<MQ, NK8, D><<<grid, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
inline cudaError_t launch_attention_bwd_bf16(const AttnBwdArgs& a, cudaStream_t s) {
  const int mq = (a.Lq + 15) / 16, nk = (a.Lk + 7) / 8;
  if (mq == 1) {
    switch (nk) {
      case 1: return launch_bwd_mma<1, 1, D>(a, s);
      case 2: return launch_bwd_mma<1, 2, D>(a, s);
      case 3: return launch_bwd_mma<1, 3, D>(a, s);
      case 4: return launch_bwd_mma<1, 4, D>(a, s);
    }
  } else if (mq == 2) {
    switch (nk) {
      case 1: return launch_bwd_mma<2, 1, D>(a, s);
      case 2: return launch_bwd_mma<2, 2, D>(a, s);
      case 3: return launch_bwd_mma<2, 3, D>(a, s);
      case 4: return launch_bwd_mma<2, 4, D>(a, s);
    }
  }
  return cudaErrorInvalidValue;  // Lq, Lk outside 1..32
}

template <int D>
inline cudaError_t launch_attention_bwd_f32(const AttnBwdArgs& a, cudaStream_t stream) {
  const size_t per_warp = sizeof(float) * (size_t)bwd_smem_floats_per_warp(a.Lq, a.Lk, D);
  const int warps = f32_warps(per_warp);
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t smem = warps * per_warp;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long pairs = (long long)a.B * a.h;
  const unsigned grid = (unsigned)((pairs + warps - 1) / warps);
  attention_bwd_kernel<float, D><<<grid, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
inline cudaError_t launch_attention_bwd(int dtype, const AttnBwdArgs& a, cudaStream_t s) {
  return dtype == 1 ? launch_attention_bwd_bf16<D>(a, s) : launch_attention_bwd_f32<D>(a, s);
}

}  // namespace zt

// dtype: 0 = float32, 1 = bfloat16; d: head width, 64 or 128. bf16 operands
// 16-byte aligned. row_offset: the launch's first row within the whole
// batch, as the forward took it. Returns a cudaError_t (0 = success).
extern "C" int zt_attention_core_bwd(int dtype, const void* qm, const void* km, const void* vm,
                                     const float* kmaskf, const void* dout, void* dqm,
                                     void* dkm, void* dvm, int B, int Lq, int Lk, int h, int d,
                                     int dropout, unsigned int seed, unsigned int keep_threshold,
                                     float keep_scale, float keep_scale32, unsigned int row_offset,
                                     void* stream) {
  zt::AttnBwdArgs a;
  a.q = qm;
  a.k = km;
  a.v = vm;
  a.dout = dout;
  a.dq = dqm;
  a.dk = dkm;
  a.dv = dvm;
  a.mask = kmaskf;
  a.B = B;
  a.Lq = Lq;
  a.Lk = Lk;
  a.h = h;
  a.dropout = dropout;
  a.seed = seed;
  a.keep_threshold = keep_threshold;
  a.keep_scale = keep_scale;
  a.keep_scale32 = keep_scale32;
  a.row_offset = row_offset;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64: return (int)zt::launch_attention_bwd<64>(dtype, a, s);
    case 128: return (int)zt::launch_attention_bwd<128>(dtype, a, s);
  }
  return (int)cudaErrorInvalidValue;
}
