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
// It computes what the plain version (ops/attention_core.py
// attention_core_bwd_reference) computes for any kmaskf the op accepts,
// whether the heads of a row share their key mask or not. Two kinds of
// query head:
// - A head with a valid key ("valid head"): its queries weight its own
//   valid keys. Per (row, head) pair the kernel recomputes the forward's
//   weights exactly as the forward does (attention.cuh), regenerates the
//   keep mask from the same Philox counters, and computes per query i, key j:
//     wd   = keep ? w * (1/(1-rate) in T) : 0            (rounded to T)
//     dv_j = sum_i wd_ij dout_i
//     dw   = keep ? (dout_i . v_j) * f32(1/(1-rate)) : 0 (f32)
//     ds   = valid_j ? w_ij (dw_ij - sum_j' dw_ij' w_ij') / sqrt(d) : 0
//     dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i
//   with f32 accumulation and one cast to T per output, as the TPU kernel.
//   The score plane never leaves the SM.
// - A head with no valid key ("padding head"): its merged rows are all the
//   lowest value, so its queries weight every merged key (j, hd), of every
//   head, alike: w = round(1/(Lk*h)), wd = round(w * keep_scale) where kept
//   at rate > 0. Their ds is zero, so they add nothing to dq or dk, and a
//   padding head's own dq and dk are zero. They add
//     pad_(j,hd) = sum over padding heads hh and queries i of
//                  keep_((i,hh),(j,hd)) * wd * dout_(i,hh)
//   to the dv of every merged key, a valid head's included (in f32, before
//   its one cast). At rate 0, pad is one D-vector at every key: w times the
//   sum of the padding heads' dout rows.
//
// ds is zero on masked entries: the gradient of the forward's select. The
// TPU kernel omits that select, which changes nothing where a head has a
// valid key (the weights of masked entries are exactly 0 there) but gives
// padding heads nonzero dq/dk; this kernel follows the differentiated
// reference (jax.vjp of _core_train_fallback), whose dq/dk there are 0
// (ROADMAP C.4).
//
// What bounds it on an H100: memory. At the training shapes (B = 32896,
// Lq*h = Lk*h = 84, bf16) it reads q, k, v, dout and writes dq, dk, dv,
// ~2.5 GB against ~0.1 TFLOP: >= 0.74 ms at 3.35 TB/s. A row whose heads
// are all padding needs only its dout read and its three outputs written
// (with a train batch's 58% of such rows: >= 0.56 ms at 12 heads of 64,
// 1.49 and 2.98 at 16 and 32 heads of 128); at rate > 0 its pad is a
// product of Lk*h x Lq*h x D, one Philox word an entry: 12.8 MFLOP and
// 50176 words a row at 32 heads of 128, L 7.
//
// bf16 design: two device kernels a call, on disjoint outputs.
// attention_bwd_mma_kernel runs the valid heads, and its five products run
// on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate; wgmma's
// 64-row tiles would waste 57 of 64 rows at Lq = 7). One warp owns one
// pair; at the training shapes a block holds up to 16 warps at D = 64 and
// 10 at D = 128, two blocks an SM (bwd_warps: no instantiation spills).
// The warp stages its q, dout, k and v rows in shared memory as bf16 with
// 16-byte cp.async loads, in rows of D + 8 (conflict-free ldmatrix); rows
// past Lq or Lk are never stored: their ldmatrix addresses point at one
// zero row. S = Q K^T and dP = dO V^T run over d = D with Lq padded to 16
// and Lk to 8; the softmax, the select to lowest, the Philox mask and the
// roundings act on the accumulator fragments, each lane knowing its
// (i, j). (At D = 128 the two depth loops take eight k16 steps and each
// output product runs four passes of 32 columns, so a lane holds no more
// accumulators than at 64.) ds and wd, rounded to T (so the products see
// the values the scalar form multiplies), go to a small tile in shared
// memory, from which ldmatrix (.trans for the transposed operand) feeds
// dQ = dS K, dK = dS^T Q and dV = Wd^T dO; each output goes through a
// staging tile to coalesced 16-byte stores. Padded rows and keys are zero,
// so they add nothing. A warp whose head has no valid key leaves at once.
// Whether another head of its row has none it reads from one byte a row
// that the padding heads' kernel, launched first, wrote. Where one has (a
// mixed row, which no caller of the port builds), the warp reads those
// heads' dout rows and sums its own keys' pad into an f32 tile in shared
// memory (lane j draws key j's Philox word: each word once), then computes
// dV = Wd^T dO plus that tile in f32, scalar, before the one cast.
//
// The padding heads are a row's work, not a pair's: persistent CTAs walk
// groups of rows, read a group's key masks at once (a thread a (row, head)
// pair), write a byte a row (some head of it has no valid key) for the
// valid heads' kernel, and take its rows with a padding head one at a
// time. At rate 0 (attention_bwd_padding_kernel) a CTA sums a row's
// padding-head dout rows once, with 16-byte loads, in f32, and writes pad
// to every key of those heads with zeros to their dq and dk, all 16-byte
// stores: a row whose heads are all padding costs its bytes. At rate > 0
// (attention_bwd_padding_dropout_kernel) pad is a product, dV_pad = A dO
// over the row's merged queries with A[(j,hd)][(i,hh)] = keep * wd on
// padding heads hd and hh: the CTA stages the row's dout rows in shared
// memory with cp.async (all Lq*h of them at the training shapes, 61 KB at
// 32 heads of 128, L 7; longer rows in chunks), each warp takes an m16
// tile of merged keys, draws each entry's Philox word once, one lane an
// entry, packs the kept wd into mma.sync A fragments and multiplies them
// with ldmatrix.trans of the staged rows, all D columns in its
// accumulators (the transpose of kernel 2's branch for such heads,
// attention.cuh attention_row). f32 keeps the scalar path
// (attention_bwd_kernel: one warp a pair, f32 operands in shared memory,
// fmaf loops), the full-precision reference; its padding heads and mixed
// rows take the same warp-level pad as the bf16 valid heads' mixed rows.
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
  uint8_t* row_pad;  // bf16: a byte a row, some head of it has no valid key
};

// Whether head hh of row b has a valid key.
__device__ __forceinline__ bool head_has_key(const AttnBwdArgs& a, int b, int hh) {
  const float* m = a.mask + (long long)b * a.Lk * a.h + hh;
  bool any = false;
  for (int j = 0; j < a.Lk; ++j) any |= m[j * a.h] > 0.0f;
  return any;
}

// Bits of row b's heads base..base+31 (lane t: head base + t) that have no
// valid key.
__device__ __forceinline__ unsigned padding_heads(const AttnBwdArgs& a, int b, int base,
                                                  int lane) {
  const int hh = base + lane;
  return __ballot_sync(0xffffffffu, hh < a.h && !head_has_key(a, b, hh));
}

// Whether some head of row b has no valid key (the f32 path; the bf16 one
// reads row_pad).
__device__ __forceinline__ bool row_has_padding(const AttnBwdArgs& a, int b, int lane) {
  for (int base = 0; base < a.h; base += 32)
    if (padding_heads(a, b, base, lane) != 0u) return true;
  return false;
}

// pad at head hd's Lk keys of row b (header note), by one warp, into pc
// (f32): [Lk][D] at rate > 0, one [D] row at rate 0 (the same at every
// key). Lane t holds columns t + 32 c; at rate > 0 lane j draws key j's
// Philox word, so each word is drawn once.
template <typename T, int D>
__device__ __forceinline__ void padding_share(const AttnBwdArgs& a, int b, int hd, float* pc,
                                              int lane) {
  constexpr int kC = D / 32;
  const int Lq = a.Lq, Lk = a.Lk, h = a.h;
  const long long sl = (long long)h * D;
  const T* grow = (const T*)a.dout + (long long)b * Lq * sl + lane;
  const float w = Num<T>::round(1.0f / (float)(Lk * h));
  const float wd = a.dropout ? Num<T>::round(w * a.keep_scale) : w;
  float acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = 0.0f;
  if (a.dropout)
    for (int j = 0; j < Lk; ++j)
#pragma unroll
      for (int c = 0; c < kC; ++c) pc[j * D + lane + 32 * c] = 0.0f;
  for (int base = 0; base < h; base += 32)
    for (unsigned pad = padding_heads(a, b, base, lane); pad != 0u; pad &= pad - 1u) {
      const int hh = base + __ffs(pad) - 1;
      for (int i = 0; i < Lq; ++i) {
        const T* g = grow + i * sl + hh * D;
        float x[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) x[c] = Num<T>::to_f(g[32 * c]);
        if (!a.dropout) {
#pragma unroll
          for (int c = 0; c < kC; ++c) acc[c] += x[c];
          continue;
        }
        const unsigned kept = __ballot_sync(
            0xffffffffu, lane < Lk && dropout_keep(a.seed, a.keep_threshold, a.row_offset + b,
                                                   i * h + hh, lane * h + hd));
        for (unsigned k = kept; k != 0u; k &= k - 1u) {
          float* row = pc + (__ffs(k) - 1) * D + lane;
#pragma unroll
          for (int c = 0; c < kC; ++c) row[32 * c] += wd * x[c];
        }
      }
    }
  if (!a.dropout)
#pragma unroll
    for (int c = 0; c < kC; ++c) pc[lane + 32 * c] = w * acc[c];
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
  // pad's row stride: one row at rate 0 serves every key
  const int pr = a.dropout ? D : 0;

  const bool key_ok = lane < Lk && a.mask[(long long)b * Lk * h + lane * h + hd] > 0.0f;
  const unsigned valid = __ballot_sync(0xffffffffu, key_ok);
  float* sq = smem + (size_t)warp * bwd_smem_floats_per_warp(Lq, Lk, D);

  if (valid == 0u) {  // a padding head: dq = dk = 0, dv = pad
    padding_share<T, D>(a, b, hd, sq, lane);
    __syncwarp();
    for (int j = 0; j < Lk; ++j)
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        dvb[j * sl + lane + 32 * c] = Num<T>::from_f(sq[j * pr + lane + 32 * c]);
        dkb[j * sl + lane + 32 * c] = Num<T>::from_f(0.0f);
      }
    for (int i = 0; i < Lq; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c) dqb[i * sl + lane + 32 * c] = Num<T>::from_f(0.0f);
    return;
  }
  const bool mixed = row_has_padding(a, b, lane);

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
  // the padding heads' share of this head's dv, into sv (free from here)
  if (mixed) padding_share<T, D>(a, b, hd, sv, lane);
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
    for (int c = 0; c < kC; ++c) {
      kacc[c] = 0.0f;
      vacc[c] = mixed ? sv[j * pr + lane + 32 * c] : 0.0f;
    }
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
// Warps of a valid-head block at most. The training shapes (one m16 query
// tile, one n8 key tile) run two blocks an SM: 16 warps at D = 64 (64
// registers a thread) and 10 at D = 128, where a warp's staged rows (272
// bytes a row) let ten fit half an SM's shared memory at L 7 anyway and the
// bound gives each thread 96 registers. Longer rows run one block an SM,
// at most 8 warps past one m16 query tile (a warp's rows fill the block's
// shared memory sooner), so that no instantiation spills.
__host__ __device__ constexpr int bwd_warps(int MQ, int D) {
  return MQ > 1 ? 8 : (D == 64 ? 16 : 10);
}
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

// The valid heads. MQ: m16 tiles over the queries (Lq <= 16 * MQ); NK8: n8
// tiles over the keys (Lk <= 8 * NK8).
template <int MQ, int NK8, int D>
__global__ void __launch_bounds__(bwd_warps(MQ, D) * 32, (MQ == 1 && NK8 == 1) ? 2 : 1)
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
  if (valid == 0u) return;  // a padding head: attention_bwd_padding*_kernel's

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

  bool mixed;
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
    // whether another head of the row has no valid key, while the rows load
    mixed = a.row_pad[b] != 0;
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
  bf16* dvb = (bf16*)a.dv + off_k;
  if (!mixed) {
    grad_product<MK, MQ, true, D>(swd, PS, sg, Lq, zero, so, Lk, dvb, sl, lane);
    return;
  }
  // a mixed row: dV = Wd^T dO plus the padding heads' share, in f32 before
  // the cast, scalar (no caller builds such a row); the share goes to the k
  // and v rows, free from here (4 Lk (D + 8) bytes for Lk D floats)
  float* pc = reinterpret_cast<float*>(sk);
  padding_share<bf16, D>(a, b, hd, pc, lane);
  __syncwarp();
  const int pr = a.dropout ? D : 0;
  for (int j = 0; j < Lk; ++j)
    for (int c = lane; c < D; c += 32) {
      float acc = pc[j * pr + c];
      for (int i = 0; i < Lq; ++i)
        acc += __bfloat162float(swd[i * PS + j]) * __bfloat162float(sg[i * kSRow + c]);
      dvb[j * sl + c] = __float2bfloat16_rn(acc);
    }
}

template <int MQ, int NK8, int D>
cudaError_t launch_bwd_mma(const AttnBwdArgs& a, cudaStream_t stream) {
  const int per_warp = bwd_mma_bytes_per_warp(a.Lq, a.Lk, MQ, NK8, D);
  int warps = (kBwdBlockSmem - zero_row_bytes(D)) / per_warp;
  warps = warps < 1 ? 1 : (warps > bwd_warps(MQ, D) ? bwd_warps(MQ, D) : warps);
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
inline cudaError_t launch_valid_heads(const AttnBwdArgs& a, cudaStream_t s) {
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

// ------------------------------------------- bf16: the padding heads, by row
constexpr int kPadThreads = 256;
constexpr int kPadWarps = kPadThreads / 32;
constexpr int kPadSmem = 232448 / 2 - 1024;  // two CTAs an SM (1 KB reserved each)

// Rows a CTA reads the key masks of at once: one (row, head) pair a
// thread, at most 32 rows.
__host__ __device__ inline int pad_group(int h) {
  const int g = kPadThreads / h;
  return g < 1 ? 1 : (g > 32 ? 32 : g);
}

// Bytes of the padding kernels' flags of a group of G rows: a byte a (row,
// head), then 32 bytes "some head of row r has no valid key" and 32 "no
// head of row r has one".
__host__ __device__ inline int pad_flag_bytes(int h) { return pad_group(h) * h + 64; }

// The flags of rows b0 .. b0 + G - 1 into pad (rows past the batch have
// none), by the CTA: pad[r * h + hh] where head hh of row b0 + r has no
// valid key, pad[G * h + r] where some head of it has none (also to
// row_pad), pad[G * h + 32 + r] where every head has none. CTA barriers.
__device__ __forceinline__ void stage_padding_flags(const AttnBwdArgs& a, int b0, int G,
                                                    uint8_t* pad) {
  const int h = a.h;
  uint8_t* row = pad + G * h;
  for (int e = threadIdx.x; e < G * h; e += blockDim.x)
    pad[e] = b0 + e / h < a.B && !head_has_key(a, b0 + e / h, e % h);
  __syncthreads();
  for (int r = threadIdx.x; r < G; r += blockDim.x) {
    bool some = false, all = true;
    for (int hh = 0; hh < h; ++hh) {
      some |= pad[r * h + hh];
      all &= pad[r * h + hh];
    }
    row[r] = some;
    row[32 + r] = all;
    if (b0 + r < a.B) a.row_pad[b0 + r] = some;
  }
  __syncthreads();
}

// Zeros to the dq and dk rows of row b's padding heads (all heads where
// whole), 16-byte stores, by the CTA.
template <int D>
__device__ __forceinline__ void zero_padding_grads(const AttnBwdArgs& a, int b,
                                                   const uint8_t* pad, bool whole) {
  constexpr int kCh = D / 8;
  const int h = a.h, nq = a.Lq * h * kCh, nk = a.Lk * h * kCh;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  uint4* dq = reinterpret_cast<uint4*>((bf16*)a.dq + (long long)b * a.Lq * h * D);
  uint4* dk = reinterpret_cast<uint4*>((bf16*)a.dk + (long long)b * a.Lk * h * D);
  for (int c = threadIdx.x; c < nq; c += blockDim.x)
    if (whole || pad[(c / kCh) % h]) dq[c] = z;
  for (int c = threadIdx.x; c < nk; c += blockDim.x)
    if (whole || pad[(c / kCh) % h]) dk[c] = z;
}

// Rate 0: shared memory holds the f32 partial sums [kPadThreads][8], pad
// as bf16 [D] and the flags.
__host__ __device__ inline int pad_smem_bytes(int h, int D) {
  return kPadThreads * 8 * 4 + D * 2 + pad_flag_bytes(h);
}

template <int D>
__global__ void __launch_bounds__(kPadThreads) attention_bwd_padding_kernel(AttnBwdArgs a) {
  constexpr int kCh = D / 8;               // 16-byte chunks of a D row
  constexpr int kR = kPadThreads / kCh;    // dout rows summed side by side
  extern __shared__ __align__(16) uint8_t pad_smem[];
  float* part = reinterpret_cast<float*>(pad_smem);
  bf16* vec = reinterpret_cast<bf16*>(part + kPadThreads * 8);
  uint8_t* flags = reinterpret_cast<uint8_t*>(vec + D);
  const int t = threadIdx.x, cc = t % kCh, r0 = t / kCh;
  const int h = a.h, nq = a.Lq * h, nk = a.Lk * h;
  const float w = Num<bf16>::round(1.0f / (float)nk);
  const int G = pad_group(h);
  for (int b0 = blockIdx.x * G; b0 < a.B; b0 += gridDim.x * G) {
    stage_padding_flags(a, b0, G, flags);
    for (int r = 0; r < G; ++r) {
      if (!flags[G * h + r]) continue;
      const int b = b0 + r;
      const uint8_t* pad = flags + r * h;
      const bool whole = flags[G * h + 32 + r];
      // the padding heads' dout rows, each read once: thread t sums columns
      // 8 cc.. of rows r0, r0 + kR, ...
      const uint4* g =
          reinterpret_cast<const uint4*>((const bf16*)a.dout + (long long)b * nq * D) + cc;
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll 4
      for (int q = r0; q < nq; q += kR)
        if (whole || pad[q % h]) {
          const uint4 x = __ldg(g + q * kCh);
          const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(x2[e]);
            acc[2 * e] += f.x;
            acc[2 * e + 1] += f.y;
          }
        }
      float4* p4 = reinterpret_cast<float4*>(part + t * 8);
      p4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      p4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      __syncthreads();
      if (t < D) {  // column t: chunk t / 8, element t % 8
        float sum = 0.0f;
        for (int q = 0; q < kR; ++q) sum += part[(q * kCh + t / 8) * 8 + t % 8];
        vec[t] = __float2bfloat16_rn(w * sum);
      }
      __syncthreads();
      zero_padding_grads<D>(a, b, pad, whole);
      const uint4 v = reinterpret_cast<const uint4*>(vec)[cc];
      uint4* dv = reinterpret_cast<uint4*>((bf16*)a.dv + (long long)b * nk * D);
      for (int c = t; c < nk * kCh; c += kPadThreads)  // c % kCh == cc
        if (whole || pad[(c / kCh) % h]) dv[c] = v;
    }
    __syncthreads();  // the flags are the next group's
  }
}

// Rate > 0: shared memory holds one zero row, each warp's 16-row output
// tile, kc staged dout rows (rows of srow(D)) and the flags.
__host__ __device__ inline int pad_dropout_fixed_bytes(int h, int D) {
  return 2 * srow(D) * (1 + 16 * kPadWarps) + pad_flag_bytes(h);
}

template <int D>
__global__ void __launch_bounds__(kPadThreads, 2)
attention_bwd_padding_dropout_kernel(AttnBwdArgs a, int kc) {
  constexpr int kSRow = srow(D), kCh = D / 8;
  extern __shared__ __align__(16) uint8_t pad_smem[];
  bf16* zero = reinterpret_cast<bf16*>(pad_smem);
  bf16* tiles = zero + kSRow;
  bf16* sg = tiles + 16 * kPadWarps * kSRow;
  uint8_t* flags = reinterpret_cast<uint8_t*>(sg + kc * kSRow);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lr = lane & 7, mat = lane >> 3, g = lane >> 2, q4 = lane & 3;
  for (int t = threadIdx.x; t < kSRow; t += blockDim.x) zero[t] = __float2bfloat16_rn(0.0f);
  const int h = a.h, nq = a.Lq * h, nk = a.Lk * h;
  const int m_tiles = (nk + 15) / 16;
  const float wd = Num<bf16>::round(Num<bf16>::round(1.0f / (float)nk) * a.keep_scale);
  bf16* so = tiles + warp * 16 * kSRow;
  const int G = pad_group(h);
  for (int b0 = blockIdx.x * G; b0 < a.B; b0 += gridDim.x * G) {
    stage_padding_flags(a, b0, G, flags);
    for (int rb = 0; rb < G; ++rb) {
      if (!flags[G * h + rb]) continue;
      const int b = b0 + rb;
      const uint8_t* pad = flags + rb * h;
      const bool whole = flags[G * h + 32 + rb];
      zero_padding_grads<D>(a, b, pad, whole);
      const bf16* gb = (const bf16*)a.dout + (long long)b * nq * D;
      bf16* dvb = (bf16*)a.dv + (long long)b * nk * D;
      int staged = -1;  // the first merged query staged in sg
      for (int mt0 = 0; mt0 < m_tiles; mt0 += kPadWarps) {
        const int mt = mt0 + warp;  // this warp's keys: 16 mt ..
        float acc[D / 8][4];
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
        for (int k0 = 0; k0 < nq; k0 += kc) {
          const int rows = nq - k0 < kc ? nq - k0 : kc;
          if (staged != k0) {
            __syncthreads();  // every warp is done with the rows staged before
            for (int c = threadIdx.x; c < rows * kCh; c += blockDim.x) {
              const int r = c / kCh, ch = (c % kCh) * 8;
              cp_async16(sg + r * kSRow + ch, gb + (long long)(k0 + r) * D + ch);
            }
            asm volatile("cp.async.wait_all;\n" ::: "memory");
            __syncthreads();
            staged = k0;
          }
          if (mt >= m_tiles) continue;
          for (int ks = 0; ks < (rows + 15) / 16; ++ks) {
            // A: the kept wd of keys 16 mt + g (+ 8) and queries k0 + 16 ks +
            // 2 q4 (+ 1, + 8, + 9), one Philox word an entry
            uint32_t af[4];
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int kh = 0; kh < 2; ++kh) {
                const int m = 16 * mt + g + 8 * r, qi = k0 + 16 * ks + 8 * kh + 2 * q4;
                float e[2];
#pragma unroll
                for (int u = 0; u < 2; ++u)
                  e[u] = (m < nk && qi + u < nq && (whole || (pad[m % h] && pad[(qi + u) % h])) &&
                          dropout_keep(a.seed, a.keep_threshold, a.row_offset + b, qi + u, m))
                             ? wd
                             : 0.0f;
                af[r + 2 * kh] = pack_bf16(e[0], e[1]);
              }
            const int kr = 16 * ks + lr + 8 * (mat & 1);
            const bf16* grow = kr < rows ? sg + kr * kSRow : zero;
#pragma unroll
            for (int pp = 0; pp < D / 16; ++pp) {  // 16 of the D columns at a time
              uint32_t bf[4];
              ldsm_x4_t(bf, saddr(grow + 16 * pp + 8 * (mat >> 1)));
              mma16816(acc[2 * pp], af, bf[0], bf[1]);
              mma16816(acc[2 * pp + 1], af, bf[2], bf[3]);
            }
          }
        }
        if (mt < m_tiles) {
          // through the warp's tile to 16-byte stores, the padding heads' keys
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int n = 0; n < D / 8; ++n)
              *reinterpret_cast<uint32_t*>(so + (g + 8 * r) * kSRow + 8 * n + 2 * q4) =
                  pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
          __syncwarp();
          for (int c = lane; c < 16 * kCh; c += 32) {
            const int rr = c / kCh, m = 16 * mt + rr, ch = (c % kCh) * 8;
            if (m < nk && (whole || pad[m % h]))
              *reinterpret_cast<uint4*>(dvb + (long long)m * D + ch) =
                  *reinterpret_cast<const uint4*>(so + rr * kSRow + ch);
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();  // the flags and sg are the next group's
  }
}

// Persistent CTAs over groups of rows, as many as fit an SM (at most one a
// group).
template <typename Kernel, typename... Args>
cudaError_t launch_row_ctas(Kernel kernel, int smem, int groups, cudaStream_t stream,
                            Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPadThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int grid = sms * per_sm < groups ? sms * per_sm : groups;
  kernel<<<grid, kPadThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
inline cudaError_t launch_padding_heads(const AttnBwdArgs& a, cudaStream_t s) {
  const int groups = (a.B + pad_group(a.h) - 1) / pad_group(a.h);
  if (!a.dropout)
    return launch_row_ctas(attention_bwd_padding_kernel<D>, pad_smem_bytes(a.h, D), groups, s,
                           a);
  // as many of a row's Lq*h dout rows as fit two CTAs an SM, in whole m16 steps
  const int fixed = pad_dropout_fixed_bytes(a.h, D);
  const int kc_max = (kPadSmem - fixed) / (2 * srow(D)) / 16 * 16;
  if (kc_max < 16) return cudaErrorInvalidValue;
  const int nq16 = (a.Lq * a.h + 15) / 16 * 16;
  const int kc = nq16 < kc_max ? nq16 : kc_max;
  return launch_row_ctas(attention_bwd_padding_dropout_kernel<D>, fixed + 2 * srow(D) * kc,
                         groups, s, a, kc);
}

// The padding heads first: they write row_pad, which the valid heads read.
template <int D>
inline cudaError_t launch_attention_bwd_bf16(const AttnBwdArgs& a, cudaStream_t s) {
  const cudaError_t err = launch_padding_heads<D>(a, s);
  return err != cudaSuccess ? err : launch_valid_heads<D>(a, s);
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
// batch, as the forward took it. row_pad: B bytes of scratch (bf16). Returns
// a cudaError_t (0 = success).
extern "C" int zt_attention_core_bwd(int dtype, const void* qm, const void* km, const void* vm,
                                     const float* kmaskf, const void* dout, void* dqm,
                                     void* dkm, void* dvm, int B, int Lq, int Lk, int h, int d,
                                     int dropout, unsigned int seed, unsigned int keep_threshold,
                                     float keep_scale, float keep_scale32, unsigned int row_offset,
                                     void* row_pad, void* stream) {
  if (B <= 0) return 0;  // nothing to launch
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
  a.row_pad = (uint8_t*)row_pad;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64: return (int)zt::launch_attention_bwd<64>(dtype, a, s);
    case 128: return (int)zt::launch_attention_bwd<128>(dtype, a, s);
  }
  return (int)cudaErrorInvalidValue;
}
