// Kernel 3: the merged-head attention core backward, with the forward's
// seeded dropout mask regenerated.
//
// Replaces the TPU kernel zett_tpu/ops/pallas_attention.py
// _core_train_bwd_kernel / _core_train_bwd_pallas (:254, :369), the backward
// of merged_attention_train. Operands are kernel 2's: qm (B, Lq*h, 64),
// km/vm (B, Lk*h, 64) position-major merged, kmaskf (B, Lk*h) f32, plus
// dout (B, Lq*h, 64); it writes dqm, dkm, dvm of the operands' shapes.
//
// One warp owns one (row, head) pair, as in the forward: it stages that
// head's q, k, v and dout rows in shared memory as f32, recomputes the
// weights exactly as the forward does (attention.cuh), regenerates the keep
// mask from the same Philox counters, and computes per query i, key j:
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
#include "attention.cuh"

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
};

__host__ __device__ inline int bwd_smem_floats_per_warp(int Lq, int Lk) {
  return (2 * Lq + 2 * Lk) * kRowPad + 3 * Lq * (Lk + 1);
}

template <typename T>
__global__ void __launch_bounds__(kAttnWarps * 32) attention_bwd_kernel(AttnBwdArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long pair = (long long)blockIdx.x * kAttnWarps + warp;
  if (pair >= (long long)a.B * a.h) return;  // whole warp leaves together
  const int b = (int)(pair / a.h);
  const int hd = (int)(pair % a.h);
  const int Lq = a.Lq, Lk = a.Lk, h = a.h;
  const long long sl = (long long)h * kHeadDim;  // one position's row
  const long long q_sb = Lq * sl, k_sb = Lk * sl;
  const long long off_q = b * q_sb + hd * kHeadDim;
  const long long off_k = b * k_sb + hd * kHeadDim;

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
    // all-padding row: uniform weights over all Lk*h merged entries; the
    // select gives dq = dk = 0, and dv_(j,hd) sums every query head's dout
    const float w = Num<T>::round(1.0f / (float)(Lk * h));
    const float wd = a.dropout ? Num<T>::round(w * a.keep_scale) : w;
    const T* grow = (const T*)a.dout + b * q_sb;
    for (int c = 0; c < 2; ++c) {
      const int dim = lane + 32 * c;
      for (int j = 0; j < Lk; ++j) {
        float acc = 0.0f;
        for (int i = 0; i < Lq; ++i)
          for (int hh = 0; hh < h; ++hh)
            if (!a.dropout ||
                dropout_keep(a.seed, a.keep_threshold, b, i * h + hh, j * h + hd))
              acc += wd * Num<T>::to_f(grow[i * sl + hh * kHeadDim + dim]);
        dvb[j * sl + dim] = Num<T>::from_f(acc);
        dkb[j * sl + dim] = Num<T>::from_f(0.0f);
      }
      for (int i = 0; i < Lq; ++i) dqb[i * sl + dim] = Num<T>::from_f(0.0f);
    }
    return;
  }

  float* sq = smem + (size_t)warp * bwd_smem_floats_per_warp(Lq, Lk);
  float* sk = sq + Lq * kRowPad;
  float* sv = sk + Lk * kRowPad;
  float* sg = sv + Lk * kRowPad;
  float* sw = sg + Lq * kRowPad;  // weights w, [Lq][Lk + 1]
  float* swd = sw + Lq * (Lk + 1);  // dropped weights wd
  float* sds = swd + Lq * (Lk + 1);  // dw, then ds
  for (int i = 0; i < Lq; ++i)
    for (int c = 0; c < 2; ++c) {
      sq[i * kRowPad + lane + 32 * c] = Num<T>::to_f(qb[i * sl + lane + 32 * c]);
      sg[i * kRowPad + lane + 32 * c] = Num<T>::to_f(gb[i * sl + lane + 32 * c]);
    }
  for (int j = 0; j < Lk; ++j)
    for (int c = 0; c < 2; ++c) {
      sk[j * kRowPad + lane + 32 * c] = Num<T>::to_f(kb[j * sl + lane + 32 * c]);
      sv[j * kRowPad + lane + 32 * c] = Num<T>::to_f(vb[j * sl + lane + 32 * c]);
    }
  __syncwarp();

  // the forward's weights, recomputed in the same order
  const float sqrt_d = sqrtf((float)kHeadDim);
  const float lowest = Num<T>::lowest();
  for (int idx = lane; idx < Lq * Lk; idx += 32) {
    const int i = idx / Lk;
    const int j = idx % Lk;
    float acc = 0.0f;
#pragma unroll 16
    for (int t = 0; t < kHeadDim; ++t) acc = fmaf(sq[i * kRowPad + t], sk[j * kRowPad + t], acc);
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
    for (int t = 0; t < kHeadDim; ++t) dwd = fmaf(sg[i * kRowPad + t], sv[j * kRowPad + t], dwd);
    const float w = sw[i * (Lk + 1) + j];
    float wd = w, dw = dwd;
    if (a.dropout) {
      const bool kept = dropout_keep(a.seed, a.keep_threshold, b, i * h + hd, j * h + hd);
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
    float acc0 = 0.0f, acc1 = 0.0f;
    for (int j = 0; j < Lk; ++j) {
      acc0 = fmaf(drow[j], sk[j * kRowPad + lane], acc0);
      acc1 = fmaf(drow[j], sk[j * kRowPad + lane + 32], acc1);
    }
    dqb[i * sl + lane] = Num<T>::from_f(acc0);
    dqb[i * sl + lane + 32] = Num<T>::from_f(acc1);
  }
  for (int j = 0; j < Lk; ++j) {
    float k0 = 0.0f, k1 = 0.0f, v0 = 0.0f, v1 = 0.0f;
    for (int i = 0; i < Lq; ++i) {
      const float ds = sds[i * (Lk + 1) + j];
      const float wd = swd[i * (Lk + 1) + j];
      k0 = fmaf(ds, sq[i * kRowPad + lane], k0);
      k1 = fmaf(ds, sq[i * kRowPad + lane + 32], k1);
      v0 = fmaf(wd, sg[i * kRowPad + lane], v0);
      v1 = fmaf(wd, sg[i * kRowPad + lane + 32], v1);
    }
    dkb[j * sl + lane] = Num<T>::from_f(k0);
    dkb[j * sl + lane + 32] = Num<T>::from_f(k1);
    dvb[j * sl + lane] = Num<T>::from_f(v0);
    dvb[j * sl + lane + 32] = Num<T>::from_f(v1);
  }
}

template <typename T>
cudaError_t launch_attention_bwd(const AttnBwdArgs& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)kAttnWarps * bwd_smem_floats_per_warp(a.Lq, a.Lk);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long pairs = (long long)a.B * a.h;
  const unsigned grid = (unsigned)((pairs + kAttnWarps - 1) / kAttnWarps);
  attention_bwd_kernel<T><<<grid, kAttnWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace zt

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int zt_attention_core_bwd(int dtype, const void* qm, const void* km, const void* vm,
                                     const float* kmaskf, const void* dout, void* dqm,
                                     void* dkm, void* dvm, int B, int Lq, int Lk, int h,
                                     int dropout, unsigned int seed, unsigned int keep_threshold,
                                     float keep_scale, float keep_scale32, void* stream) {
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
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return (int)zt::launch_attention_bwd<__nv_bfloat16>(a, s);
  return (int)zt::launch_attention_bwd<float>(a, s);
}
