// Kernel 2: the merged-head attention core forward, with seeded dropout of
// the softmax weights.
//
// Replaces the TPU kernel zett_tpu/ops/pallas_attention.py
// _core_train_fwd_kernel / _core_train_fwd_pallas (:215, :335), the tier-4
// core under merged_attention_train. On the transfer path it runs for the
// last, CLS-only encoder layer (one query position against all key
// positions of each surface form, rate 0); on the training route it runs
// for every encoder layer, full-query (Lq = Lk) and CLS-only. Its backward
// is kernel 3 (attention_core_bwd.cu), which regenerates the same keep mask
// (attention.cuh's header note).
//
// Inputs are position-major merged: qm (B, Lq*h, d), km/vm (B, Lk*h, d),
// index = position*h + head, head width d = 64 or 128, and kmaskf (B, Lk*h)
// f32. That memory is the plain (B, L, h*d) layout, so the per-head core of
// attention.cuh reads it with a head offset and no relayout.
//
// What bounds it on an H100: at the transfer's shapes (B = 16384, Lq*h =
// 12, Lk*h = 84, bf16) it does ~2*B*h*Lk*64*2 = 0.35 GFLOP against ~0.40 GB
// of q/k/v/out, so it is memory-bound (>= 0.12 ms at 3.35 TB/s). The design
// reads each key and value row once into shared memory, keeps the scores
// and weights on chip, and writes only the context. At the training shapes
// (B = 32896, Lq*h = Lk*h = 84) it moves ~1.4 GB: >= 0.43 ms. bf16 runs
// attention.cuh's tensor-core kernel (one warp a head of a row,
// mma.sync m16n8k16 for both products, softmax and dropout in registers);
// f32 its scalar path.
//
// At d = 128 (the Llama family's hypernets: TinyLlama's 16 heads of 128)
// the same code runs with the depth of S in eight k16 steps and PV's 128
// output columns in four passes of 32, so a lane's accumulators do not
// grow; the operands move twice the bytes (at B = 32896, L 7, 16 heads:
// ~3.8 GB, >= 1.13 ms) and a row's staging takes 86 KB, so one CTA an SM.
// Past 16 heads of 128 (Mistral-7B's and Llama-3-8B's hypernets: 32 heads)
// a row's staging (up to 213 KB) leaves room for one buffer only, so each
// row is split over a cluster of two CTAs of 16 heads, each a ring of 2-4
// stages of its share filled by bulk copies: the next rows' loads stay in
// flight while a row is computed (attention.cuh). At rate > 0 a row whose
// heads have no valid key draws Lq*h x Lk*h Philox words (50,176 at 32
// heads, L 7), each about 60 integer instructions: that, not memory, bounds
// such rows (tools/kernel2_versions.py counts the instructions).
#include "attention.cuh"

// dtype: 0 = float32, 1 = bfloat16; d: head width, 64 or 128. dropout != 0
// drops weights whose Philox bits are >= keep_threshold and divides the
// others by keep_div (1 - rate in T); row_offset is the launch's first row
// within the whole batch, which keys the mask (attention.cuh). Returns a
// cudaError_t (0 = success).
extern "C" int zt_attention_core(int dtype, const void* qm, const void* km, const void* vm,
                                 const float* kmaskf, void* out, int B, int Lq, int Lk, int h,
                                 int d, int dropout, unsigned int seed, unsigned int keep_threshold,
                                 float keep_div, unsigned int row_offset, void* stream) {
  zt::AttnArgs a;
  a.q = qm;
  a.k = km;
  a.v = vm;
  a.out = out;
  a.mask = kmaskf;
  a.B = B;
  a.Lq = Lq;
  a.Lk = Lk;
  a.h = h;
  a.q_sb = a.o_sb = (long long)Lq * h * d;
  a.k_sb = a.v_sb = (long long)Lk * h * d;
  a.q_sl = a.k_sl = a.v_sl = a.o_sl = (long long)h * d;
  a.m_sb = (long long)Lk * h;
  a.m_sl = h;
  a.m_sh = 1;
  a.dropout = dropout;
  a.seed = seed;
  a.keep_threshold = keep_threshold;
  a.keep_div = keep_div;
  a.row_offset = row_offset;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return (int)zt::launch_attention_d<__nv_bfloat16>(a, d, s);
  return (int)zt::launch_attention_d<float>(a, d, s);
}

// How the bf16 forward runs rows of Lq, Lk positions of h heads of width d
// past 16 heads of 128 (attention.cuh attn_cluster_plan): out[0..4] = CTAs
// a cluster, heads a CTA, stages, shared-memory bytes a CTA, and clusters
// the card holds at once. Returns a cudaError_t (0 = success).
extern "C" int zt_attention_core_plan(int Lq, int Lk, int h, int d, int* out) {
  if (d != 128 || h <= zt::kAttnCtaWarps || Lq > 16 || Lk < 1 || Lk > 32)
    return (int)cudaErrorInvalidValue;
  const zt::ClusterPlan p = zt::attn_cluster_plan(Lq, Lk, h, 128);
  out[0] = p.c;
  out[1] = p.hl;
  out[2] = p.stages;
  out[3] = p.smem;
  out[4] = 0;
  const int nk = (Lk + 7) / 8;
  cudaError_t err = cudaErrorInvalidValue;
  switch (nk) {
    case 1: err = zt::cluster_fit<1, 128>(p, &out[4]); break;
    case 2: err = zt::cluster_fit<2, 128>(p, &out[4]); break;
    case 3: err = zt::cluster_fit<3, 128>(p, &out[4]); break;
    case 4: err = zt::cluster_fit<4, 128>(p, &out[4]); break;
  }
  return (int)err;
}
