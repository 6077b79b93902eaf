// Kernel 5: the masked merged-head attention core forward with an optional
// additive key bias (tier 1).
//
// Replaces the TPU kernel zett_tpu/ops/pallas_attention.py _core_kernel /
// merged_attention_pallas (:87, :131). Inputs are position-major merged:
// qm (B, Lq*h, 64), km/vm (B, Lk*h, 64), index = position*h + head; kmaskf
// (B, Lk*h) f32 (null: every key valid) and kbias (B, Lk*h) in T (null: no
// bias). That memory is the plain (B, L, h*64) layout, so the per-head core
// of attention.cuh reads it with a head offset and no relayout. The TPU
// kernel scores all Lq*h x Lk*h merged pairs and masks the off-head blocks;
// this one computes only each head's own Lq x Lk block, which the merged
// form reduces to exactly (the off-head weights underflow to 0).
//
// What bounds it on an H100: at B = 16384, Lq*h = Lk*h = 96 (the tier-2
// block's core at L = 8, bf16) it does 2*2*B*h*L*L*64 = 3.2 GFLOP against
// ~0.81 GB of q/k/v/out/mask/bias, so it is memory-bound (>= 0.24 ms at
// 3.35 TB/s). The design reads each key and value row once into shared
// memory, keeps the scores and weights on chip, and writes only the context.
#include "attention.cuh"

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int zt_merged_attention(int dtype, const void* qm, const void* km, const void* vm,
                                   const float* kmaskf, const void* kbias, void* out, int B,
                                   int Lq, int Lk, int h, void* stream) {
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
  a.q_sb = a.o_sb = (long long)Lq * h * zt::kHeadDim;
  a.k_sb = a.v_sb = (long long)Lk * h * zt::kHeadDim;
  a.q_sl = a.k_sl = a.v_sl = a.o_sl = (long long)h * zt::kHeadDim;
  a.m_sb = a.kb_sb = (long long)Lk * h;
  a.m_sl = a.kb_sl = h;
  a.m_sh = a.kb_sh = 1;
  a.kbias = kbias;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return (int)zt::launch_attention<__nv_bfloat16>(a, s);
  return (int)zt::launch_attention<float>(a, s);
}
