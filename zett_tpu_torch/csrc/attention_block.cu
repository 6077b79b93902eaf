// Kernel 4: the hypernet's attention block forward (tier 2): the fused
// [q|k|v] projection, the masked per-head core with an optional additive
// key bias, and the output projection.
//
// Replaces the TPU kernel zett_tpu/ops/pallas_attention.py _block_kernel /
// attention_block_pallas (:530, :611). On the inference route it runs every
// encoder layer's self-attention that cannot take kernel 1's whole layer:
// every layer of a configuration with inter-token attention, and every
// non-CLS layer of an erf-gelu one (a reference-format checkpoint's). Head
// widths 64 and 128 (the core of attention.cuh at either, up to 32 heads in
// bf16: two heads a warp past 16).
//
// Inputs: x (B, L, H) in T (f32 or bf16), mask (B, L) f32 (null: every key
// valid), kbias (B, L) in T (null: no bias), wqkv_t = [wq | wk | wv]^T
// (3H, H), bqkv (3H), wo_t = wo^T (H, H), bo (H). Output (B, L, H).
//
// What bounds it on an H100: the four (M, H) x (H, H) projections, 2*M*4*H^2
// operations for M = B*L. At the transfer's shapes (B = 16384, L = 8,
// H = 768, bf16) that is 0.618 TFLOP against 0.40 GB of x and out (plus
// 4.7 MB of weights): bound by the tensor cores at >= 0.63 ms at
// 989 TFLOP/s; the core adds 3.2 GFLOP. The design runs three launches on
// the caller's stream: the Hopper GEMM of gemm.cuh (persistent,
// warp-specialised, TMA into a 4-stage mbarrier ring, wgmma m64n256k16,
// bias epilogue in registers) for one fused (M, H) x (H, 3H) product, the
// core of attention.cuh reading q/k/v out of the (M, 3H) buffer by stride
// (the score plane stays on chip), and the same GEMM for the output
// projection. The weights come transposed, (3H, H) and (H, H), as the
// GEMM's K-major B operand. The (M, 3H) and (M, H) intermediates go through
// device memory (3.0x the bytes of x and out at bf16); fusing the core into
// the [q|k|v] GEMM's epilogue removes the larger one.
// The TPU kernel's head-major merge and L % 8 padding are Mosaic layout
// workarounds and are not carried over: a row with no valid key averages
// uniformly over its own L*h merged value rows, as the reference
// (attention_block_reference) does.
//
// Numerics (pallas_attention.py:541-545, 560-592): each projection
// accumulates in f32, is cast to T, then adds its bias in T; the core
// rounds as attention.cuh says.
#include "gemm.cuh"

namespace zt {

template <typename T>
cudaError_t attention_block(const T* x, const float* mask, const T* kbias, int B, int L, int H,
                            int nh, const T* wqkv_t, const T* bqkv, const T* wo_t, const T* bo,
                            T* qkv, T* ctx, T* out, cudaStream_t s) {
  const int M = B * L;
  cudaError_t err = gemm<T>(x, wqkv_t, bqkv, qkv, M, 3 * H, H, 0, s);
  if (err != cudaSuccess) return err;
  AttnArgs a;
  a.q = qkv;
  a.k = qkv + H;
  a.v = qkv + 2 * H;
  a.out = ctx;
  a.mask = mask;
  a.B = B;
  a.Lq = L;
  a.Lk = L;
  a.h = nh;
  a.q_sb = a.k_sb = a.v_sb = (long long)L * 3 * H;
  a.q_sl = a.k_sl = a.v_sl = 3 * H;
  a.o_sb = (long long)L * H;
  a.o_sl = H;
  a.m_sb = a.kb_sb = L;
  a.m_sl = a.kb_sl = 1;
  a.m_sh = a.kb_sh = 0;
  a.kbias = kbias;
  err = launch_attention_d<T>(a, H / nh, s);  // head width 64 or 128
  if (err != cudaSuccess) return err;
  return gemm<T>(ctx, wo_t, bo, out, M, H, H, 0, s);
}

}  // namespace zt

// dtype: 0 = float32, 1 = bfloat16. wqkv_t = [wq | wk | wv]^T (3H, H) and
// wo_t = wo^T (H, H), row-major; H % 8 == 0; H / nh is 64 or 128. qkv (B*L, 3H) and ctx
// (B*L, H) are scratch buffers of the caller's. Returns a cudaError_t (0 = success).
extern "C" int zt_attention_block(int dtype, const void* x, const float* mask, const void* kbias,
                                  int B, int L, int H, int nh, const void* wqkv_t,
                                  const void* bqkv, const void* wo_t, const void* bo, void* qkv,
                                  void* ctx, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    using T = zt::bf16;
    return (int)zt::attention_block<T>((const T*)x, mask, (const T*)kbias, B, L, H, nh,
                                       (const T*)wqkv_t, (const T*)bqkv, (const T*)wo_t,
                                       (const T*)bo, (T*)qkv, (T*)ctx, (T*)out, s);
  }
  using T = float;
  return (int)zt::attention_block<T>((const T*)x, mask, (const T*)kbias, B, L, H, nh,
                                     (const T*)wqkv_t, (const T*)bqkv, (const T*)wo_t, (const T*)bo,
                                     (T*)qkv, (T*)ctx, (T*)out, s);
}
