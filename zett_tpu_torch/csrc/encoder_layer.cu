// Kernel 1: one whole post-LN hypernet encoder layer, forward only.
//
// Replaces the TPU kernel zett_tpu/ops/pallas_attention.py _layer_kernel /
// encoder_layer_pallas (:727, :825), tier 3: QKV projections -> masked
// per-head softmax attention -> output projection -> +residual, flax-exact
// LayerNorm -> FFN (tanh-gelu) -> +residual, LayerNorm.
//
// What bounds it on an H100: the four projections and the FFN, 2*M*(4H^2 +
// 2HI) operations for M = rows*positions. At the transfer's shapes (M =
// 16384*7, H = 768, I = 1536, bf16) that is ~1.08 TFLOP against ~0.36 GB of
// layer input, output and weights: compute-bound on the tensor cores
// (>= 1.09 ms at 989 TFLOP/s). The design keeps the products on the tensor
// cores in gemm.cuh's Hopper GEMM (shared with kernel 4: persistent,
// warp-specialised, TMA into a 4-stage mbarrier ring, wgmma m64n256k16,
// fused bias/gelu epilogue; weights given transposed, (N, K)); the
// attention core keeps each row's score plane on chip (attention.cuh); the
// residual LayerNorms are one warp per position. The layer runs as seven
// launches on the caller's stream; the (M, 3H), (M, H) and (M, I)
// intermediates go through device memory, which a later, fully fused
// version removes. The f32 path uses plain FMA tiles (no TF32), for
// comparisons at full precision.
//
// Numerics (pallas_attention.py:39-45, 692-703, 741-744): each projection
// accumulates in f32, is cast to T, and only then adds its bias in T, as
// flax nn.Dense does; gelu runs in f32 on that T value and is cast once;
// a residual sum is rounded to T before the LayerNorm, whose statistics are
// f32 with the fast variance max(0, E[x^2] - mean^2) and rsqrt(var + eps)
// multiplied by the scale before it multiplies (x - mean).
#include "gemm.cuh"

namespace zt {

// ------------------------------------------------- residual add + LayerNorm
// out = LN(round_T(a + b)) * scale + bias, one warp per row of H values.
template <typename T>
__global__ void add_layer_norm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ shift, T* __restrict__ out,
                                      int M, int H, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* ar = a + (size_t)row * H;
  const T* br = b + (size_t)row * H;
  float sum = 0.0f, sumsq = 0.0f;
  for (int t = lane; t < H; t += 32) {
    const float x = Num<T>::round(Num<T>::to_f(ar[t]) + Num<T>::to_f(br[t]));
    sum += x;
    sumsq += x * x;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
  }
  const float mean = sum / (float)H;
  const float var = fmaxf(0.0f, sumsq / (float)H - mean * mean);
  const float rstd = 1.0f / sqrtf(var + eps);
  T* orow = out + (size_t)row * H;
  for (int t = lane; t < H; t += 32) {
    const float x = Num<T>::round(Num<T>::to_f(ar[t]) + Num<T>::to_f(br[t]));
    orow[t] = Num<T>::from_f((x - mean) * (rstd * scale[t]) + shift[t]);
  }
}

template <typename T>
cudaError_t add_layer_norm(const T* a, const T* b, const float* scale, const float* shift,
                           T* out, int M, int H, float eps, cudaStream_t s) {
  const int rows_per_block = 8;
  const unsigned grid = (unsigned)((M + rows_per_block - 1) / rows_per_block);
  add_layer_norm_kernel<T><<<grid, rows_per_block * 32, 0, s>>>(a, b, scale, shift, out, M, H,
                                                                 eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t encoder_layer(const T* x, const float* mask, int B, int L, int H, int nh, int I,
                          const T* wqkv_t, const T* bqkv, const T* wo_t, const T* bo,
                          const float* ln1s, const float* ln1b, const T* w1_t, const T* b1,
                          const T* w2_t, const T* b2, const float* ln2s, const float* ln2b,
                          float eps, int act, T* qkv, T* ctx, T* tmp, T* y1, T* mid, T* out,
                          cudaStream_t s) {
  const int M = B * L;
  cudaError_t err;
#define ZT_TRY(call)          \
  err = (call);               \
  if (err != cudaSuccess) return err;
  ZT_TRY(gemm<T>(x, wqkv_t, bqkv, qkv, M, 3 * H, H, 0, s));
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
  a.m_sb = L;
  a.m_sl = 1;
  a.m_sh = 0;
  ZT_TRY(launch_attention<T>(a, s));
  ZT_TRY(gemm<T>(ctx, wo_t, bo, tmp, M, H, H, 0, s));
  ZT_TRY(add_layer_norm<T>(tmp, x, ln1s, ln1b, y1, M, H, eps, s));
  ZT_TRY(gemm<T>(y1, w1_t, b1, mid, M, I, H, act, s));
  ZT_TRY(gemm<T>(mid, w2_t, b2, tmp, M, H, I, 0, s));
  ZT_TRY(add_layer_norm<T>(tmp, y1, ln2s, ln2b, out, M, H, eps, s));
#undef ZT_TRY
  return cudaSuccess;
}

}  // namespace zt

// dtype: 0 = float32, 1 = bfloat16; act: 0 = no activation, 1 = tanh-gelu.
// Weights transposed, row-major: wqkv_t (3H, H), wo_t (H, H), w1_t (I, H),
// w2_t (H, I); H % 8 == 0 and I % 8 == 0 (rows of whole 16-byte units).
// Returns a cudaError_t (0 = success).
extern "C" int zt_encoder_layer(int dtype, const void* x, const float* mask, int B, int L,
                                int H, int nh, int I, const void* wqkv_t, const void* bqkv,
                                const void* wo_t, const void* bo, const float* ln1s,
                                const float* ln1b, const void* w1_t, const void* b1,
                                const void* w2_t, const void* b2, const float* ln2s,
                                const float* ln2b, float eps, int act, void* qkv, void* ctx,
                                void* tmp, void* y1, void* mid, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    using T = zt::bf16;
    return (int)zt::encoder_layer<T>(
        (const T*)x, mask, B, L, H, nh, I, (const T*)wqkv_t, (const T*)bqkv, (const T*)wo_t,
        (const T*)bo, ln1s, ln1b, (const T*)w1_t, (const T*)b1, (const T*)w2_t, (const T*)b2, ln2s,
        ln2b, eps, act, (T*)qkv, (T*)ctx, (T*)tmp, (T*)y1, (T*)mid, (T*)out, s);
  }
  using T = float;
  return (int)zt::encoder_layer<T>(
      (const T*)x, mask, B, L, H, nh, I, (const T*)wqkv_t, (const T*)bqkv, (const T*)wo_t,
      (const T*)bo, ln1s, ln1b, (const T*)w1_t, (const T*)b1, (const T*)w2_t, (const T*)b2, ln2s,
      ln2b, eps, act, (T*)qkv, (T*)ctx, (T*)tmp, (T*)y1, (T*)mid, (T*)out, s);
}
