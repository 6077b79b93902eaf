// Row-major GEMM with a fused bias (and optional tanh-gelu) epilogue, shared
// by encoder_layer.cu (kernel 1) and attention_block.cu (kernel 4).
//
// C[M, N] = epilogue(A[M, K] @ W[K, N]). bf16 runs on the tensor cores
// (mma.sync through WMMA, bf16 in, f32 accumulate) in 128 x 128 x 32 block
// tiles with a cp.async double-buffered pipeline; f32 uses plain FMA tiles
// (no TF32), for comparisons at full precision.
//
// Numerics (zett_tpu/ops/pallas_attention.py:541-545, 741-744): the product
// accumulates in f32, is cast to T, and only then adds its bias in T, as
// flax nn.Dense does; gelu runs in f32 on that T value and is cast once.
#pragma once

#include "attention.cuh"

#include <mma.h>

namespace zt {

using bf16 = __nv_bfloat16;

constexpr int kGemmThreads = 256;

// tanh approximation (flax nn.gelu's default, the hypernet's gelu_new)
__device__ __forceinline__ float gelu_f(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float cdf = 0.5f * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x))));
  return x * cdf;
}

// act: 0 none, 1 tanh-gelu
template <typename T>
__device__ __forceinline__ float epilogue(float acc, const T* bias, int col, int act) {
  float y = Num<T>::round(acc);
  y = Num<T>::round(y + Num<T>::to_f(bias[col]));
  if (act) y = Num<T>::round(gelu_f(y));
  return y;
}

// ---------------------------------------------------------------- bf16 GEMM
// All row-major, K % 32 == 0, N % 8 == 0, 16-byte aligned operands. Block
// tile 128 x 128 x 32, 8 warps of 32 x 64 each.
constexpr int BM = 128, BN = 128, BK = 32, APAD = 8, BPAD = 8;

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem_ptr) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_ptr);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_ptr));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kGemmThreads)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                 const bf16* __restrict__ bias, bf16* __restrict__ C, int M, int N,
                 int K, int act) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[2][BM][BK + APAD];
  __shared__ __align__(128) bf16 Bs[2][BK][BN + BPAD];
  __shared__ __align__(128) float Cs[kGemmThreads / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int c = tid + l * kGemmThreads;
      const int row = c / (BK / 8), ch = c % (BK / 8);
      const int grow = min(m0 + row, M - 1);  // ragged M: clamp, never stored
      cp_async16(&As[stage][row][ch * 8], A + (size_t)grow * K + k0 + ch * 8);
    }
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int c = tid + l * kGemmThreads;
      const int row = c / (BN / 8), ch = c % (BN / 8);
      const int gcol = min(n0 + ch * 8, N - 8);  // ragged N: clamp, never stored
      cp_async16(&Bs[stage][row][ch * 8], W + (size_t)(k0 + row) * N + gcol);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = K / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) {
      load_tile((kt + 1) & 1, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &As[st][wm * 32 + i * 16][kk], BK + APAD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bfr[j], &Bs[st][kk][wn * 64 + j * 16], BN + BPAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  // epilogue through a per-warp 16x16 f32 staging tile; each lane owns 8
  // consecutive columns of one row and writes them as one 16-byte store
  float* stage = Cs[warp];
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int grow = m0 + wm * 32 + i * 16 + r;
      const int gcol = n0 + wn * 64 + j * 16 + c0;
      if (grow < M && gcol < N) {
        __align__(16) bf16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = __float2bfloat16_rn(epilogue<bf16>(stage[r * 16 + c0 + e], bias, gcol + e, act));
        *reinterpret_cast<uint4*>(C + (size_t)grow * N + gcol) = *reinterpret_cast<uint4*>(o);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------- f32 GEMM
// Plain FMA tiles 64 x 64 x 16, 4 x 4 outputs per thread (no tensor cores,
// no TF32): the full-precision path. K % 16 == 0.
constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(kGemmThreads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, float* __restrict__ C, int M, int N,
                int K, int act) {
  __shared__ float As[FK][FM + 4];
  __shared__ float Bs[FK][FN + 4];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int idx = tid + l * kGemmThreads;
      const int r = idx / FK, c = idx % FK;
      As[c][r] = (m0 + r < M) ? A[(size_t)(m0 + r) * K + k0 + c] : 0.0f;
      const int rb = idx / FN, cb = idx % FN;
      Bs[rb][cb] = (n0 + cb < N) ? W[(size_t)(k0 + rb) * N + n0 + cb] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) C[(size_t)row * N + col] = epilogue<float>(acc[i][j], bias, col, act);
    }
  }
}

template <typename T>
cudaError_t gemm(const T* A, const T* W, const T* bias, T* C, int M, int N, int K, int act,
                 cudaStream_t s);

template <>
inline cudaError_t gemm<bf16>(const bf16* A, const bf16* W, const bf16* bias, bf16* C, int M,
                              int N, int K, int act, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<<<grid, kGemmThreads, 0, s>>>(A, W, bias, C, M, N, K, act);
  return cudaGetLastError();
}

template <>
inline cudaError_t gemm<float>(const float* A, const float* W, const float* bias, float* C,
                               int M, int N, int K, int act, cudaStream_t s) {
  dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
  gemm_f32_kernel<<<grid, kGemmThreads, 0, s>>>(A, W, bias, C, M, N, K, act);
  return cudaGetLastError();
}

}  // namespace zt
