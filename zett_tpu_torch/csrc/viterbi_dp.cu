// Kernel 6: the batched Unigram Viterbi DP.
//
// Replaces the TPU kernel zett_tpu/ops/pallas_viterbi.py _viterbi_dp_kernel /
// viterbi_dp_pallas (:25, :68), and the lax.scan DP of
// zett_tpu/ops/device_viterbi.py viterbi_device (:250-268), which share one
// contract. Inputs: span scores S (B, L, K) f32 (NEG = -1e30 where a span is
// absent) and piece ids I (B, L, K) int32. Outputs dp (B, L+K) f32, bk and bi
// (B, L+K) int32. dp[0] = 0, every other dp entry NEG, bk 0, bi -1; then for
// j = 0..L-1 in order, dp[j+1+k] = dp[j] + S[j,k] where that is strictly
// greater, which also sets bk = k+1 and bi = I[j,k]. Each candidate is one
// f32 add (no FMA) and ties keep the earlier writer, so the result is
// bit-identical to the plain PyTorch loop (ops/viterbi_dp.py).
//
// What bounds it on an H100: memory. It reads each S and I entry once and
// writes each output once; at B = 65536, L = 48, K = 16 that is 402.7 MB of
// S + I and 50.3 MB of dp/bk/bi, >= 0.135 ms at 3.35 TB/s, against 50 M f32
// adds. The DP is a sequential scan over j with data-dependent stores.
//
// Design: a group of G lanes (8 for K <= 8, else 16) owns one row; lane t
// handles the span lengths k = t, t + G, ... (KPL of them). The window of
// positions j+1 .. j+K lives in registers, one slot per k: at step j each lane
// relaxes its slots from dp[j] and S[b, j, k] (G lanes read one contiguous
// K-float run), position j+1 is then final and lane 0 writes it, and the
// window shifts down one position through a group shuffle. The next step's S
// and I are loaded before the current step's relax. The TPU kernel's (L, K, B)
// sublane layout, aligned windows and one-hot roll were Mosaic workarounds and
// have no counterpart.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;

template <int G, int KPL>
__global__ void __launch_bounds__(kThreads)
viterbi_dp_kernel(const float* __restrict__ S, const int* __restrict__ I, float* __restrict__ dp,
                  int* __restrict__ bk, int* __restrict__ bi, long long B, int L, int K) {
  const int lane = threadIdx.x % G;
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  if (row >= B) return;  // a whole group leaves together
  const unsigned group_mask = (G == 32 ? 0xffffffffu : ((1u << G) - 1u))
                              << ((threadIdx.x % 32) / G * G);
  const long long W = (long long)L + K;
  const float* s_row = S + row * L * K;
  const int* i_row = I + row * L * K;
  float* dp_row = dp + row * W;
  int* bk_row = bk + row * W;
  int* bi_row = bi + row * W;

  float win[KPL];
  int wk[KPL], wi[KPL];
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    win[m] = kNeg;
    wk[m] = 0;
    wi[m] = -1;
  }
  if (lane == 0) {
    dp_row[0] = 0.0f;
    bk_row[0] = 0;
    bi_row[0] = -1;
  }
  float s_next[KPL];
  int i_next[KPL];
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    const int k = lane + G * m;
    const bool ok = k < K && L > 0;
    s_next[m] = ok ? __ldg(s_row + k) : kNeg;
    i_next[m] = ok ? __ldg(i_row + k) : -1;
  }
  float dj = 0.0f;
  for (int j = 0; j < L; ++j) {
    float s_cur[KPL];
    int i_cur[KPL];
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      s_cur[m] = s_next[m];
      i_cur[m] = i_next[m];
      const int k = lane + G * m;
      const bool ok = k < K && j + 1 < L;
      const long long off = (long long)(j + 1) * K + k;
      s_next[m] = ok ? __ldg(s_row + off) : kNeg;
      i_next[m] = ok ? __ldg(i_row + off) : -1;
    }
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      const int k = lane + G * m;
      if (k < K) {
        const float cand = __fadd_rn(dj, s_cur[m]);
        if (cand > win[m]) {
          win[m] = cand;
          wk[m] = k + 1;
          wi[m] = i_cur[m];
        }
      }
    }
    // position j+1 is final: its last writer was this step (k = 0)
    dj = __shfl_sync(group_mask, win[0], 0, G);
    if (lane == 0) {
      dp_row[j + 1] = win[0];
      bk_row[j + 1] = wk[0];
      bi_row[j + 1] = wi[0];
    }
    // shift the window down one position: slot k takes slot k+1
    const int src = (lane + 1) % G;
    float f_in[KPL];
    int k_in[KPL], i_in[KPL];
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      f_in[m] = __shfl_sync(group_mask, win[m], src, G);
      k_in[m] = __shfl_sync(group_mask, wk[m], src, G);
      i_in[m] = __shfl_sync(group_mask, wi[m], src, G);
    }
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      if (lane < G - 1) {
        win[m] = f_in[m];
        wk[m] = k_in[m];
        wi[m] = i_in[m];
      } else if (m + 1 < KPL) {  // lane G-1 takes lane 0's next slot
        win[m] = f_in[m + 1];
        wk[m] = k_in[m + 1];
        wi[m] = i_in[m + 1];
      } else {
        win[m] = kNeg;
        wk[m] = 0;
        wi[m] = -1;
      }
      if (lane + G * m >= K) {  // slots past K stay empty
        win[m] = kNeg;
        wk[m] = 0;
        wi[m] = -1;
      }
    }
  }
  // the window now holds positions L+1 .. L+K; the outputs end at L+K-1
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    const int k = lane + G * m;
    if (k < K - 1) {
      dp_row[L + 1 + k] = win[m];
      bk_row[L + 1 + k] = wk[m];
      bi_row[L + 1 + k] = wi[m];
    }
  }
}

template <int G, int KPL>
cudaError_t launch(const float* S, const int* I, float* dp, int* bk, int* bi, long long B, int L,
                   int K, cudaStream_t stream) {
  const long long rows_per_block = kThreads / G;
  const long long blocks = (B + rows_per_block - 1) / rows_per_block;
  viterbi_dp_kernel<G, KPL><<<(unsigned)blocks, kThreads, 0, stream>>>(S, I, dp, bk, bi, B, L, K);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = success); cudaErrorInvalidValue for K outside
// 1..128 (the wrapper checks first).
extern "C" int zt_viterbi_dp(const float* S, const int* I, float* dp, int* bk, int* bi,
                             long long B, int L, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0) return 0;
  if (K <= 8) return (int)launch<8, 1>(S, I, dp, bk, bi, B, L, K, s);
  if (K <= 16) return (int)launch<16, 1>(S, I, dp, bk, bi, B, L, K, s);
  if (K <= 32) return (int)launch<16, 2>(S, I, dp, bk, bi, B, L, K, s);
  if (K <= 64) return (int)launch<16, 4>(S, I, dp, bk, bi, B, L, K, s);
  if (K <= 128) return (int)launch<16, 8>(S, I, dp, bk, bi, B, L, K, s);
  return (int)cudaErrorInvalidValue;
}
