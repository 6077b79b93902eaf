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
// (>= 1.10 ms at 989 TFLOP/s).
//
// bf16 design: four launches, each a persistent, warp-specialised Hopper
// GEMM on gemm.cuh's ring (one TMA producer thread, a 4-stage mbarrier ring
// of 128-byte swizzled tiles, two consumer warpgroups on wgmma over 64 rows
// each of a 128-row tile), with the work that ran as launches of its own
// moved into epilogues. The consumers hand each finished tile (bias added,
// rounded to bf16) to epilogue warps through one shared-memory buffer
// (tile_full / tile_free mbarriers), so a tile's epilogue runs while the
// consumers multiply the next tile. The epilogue warps are warps 1-3 and a
// fourth warpgroup: 512 threads, 128 registers a thread, which is why the
// tiles are 192 columns wide (96 f32 accumulators a consumer thread).
//   1. gemm_qkv_attention_kernel: x @ [q_h | k_h | v_h], one head's 192
//      columns a tile (wgmma m64n192k16; the wrapper packs W head by head),
//      over tiles of whole surface forms (floor(128 / L) forms; the TMA
//      box's other rows are loaded and unused). The epilogue warps run the
//      attention core of attention.cuh (attention_head: S and PV on
//      mma.sync) on the tile, a form a warp, and write only the head's 64
//      columns of ctx. A CTA walks every head of its row tile in turn and a
//      form stays with one warp for every head, so an all-padding form's
//      mean over all merged value rows (every head's) is summed in shared
//      memory, head by head in order, and written once after the last head.
//      The epilogue warps alone fall behind the products, so the consumer
//      warps run the core of the tile's last 2/9 of forms right after they
//      hand it over. The (M, 3H) q/k/v intermediate and the core's launch
//      are gone. Past L 8 the core does not fit 128 registers beside the
//      consumers' state: 384 threads (three epilogue warps, 168 registers).
//   2. gemm_ln_kernel (ctx @ Wo + bo + x, LN1 -> y1) and
//   4. gemm_ln_kernel (mid @ W2 + b2 + y1, LN2 -> out): the residual
//      LayerNorm needs whole rows of H, so a thread-block cluster of
//      ceil(H / 192) CTAs (4 at H 768; 6 at most, since this route takes
//      at most kFusedMaxHeads = 16 heads of 64) runs the mainloop on its 192-column slice of
//      the same 128 rows. The tile buffer takes the residual by TMA, the
//      consumers add it in place and reduce each row's f32 sum and sum of
//      squares over their columns (columns past H left out); the epilogue
//      warps push those into every peer's shared memory (DSMEM) behind a
//      remote mbarrier arrive, normalise their own columns in place, store
//      them by TMA and load the next tile's residual. The clusters walk the
//      row tiles in lockstep, rows past M taking part and storing nothing.
//      The two LayerNorm launches and the pre-LN buffer are gone.
//   3. gemm_gelu_kernel (mid = gelu(y1 @ W1 + b1)): the epilogue warps run
//      the f32 tanhf gelu on the tile in place and store it, under the next
//      tile's products (a single consumer-side epilogue kept the tensor
//      cores idle through every tanhf).
// Why not one resident kernel as on the TPU (32-row tiles, every weight in
// VMEM): at H 768 a 64-row tile's x, y1 and one weight stage already exceed
// the SM's 227 KB of shared memory, and at 64 rows a tile the 9.4 MB of
// layer weights would stream from L2 1,792 times (~17 GB). 128-row tiles
// with the epilogues fused keep each GEMM near its rate and leave ctx, y1
// and mid (the FFN's I-wide input) as the only intermediates in device
// memory.
//
// The f32 path keeps seven launches (plain FMA GEMM tiles without TF32, the
// scalar core, one warp a row for each residual LayerNorm), for comparisons
// at full precision.
//
// Head width 128 (the Llama family's hypernets: TinyLlama's H 2048, 16
// heads of 128, I 4096) takes the same seven-launch sequence in bf16, chosen
// by shape before any launch (ops/encoder_layer.py layer_plan, route
// "unfused"): gemm.cuh's bf16 GEMM for [q|k|v] into an (M, 3H) buffer, the
// tensor-core core of attention.cuh at D = 128 (kernel 2's), the out
// projection, a residual LayerNorm kernel (one warp a row, the bf16 residual
// sum rounded as gemm_ln_kernel's epilogue rounds it), the FFN-in GEMM
// (gemm.cuh's, its gelu in the epilogue), the FFN-out GEMM and the second
// LayerNorm. Its four GEMMs run on two-CTA clusters that share each weight
// tile where K is 2048 or more (gemm.cuh: Mistral-7B's, Llama-3-8B's and
// TinyLlama's widths). Why not the
// four fused launches: (1) one head's [q|k|v] is 384 columns, over wgmma's
// N of 256; two n192 accumulators a head would need the 128 x 392 tile (100
// KB) beside the ring in shared memory, which leaves room for two ring
// stages only; (2) a LayerNorm cluster of ceil(2048 / 192) = 11 CTAs is
// over the portable size of 8, and the non-portable 16 must fit one GPC, so
// few such clusters are resident. What it costs at B 16384, L 7: the (M, 3H)
// q/k/v buffer and the two pre-LN buffers cross device memory (~4.2 GB,
// ~1.3 ms at 3.35 TB/s) beside the ~7.7 TFLOP of products (>= 7.8 ms at 989
// TFLOP/s): the route stays compute-bound.
//
// Numerics (pallas_attention.py:39-45, 692-703, 741-744): each projection
// accumulates in f32, is cast to T, and only then adds its bias in T, as
// flax nn.Dense does; gelu runs in f32 on that T value and is cast once;
// a residual sum is rounded to T before the LayerNorm, whose statistics are
// f32 with the fast variance max(0, E[x^2] - mean^2) and 1/sqrt(var + eps)
// multiplied by the scale before it multiplies (x - mean), f32 affine, one
// cast. Only the order of the f32 sums differs from the plain version's.
#include "gemm.cuh"

namespace zt {

// ------------------------------------------------- residual add + LayerNorm
// The seven-launch routes: out = LN(a + b) * scale + bias, one warp per row
// of H values; the sum a + b rounded to T first (the fused epilogue's
// round(round(round(acc) + bias) + residual) with a = round(round(acc) +
// bias) from the GEMM), f32 statistics, one cast.
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
  auto x_at = [&](int t) { return Num<T>::round(Num<T>::to_f(ar[t]) + Num<T>::to_f(br[t])); };
  float sum = 0.0f, sumsq = 0.0f;
  for (int t = lane; t < H; t += 32) {
    const float x = x_at(t);
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
  for (int t = lane; t < H; t += 32)
    orow[t] = Num<T>::from_f((x_at(t) - mean) * (rstd * scale[t]) + shift[t]);
}

template <typename T>
static cudaError_t add_layer_norm(const T* a, const T* b, const float* scale, const float* shift,
                                  T* out, int M, int H, float eps, cudaStream_t s) {
  const int rows_per_block = 8;
  const unsigned grid = (unsigned)((M + rows_per_block - 1) / rows_per_block);
  add_layer_norm_kernel<T><<<grid, rows_per_block * 32, 0, s>>>(a, b, scale, shift, out, M, H,
                                                                eps);
  return cudaGetLastError();
}

// ---------------------------------------------- the three kernels' roles
// Thread 0 is the TMA producer; warpgroups 1 and 2 consume (wgmma over
// their 64 rows of the 128-row tile) and hand the bias-added tile over in
// shared memory; the epilogue warps (warps 1-3, and in the 512-thread
// kernels warpgroup 3 too) finish it from there. One tile buffer: the
// consumers wait for tile_free before they write a tile, the epilogue warps
// for tile_full before they read it, so a tile's epilogue runs under the
// next tile's products. No setmaxnreg: every thread keeps the launch
// bound's registers, 168 at 384 threads (the LayerNorm GEMM's 128
// accumulators a consumer), 128 at 512 (96 accumulators: 192-column tiles).
constexpr int kWideThreads = 512;
constexpr int kEpiBar = 1 + kGemmConsumers;  // named barrier of the epilogue warps

// the epilogue threads of a kernel of `threads` threads: 96 or 224
__host__ __device__ constexpr int epi_threads(int threads) { return threads - 256 - 32; }
// this epilogue thread's index, 0 .. epi_threads - 1 (warps stay whole)
__device__ __forceinline__ int epi_index() {
  return threadIdx.x < 128 ? threadIdx.x - 32 : threadIdx.x - 384 + 96;
}
__device__ __forceinline__ bool is_epi() {
  return (threadIdx.x >= 32 && threadIdx.x < 128) || threadIdx.x >= 384;
}
__device__ __forceinline__ void epi_sync(int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kEpiBar), "r"(n) : "memory");
}
__device__ __forceinline__ void consumer_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}
// both consumer warpgroups
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kEpiBar + 1), "r"(128 * kGemmConsumers) : "memory");
}
__device__ __forceinline__ void tile_handoff_init(uint64_t* tile_full, uint64_t* tile_free) {
  mbar_init(tile_full, kGemmConsumers);  // one arrival a consumer warpgroup
  mbar_init(tile_free, 1);               // the first epilogue thread's
}

// A tile laid out for TMA: 64-column chunks of 128 rows, 128-byte swizzled.
constexpr int kChunk = GM * kEpiCols * 2;  // 16 KB

// Consumer c writes its 64 rows of round(round(acc) + bias) into a chunked
// 128 x BN tile; bias holds whole tiles (zeros past N). The thread's rows
// r and r + 8 share r % 8, so 16-byte unit k of a row sits at k ^ (lane / 4):
// eight offsets serve every store.
template <int BN>
__device__ __forceinline__ void write_chunked(uint8_t* tile, const float (&d)[BN / 2],
                                              const bf16* bias, int n0, int c) {
  const int t128 = threadIdx.x % 128;
  const int frag_col = 2 * (t128 % 4);
  uint8_t* base = tile + (64 * c + 16 * (t128 / 32) + (t128 % 32) / 4) * 128 + 2 * frag_col;
  const int r8 = (t128 % 32) / 4;
#pragma unroll
  for (int j8 = 0; j8 < BN / 8; ++j8) {
    const __nv_bfloat162 bb =
        *reinterpret_cast<const __nv_bfloat162*>(bias + n0 + 8 * j8 + frag_col);
    uint8_t* at = base + (j8 / 8) * kChunk + (((j8 % 8) ^ r8) << 4);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<__nv_bfloat162*>(at + hh * 8 * 128) =
          epilogue_pair(d[4 * j8 + 2 * hh], d[4 * j8 + 2 * hh + 1], bb, 0);
  }
}

// The epilogue warps' TMA store of a chunked tile's first `chunks` chunks
// (rows past M and columns past N clipped); returns in the first epilogue
// thread once the store has read the buffer.
__device__ __forceinline__ void store_chunked(const CUtensorMap* map_o, const uint8_t* tile,
                                              int chunks, int n0, int m0, int n_epi) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by TMA
  epi_sync(n_epi);
  if (threadIdx.x == 32) {
    for (int q = 0; q < chunks; ++q) tma_store_2d(map_o, tile + q * kChunk, n0 + kEpiCols * q, m0);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ------------------------------------ 1. [q|k|v] GEMM + the attention core
constexpr int kQkvN = 3 * kHeadDim;          // a tile's columns: one head's [q | k | v]
constexpr int kTileRS = kQkvN + 8;           // the tile's row stride (400 B: conflict-free
                                             // ldmatrix)
constexpr int kQkvTile = GM * kTileRS * 2;

struct QkvArgs {
  const bf16* bias;     // (3H): [q | k | v]
  const uint8_t* mask;  // (B, L), nonzero = valid key; null: every key is valid
  bf16* ctx;            // (B * L, H)
  int B, L, h, G, K;    // G: surface forms a tile (floor(128 / L)); K = H
};

// Dynamic shared memory at nst ring stages: the ring, the 128 x 192 tile,
// the zero row, and the all-padding sums (G forms x 64 f32), + alignment.
__host__ __device__ inline int qkv_smem(int nst, int G) {
  return nst * (kStageA + Ring<kQkvN>::kStageW) + kQkvTile + zero_bytes(kHeadDim) +
         G * kHeadDim * 4 + 1024;
}

// NK8 = ceil(L / 8) n8 key tiles; Lq = Lk = L, so ceil(L / 16) = ceil(NK8 / 2)
// m16 query tiles.
template <int NK8, int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
gemm_qkv_attention_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_w, QkvArgs p, int nst) {
  constexpr int MQ = (NK8 + 1) / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[GSTAGES], empty[GSTAGES], tile_full, tile_free;
  Ring<kQkvN> ring(align1024(smem_raw), full, empty, nst);
  bf16* tile = reinterpret_cast<bf16*>(ring.end());  // [128][kTileRS]
  bf16* zero = tile + GM * kTileRS;                  // what padded rows read
  float2* pad = reinterpret_cast<float2*>(zero + zero_bytes(kHeadDim) / 2);  // [G][32]

  if (threadIdx.x == 0) {
    tile_handoff_init(&tile_full, &tile_free);
    ring_init(full, empty, nst);
  }
  for (int t = threadIdx.x; t < zero_bytes(kHeadDim) / 2; t += blockDim.x)
    zero[t] = __float2bfloat16_rn(0.0f);
  __syncthreads();

  const int m_tiles = (p.B + p.G - 1) / p.G;
  const int rows = p.G * p.L;  // a tile's rows: whole surface forms
  const int kblocks = (p.K + GK - 1) / GK;
  const int H = p.h * kHeadDim, L = p.L;

  // The core of forms [0, ge) runs in the epilogue warps; that of the tile's
  // last 2/9 of forms in the consumer warps, right after they hand the tile
  // over (the epilogue warps alone fall behind the products). A form keeps
  // its warp for every head, so an all-padding form's sum is added head by
  // head, in order, in one place.
  const int ge = p.G - 2 * p.G / 9;
  AttnArgs a = {};  // no key bias, no dropout
  a.h = p.h;
  const float w_uniform = Num<bf16>::round(1.0f / (float)(L * p.h));
  const int lane = threadIdx.x % 32;
  // the valid keys of forms f0, f0 + step, ... < f1 of row tile mt, the same
  // for every head: lane i holds the i-th form's
  auto form_masks = [&](int mt, int f0, int f1, int step) {
    unsigned mine = 0;
    for (int f = f0, i = 0; f < f1 && i < 32; f += step, ++i) {
      const int b = mt * p.G + f;
      const bool ok =
          b < p.B && lane < L && (p.mask == nullptr || p.mask[(long long)b * L + lane] != 0);
      const unsigned v = __ballot_sync(0xffffffffu, ok);
      if (lane == i) mine = v;
    }
    return mine;
  };
  // form f of row tile mt through head hd, keys `valid`
  auto run_form = [&](int mt, int hd, int f, unsigned valid) {
    const int b = mt * p.G + f;
    bf16* hq = tile + f * L * kTileRS;
    bf16* dst = p.ctx + (long long)b * L * H;
    if (valid != 0u) {
      attention_head<MQ, NK8>(a, b, hd, L, L, hq, hq + kHeadDim, hq + 2 * kHeadDim, kTileRS,
                              zero, valid, dst + hd * kHeadDim, H);
      return;
    }
    // no valid key (in every head: the mask is per position): uniform
    // weights over all L*h merged value rows. Lane t sums dims 2t, 2t+1 of
    // this head's values.
    float2 s = make_float2(0.0f, 0.0f);
    for (int j = 0; j < L; ++j) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          hq + j * kTileRS + 2 * kHeadDim + 2 * lane));
      s.x += v.x;
      s.y += v.y;
    }
    float2* acc = pad + f * 32 + lane;
    if (hd > 0) s = make_float2(acc->x + s.x, acc->y + s.y);
    if (hd < p.h - 1) {
      *acc = s;
      return;
    }
    const uint32_t o = pack_bf16(s.x * w_uniform, s.y * w_uniform);
    for (int r = 0; r < L; ++r)
      for (int hh = 0; hh < p.h; ++hh)
        *reinterpret_cast<uint32_t*>(dst + (long long)r * H + hh * kHeadDim + 2 * lane) = o;
  };

  if (threadIdx.x == 0) {
    for (int mt = blockIdx.x; mt < m_tiles; mt += gridDim.x)
      for (int hd = 0; hd < p.h; ++hd)
        produce_tile(ring, &map_a, &map_w, mt * rows, hd * kQkvN, 0, kblocks);
  } else if (is_epi()) {
    constexpr int kEpi = epi_threads(kThreads), kWarps = kEpi / 32;
    const int warp = epi_index() / 32;
    unsigned it = 0;
    for (int mt = blockIdx.x; mt < m_tiles; mt += gridDim.x) {
      const unsigned mine = form_masks(mt, warp, ge, kWarps);
      for (int hd = 0; hd < p.h; ++hd, ++it) {
        mbar_wait(&tile_full, it & 1);
        for (int f = warp, i = 0; f < ge && mt * p.G + f < p.B; f += kWarps, ++i)
          run_form(mt, hd, f, __shfl_sync(0xffffffffu, mine, i));
        epi_sync(kEpi);
        if (threadIdx.x == 32) mbar_arrive(&tile_free);
      }
    }
  } else if (threadIdx.x >= 128) {
    const int c = threadIdx.x / 128 - 1, warp = (threadIdx.x - 128) / 32;
    const int t128 = threadIdx.x % 128;
    const int frag_row = 64 * c + 16 * (t128 / 32) + (t128 % 32) / 4;  // within the tile
    const int frag_col = 2 * (t128 % 4);
    constexpr int kWarps = 4 * kGemmConsumers;
    float d[kQkvN / 2];
    unsigned it = 0;
    for (int mt = blockIdx.x; mt < m_tiles; mt += gridDim.x) {
      const unsigned mine = form_masks(mt, ge + warp, p.G, kWarps);
      for (int hd = 0; hd < p.h; ++hd, ++it) {
        consume_tile(ring, d, c, kblocks);
        consumers_sync();                     // every consumer warp is done with its forms
        mbar_wait(&tile_free, (it & 1) ^ 1);  // and the epilogue warps with theirs
        const bf16* bias = p.bias + hd * kHeadDim;  // + 0, H, 2H: q, k, v
#pragma unroll
        for (int j8 = 0; j8 < kQkvN / 8; ++j8) {
          const int col = 8 * j8 + frag_col;
          const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(
              bias + (j8 / 8) * H + col % kHeadDim);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<__nv_bfloat162*>(tile + (frag_row + 8 * hh) * kTileRS + col) =
                epilogue_pair(d[4 * j8 + 2 * hh], d[4 * j8 + 2 * hh + 1], bb, 0);
        }
        consumers_sync();  // both halves of the tile are written
        if (t128 == 0) mbar_arrive(&tile_full);
        for (int f = ge + warp, i = 0; f < p.G && mt * p.G + f < p.B; f += kWarps, ++i)
          run_form(mt, hd, f, __shfl_sync(0xffffffffu, mine, i));
      }
    }
  }
}

// 512 threads (seven epilogue warps) up to L 8; past it the core of more
// than one n8 key tile, run by the consumer warps too, needs more than the
// 512-thread bound's 128 registers, so 384 threads (three epilogue warps,
// 168 registers).
template <int NK8>
static cudaError_t launch_qkv_attention(const CUtensorMap& map_a, const CUtensorMap& map_w,
                                        const QkvArgs& p, int nst, int smem, int grid,
                                        cudaStream_t s) {
  constexpr int kThreads = NK8 == 1 ? kWideThreads : kGemmTcThreads;
  const cudaError_t err =
      cudaFuncSetAttribute(gemm_qkv_attention_kernel<NK8, kThreads>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gemm_qkv_attention_kernel<NK8, kThreads><<<grid, kThreads, smem, s>>>(map_a, map_w, p, nst);
  return cudaGetLastError();
}

// The fused route's heads: past 16 heads of 64 a LayerNorm cluster would
// be ceil(H / 192) = 11 CTAs or more, over the portable 8
// (ops/encoder_layer.py layer_plan refuses such layers by name).
constexpr int kFusedMaxHeads = 16;

// x (M, H), w_qkv (3H, H) head by head: rows [192 hd, 192 hd + 192) are
// head hd's q, k and v output columns, transposed.
static cudaError_t qkv_attention(const bf16* x, const bf16* w_qkv, const QkvArgs& p,
                                 cudaStream_t s) {
  const int H = p.h * kHeadDim;
  if (p.L < 1 || p.L > 32 || p.h < 1 || p.h > kFusedMaxHeads || p.G != GM / p.L || p.K != H)
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = gemm_setup(&sms);
  if (err != cudaSuccess) return err;
  // four ring stages where the all-padding sums leave room (L >= 3), else
  // three; + the static barriers
  const int nst = qkv_smem(GSTAGES, p.G) + (int)((2 * GSTAGES + 2) * sizeof(uint64_t)) <=
                          kAttnSmemMax
                      ? GSTAGES
                      : GSTAGES - 1;
  const int smem = qkv_smem(nst, p.G);
  CUtensorMap map_a, map_w;
  if (!tile_map(&map_a, x, p.B * p.L, H, GM) || !tile_map(&map_w, w_qkv, 3 * H, H, kQkvN))
    return cudaErrorInvalidValue;
  const int m_tiles = (p.B + p.G - 1) / p.G;
  const int grid = m_tiles < sms ? m_tiles : sms;
  switch ((p.L + 7) / 8) {
    case 1: return launch_qkv_attention<1>(map_a, map_w, p, nst, smem, grid, s);
    case 2: return launch_qkv_attention<2>(map_a, map_w, p, nst, smem, grid, s);
    case 3: return launch_qkv_attention<3>(map_a, map_w, p, nst, smem, grid, s);
    default: return launch_qkv_attention<4>(map_a, map_w, p, nst, smem, grid, s);
  }
}

// ---------------------------------------------- 3. GEMM + tanh-gelu (FFN in)
// The fused route's FFN in: 128 x 192 tiles, n-fastest (96 accumulators a
// consumer: the 512-thread bound's 128 registers); the epilogue warps run
// the gelu on the chunked tile in place and store it. The bias holds whole
// tiles, zeros past N (the wrapper pads it), so the consumers load it
// unguarded. The seven-launch route's FFN in runs gemm.cuh's
// gemm_bf16_kernel with its gelu epilogue instead: at Mistral-7B's and
// TinyLlama's widths its 256-column tiles on two-CTA clusters beat these
// 192-column ones (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
constexpr int kGeluN = 192;
constexpr int kGeluSmem =
    GSTAGES * (kStageA + Ring<kGeluN>::kStageW) + (kGeluN / kEpiCols) * kChunk + 1024;

__global__ void __launch_bounds__(kWideThreads, 1)
gemm_gelu_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_c, const bf16* __restrict__ bias, int M,
                 int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[GSTAGES], empty[GSTAGES], tile_full, tile_free;
  Ring<kGeluN> ring(align1024(smem_raw), full, empty, GSTAGES);
  uint8_t* tile = ring.end();
  if (threadIdx.x == 0) {
    tile_handoff_init(&tile_full, &tile_free);
    ring_init(full, empty, GSTAGES);
  }
  __syncthreads();
  const int n_tiles = (N + kGeluN - 1) / kGeluN;
  const int tiles = ((M + GM - 1) / GM) * n_tiles;
  const int kblocks = (K + GK - 1) / GK;

  if (threadIdx.x == 0) {
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      produce_tile(ring, &map_a, &map_w, (t / n_tiles) * GM, (t % n_tiles) * kGeluN, 0, kblocks);
  } else if (is_epi()) {
    constexpr int kEpi = epi_threads(kWideThreads);
    const int e = epi_index();
    unsigned it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const int m0 = (t / n_tiles) * GM, n0 = (t % n_tiles) * kGeluN;
      const int chunks = (min(N - n0, kGeluN) + kEpiCols - 1) / kEpiCols;
      mbar_wait(&tile_full, it & 1);
      // elementwise: the swizzle does not matter; 16 bytes a step
      uint4* v = reinterpret_cast<uint4*>(tile);
      for (int u = e; u < chunks * (kChunk / 16); u += kEpi) {
        uint4 w = v[u];
        uint32_t* h2 = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h2[i]));
          h2[i] = pack_bf16(gelu_f(f.x), gelu_f(f.y));
        }
        v[u] = w;
      }
      store_chunked(&map_c, tile, chunks, n0, m0, kEpi);
      if (threadIdx.x == 32) mbar_arrive(&tile_free);
    }
    if (threadIdx.x == 32) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  } else if (threadIdx.x >= 128) {
    const int c = threadIdx.x / 128 - 1;
    float d[kGeluN / 2];
    unsigned it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      consume_tile(ring, d, c, kblocks);
      mbar_wait(&tile_free, (it & 1) ^ 1);
      write_chunked<kGeluN>(tile, d, bias, (t % n_tiles) * kGeluN, c);
      consumer_sync(c);
      if (threadIdx.x % 128 == 0) mbar_arrive(&tile_full);
    }
  }
}

static cudaError_t gemm_gelu(const bf16* A, const bf16* Wt, const bf16* bias, bf16* C, int M,
                             int N, int K, cudaStream_t s) {
  if (M < 1 || N < 8 || K < 8 || N % 8 || K % 8) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = gemm_setup(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGeluSmem);
  if (err != cudaSuccess) return err;
  CUtensorMap map_a, map_w, map_c;
  if (!tile_map(&map_a, A, M, K, GM) || !tile_map(&map_w, Wt, N, K, kGeluN) ||
      !tile_map(&map_c, C, M, N, GM))
    return cudaErrorInvalidValue;
  const int tiles = ((M + GM - 1) / GM) * ((N + kGeluN - 1) / kGeluN);
  const int grid = tiles < sms ? tiles : sms;
  gemm_gelu_kernel<<<grid, kWideThreads, kGeluSmem, s>>>(map_a, map_w, map_c, bias, M, N, K);
  return cudaGetLastError();
}

// ------------------------- 2 and 4. GEMM + residual + LayerNorm, clustered
// A row's H columns over a cluster of ceil(H / 192) CTAs, each a 192-column
// slice (the 512-thread layout of the gelu GEMM): 4 at H 768, 6 at most
// (H <= 1024, 16 heads of 64), within the portable cluster size of 8.
constexpr int kLnN = 192;
constexpr int kMaxCluster = 6;

struct LnArgs {
  const bf16* bias;      // (N)
  const bf16* residual;  // (M, N)
  const float* scale;    // (N)
  const float* shift;    // (N)
  bf16* out;             // (M, N)
  int M, N, K;
  float eps;
};

// Shared memory: the ring; the chunked tile, which takes the residual (TMA),
// then the pre-LN sum, then the output (TMA store); the consumers' row
// partials (sum, sum of squares) over this CTA's columns, [128]; each row's
// (mean, rstd), [128]; every CTA's partials, [tile parity][rank][128]; this
// CTA's 192 columns of bias (bf16), scale and shift (f32).
constexpr int kLnPart = GM * (int)sizeof(float2);
constexpr int kLnRed = 2 * kMaxCluster * kLnPart;
constexpr int kLnParams = kLnN * (2 + 4 + 4);
constexpr int kLnSmem = GSTAGES * (kStageA + Ring<kLnN>::kStageW) +
                        (kLnN / kEpiCols) * kChunk + 2 * kLnPart + kLnRed + kLnParams + 1024;

__global__ void __launch_bounds__(kWideThreads, 1)
gemm_ln_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_r, const __grid_constant__ CUtensorMap map_o,
               LnArgs p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[GSTAGES], empty[GSTAGES];
  __shared__ __align__(8) uint64_t res_full, tile_full, stat[2];  // stat: [tile parity]
  Ring<kLnN> ring(align1024(smem_raw), full, empty, GSTAGES);
  uint8_t* tile = ring.end();
  float2* part = reinterpret_cast<float2*>(tile + (kLnN / kEpiCols) * kChunk);  // [128]
  float2* rowstat = part + GM;                                                  // [128]
  float2* red = rowstat + GM;  // [2][kMaxCluster][128]
  bf16* bias_s = reinterpret_cast<bf16*>(red + 2 * kMaxCluster * GM);
  float* scale_s = reinterpret_cast<float*>(bias_s + kLnN);
  float* shift_s = scale_s + kLnN;

  constexpr int kEpi = epi_threads(kWideThreads);
  const uint32_t rank = cluster_reg(0), csize = cluster_reg(1);
  const int cid = (int)cluster_reg(2), nclusters = (int)cluster_reg(3);
  const int n0 = (int)rank * kLnN;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(&stat[i], kEpi * csize);
    mbar_init(&res_full, 1);
    mbar_init(&tile_full, kGemmConsumers);
    ring_init(full, empty, GSTAGES);  // its fence publishes these inits to the cluster too
  }
  for (int i = threadIdx.x; i < kLnN; i += blockDim.x) {
    const bool in = n0 + i < p.N;
    bias_s[i] = in ? p.bias[n0 + i] : __float2bfloat16_rn(0.0f);
    scale_s[i] = in ? p.scale[n0 + i] : 0.0f;
    shift_s[i] = in ? p.shift[n0 + i] : 0.0f;
  }
  __syncthreads();
  cluster_sync();  // every peer's barriers are initialised before a remote arrive

  const int m_tiles = (p.M + GM - 1) / GM;
  const int kblocks = (p.K + GK - 1) / GK;
  const int chunks = (min(p.N - n0, kLnN) + kEpiCols - 1) / kEpiCols;  // this slice's, 1..3

  if (threadIdx.x == 0) {
    for (int mt = cid; mt < m_tiles; mt += nclusters)
      produce_tile(ring, &map_a, &map_w, mt * GM, n0, 0, kblocks);
  } else if (is_epi()) {
    // the epilogue warps: the tile's residual into the buffer (the first
    // tile's here, each next one's once the last output has left it);
    // exchange the row partials in the cluster; normalise and store this
    // CTA's columns
    const int e = epi_index();
    const float inv_n = 1.0f / (float)p.N;
    auto load_residual = [&](int mt) {
      mbar_expect_tx(&res_full, chunks * kChunk);
      for (int q = 0; q < chunks; ++q)
        tma_load_2d(tile + q * kChunk, &map_r, &res_full, n0 + kEpiCols * q, mt * GM);
    };
    if (threadIdx.x == 32 && cid < m_tiles) load_residual(cid);
    unsigned it = 0;
    for (int mt = cid; mt < m_tiles; mt += nclusters, ++it) {
      mbar_wait(&tile_full, it & 1);
      const int par = it & 1;
      float2* mine = red + par * kMaxCluster * GM;
      // push this CTA's row partials into slot `rank` of every CTA of the
      // cluster (this one too), then arrive there
      for (int r = e; r < GM; r += kEpi) {
        const uint32_t slot = smem_u32(mine + rank * GM + r);
        for (uint32_t q = 0; q < csize; ++q) st_cluster_f2(map_rank(slot, q), part[r]);
      }
      for (uint32_t q = 0; q < csize; ++q) mbar_arrive_cluster(map_rank(smem_u32(&stat[par]), q));
      mbar_wait_cluster(&stat[par], (it >> 1) & 1);
      for (int r = e; r < GM; r += kEpi) {
        float s = 0.0f, s2 = 0.0f;
        for (uint32_t q = 0; q < csize; ++q) {  // in rank order: the same sum in every CTA
          const float2 v = mine[q * GM + r];
          s += v.x;
          s2 += v.y;
        }
        const float mean = s * inv_n;
        const float var = fmaxf(0.0f, s2 * inv_n - mean * mean);
        rowstat[r] = make_float2(mean, 1.0f / sqrtf(var + p.eps));
      }
      epi_sync(kEpi);
      // 16 bytes (8 columns of a row) a step; chunk q's row r holds logical
      // 16-byte unit k at physical unit k ^ (r % 8)
      for (int u = e; u < chunks * (kChunk / 16); u += kEpi) {
        const int q = u / (kChunk / 16), r = (u / 8) % GM;
        const int col = kEpiCols * q + 8 * ((u % 8) ^ (r % 8));
        uint4* ptr = reinterpret_cast<uint4*>(tile) + u;
        uint4 w = *ptr;
        uint32_t* h2 = reinterpret_cast<uint32_t*>(&w);
        const float2 st = rowstat[r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 s = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h2[i]));
          const float2 sc = *reinterpret_cast<const float2*>(scale_s + col + 2 * i);
          const float2 sh = *reinterpret_cast<const float2*>(shift_s + col + 2 * i);
          h2[i] = pack_bf16((s.x - st.x) * (st.y * sc.x) + sh.x,
                            (s.y - st.x) * (st.y * sc.y) + sh.y);
        }
        *ptr = w;
      }
      store_chunked(&map_o, tile, chunks, n0, mt * GM, kEpi);
      if (threadIdx.x == 32 && mt + nclusters < m_tiles) load_residual(mt + nclusters);
    }
    if (threadIdx.x == 32) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  } else if (threadIdx.x >= 128) {
    const int c = threadIdx.x / 128 - 1;
    const int t128 = threadIdx.x % 128;
    const int frag_col = 2 * (t128 % 4);
    const int row = 64 * c + 16 * (t128 / 32) + (t128 % 32) / 4;  // and row + 8
    // rows row and row + 8 share row % 8: unit k of either sits at k ^ (row % 8)
    uint8_t* base = tile + row * 128 + 2 * frag_col;
    float d[kLnN / 2];
    unsigned it = 0;
    for (int mt = cid; mt < m_tiles; mt += nclusters, ++it) {
      consume_tile(ring, d, c, kblocks);
      mbar_wait(&res_full, it & 1);  // the residual (so the last output has left the buffer)
      // s = round(round(round(acc) + bias) + residual) in place of the
      // residual; the row's f32 sum and sum of squares over the columns < N
      // (chunks past N are not loaded, columns past N neither summed nor
      // stored)
      float sum[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j8 = 0; j8 < kLnN / 8; ++j8) {
        const int col = 8 * j8 + frag_col;  // within the slice; N is even: col + 1 too
        const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias_s + col);
        uint8_t* at = base + (j8 / 8) * kChunk + (((j8 % 8) ^ (row % 8)) << 4);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          __nv_bfloat162* ps = reinterpret_cast<__nv_bfloat162*>(at + hh * 8 * 128);
          const __nv_bfloat162 s2 =
              __hadd2(epilogue_pair(d[4 * j8 + 2 * hh], d[4 * j8 + 2 * hh + 1], bb, 0), *ps);
          *ps = s2;
          if (n0 + col < p.N) {
            const float2 s = __bfloat1622float2(s2);
            sum[hh] += s.x + s.y;
            sq[hh] += s.x * s.x + s.y * s.y;
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], o);
          sq[hh] += __shfl_xor_sync(0xffffffffu, sq[hh], o);
        }
        if (t128 % 4 == 0) part[row + 8 * hh] = make_float2(sum[hh], sq[hh]);
      }
      consumer_sync(c);
      if (t128 == 0) mbar_arrive(&tile_full);
    }
  }
  __syncwarp();
  cluster_sync();  // no CTA leaves while a peer may still write its shared memory
}

// gemm_ln_kernel's launch at csize CTAs a cluster, and how many such
// clusters the card holds at once (fit).
static cudaError_t ln_config(int csize, cudaStream_t s, cudaLaunchAttribute* attr,
                             cudaLaunchConfig_t* cfg, int* fit) {
  if (csize < 1 || csize > kMaxCluster) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_ln_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kLnSmem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)csize);
  cfg->blockDim = dim3(kWideThreads);
  cfg->dynamicSmemBytes = kLnSmem;
  cfg->stream = s;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(fit, gemm_ln_kernel, cfg);
  if (err != cudaSuccess) return err;
  return *fit < 1 ? cudaErrorInvalidValue : cudaSuccess;
}

// A (M, K) @ Wt (N, K)^T + bias + residual, LayerNorm over each row of N:
// csize = ceil(N / 192) CTAs a cluster, one a 192-column slice.
static cudaError_t gemm_ln(const bf16* A, const bf16* Wt, const LnArgs& p, int csize,
                           cudaStream_t s) {
  if (p.M < 1 || p.N < 8 || p.K < 8 || p.N % 8 || p.K % 8 || (p.N + kLnN - 1) / kLnN != csize)
    return cudaErrorInvalidValue;
  int sms = 0, fit = 0;  // fit: clusters resident at once
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t err = gemm_setup(&sms);
  if (err == cudaSuccess) err = ln_config(csize, s, attr, &cfg, &fit);
  if (err != cudaSuccess) return err;
  CUtensorMap map_a, map_w, map_r, map_o;
  if (!tile_map(&map_a, A, p.M, p.K, GM) || !tile_map(&map_w, Wt, p.N, p.K, kLnN) ||
      !tile_map(&map_r, p.residual, p.M, p.N, GM) || !tile_map(&map_o, p.out, p.M, p.N, GM))
    return cudaErrorInvalidValue;
  const int m_tiles = (p.M + GM - 1) / GM;
  cfg.gridDim = dim3((unsigned)((m_tiles < fit ? m_tiles : fit) * csize));
  err = cudaLaunchKernelEx(&cfg, gemm_ln_kernel, map_a, map_w, map_r, map_o, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------- the layer
static cudaError_t encoder_layer_bf16(const bf16* x, const uint8_t* mask, int B, int L, int H,
                                      int nh, int I, int G, int csize, const bf16* w_qkv,
                                      const bf16* b_qkv, const bf16* wo_t, const bf16* bo,
                                      const float* ln1s, const float* ln1b, const bf16* w1_t,
                                      const bf16* b1, const bf16* w2_t, const bf16* b2,
                                      const float* ln2s, const float* ln2b, float eps,
                                      bf16* ctx, bf16* y1, bf16* mid, bf16* out, cudaStream_t s) {
  const int M = B * L;
  if (H != nh * kHeadDim) return cudaErrorInvalidValue;
  cudaError_t err;
#define ZT_TRY(call)          \
  err = (call);               \
  if (err != cudaSuccess) return err;
  QkvArgs q = {b_qkv, mask, ctx, B, L, nh, G, H};
  ZT_TRY(qkv_attention(x, w_qkv, q, s));
  LnArgs ln1 = {bo, x, ln1s, ln1b, y1, M, H, H, eps};
  ZT_TRY(gemm_ln(ctx, wo_t, ln1, csize, s));
  ZT_TRY(gemm_gelu(y1, w1_t, b1, mid, M, I, H, s));
  LnArgs ln2 = {b2, y1, ln2s, ln2b, out, M, H, I, eps};
  ZT_TRY(gemm_ln(mid, w2_t, ln2, csize, s));
#undef ZT_TRY
  return cudaSuccess;
}

// The seven launches (f32 at any supported head width; bf16 at head width
// 128): mask (B, L) f32, > 0 = valid; qkv (M, 3H), ctx, tmp, y1 (M, H), mid
// (M, I) scratch. The FFN-in GEMM runs its GEMM's gelu epilogue (bf16:
// gemm_bf16_kernel, act 1).
template <typename T>
static cudaError_t encoder_layer_unfused(const T* x, const float* mask, int B, int L, int H,
                                         int nh, int I, const T* wqkv_t, const T* bqkv,
                                         const T* wo_t, const T* bo, const float* ln1s,
                                         const float* ln1b, const T* w1_t, const T* b1,
                                         const T* w2_t, const T* b2, const float* ln2s,
                                         const float* ln2b, float eps, T* qkv, T* ctx, T* tmp,
                                         T* y1, T* mid, T* out, cudaStream_t s) {
  const int M = B * L;
  if (nh < 1 || H % nh) return cudaErrorInvalidValue;
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
  ZT_TRY(launch_attention_d<T>(a, H / nh, s));
  ZT_TRY(gemm<T>(ctx, wo_t, bo, tmp, M, H, H, 0, s));
  ZT_TRY(add_layer_norm<T>(tmp, x, ln1s, ln1b, y1, M, H, eps, s));
  ZT_TRY(gemm<T>(y1, w1_t, b1, mid, M, I, H, 1, s));
  ZT_TRY(gemm<T>(mid, w2_t, b2, tmp, M, H, I, 0, s));
  ZT_TRY(add_layer_norm<T>(tmp, y1, ln2s, ln2b, out, M, H, eps, s));
#undef ZT_TRY
  return cudaSuccess;
}

}  // namespace zt

// Return a cudaError_t (0 = success).
//
// bf16: four launches, tanh-gelu. w_qkv (3H, H) head by head (rows [192 hd, 192 hd +
// 192): head hd's q, k, v columns, transposed), b_qkv (3H) as [q | k | v];
// b1 (ceil(I / 192) * 192) any values past I;
// wo_t (H, H), w1_t (I, H), w2_t (H, I) transposed; mask (B, L) bytes,
// nonzero = valid (null: all valid); G = 128 / L surface forms a [q|k|v]
// tile, csize = ceil(H / 256) CTAs a LayerNorm cluster; H = 64 nh, nh <= 16,
// I % 8 == 0.
extern "C" int zt_encoder_layer_bf16(const void* x, const uint8_t* mask, int B, int L, int H,
                                     int nh, int I, int G, int csize, const void* w_qkv,
                                     const void* b_qkv, const void* wo_t, const void* bo,
                                     const float* ln1s, const float* ln1b, const void* w1_t,
                                     const void* b1, const void* w2_t, const void* b2,
                                     const float* ln2s, const float* ln2b, float eps,
                                     void* ctx, void* y1, void* mid, void* out, void* stream) {
  using T = zt::bf16;
  return (int)zt::encoder_layer_bf16(
      (const T*)x, mask, B, L, H, nh, I, G, csize, (const T*)w_qkv, (const T*)b_qkv,
      (const T*)wo_t, (const T*)bo, ln1s, ln1b, (const T*)w1_t, (const T*)b1, (const T*)w2_t,
      (const T*)b2, ln2s, ln2b, eps, (T*)ctx, (T*)y1, (T*)mid, (T*)out, (cudaStream_t)stream);
}

// The LayerNorm GEMM's clusters of csize CTAs that the card holds at once
// (each walks row tiles in turn), or minus a cudaError_t.
extern "C" int zt_encoder_layer_ln_clusters(int csize) {
  int fit = 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  const cudaError_t err = zt::ln_config(csize, 0, attr, &cfg, &fit);
  return err == cudaSuccess ? fit : -(int)err;
}

// The seven launches; dtype: 0 = float32, 1 = bfloat16 (head width 128).
// Weights transposed, row-major: wqkv_t (3H, H) as [q | k | v], wo_t (H, H),
// w1_t (I, H), w2_t (H, I); mask (B, L) f32, > 0 = valid; b1 (I). tanh-gelu.
extern "C" int zt_encoder_layer_unfused(int dtype, const void* x, const float* mask, int B, int L,
                                        int H, int nh, int I, const void* wqkv_t,
                                        const void* bqkv, const void* wo_t, const void* bo,
                                        const float* ln1s, const float* ln1b, const void* w1_t,
                                        const void* b1, const void* w2_t, const void* b2,
                                        const float* ln2s, const float* ln2b, float eps,
                                        void* qkv, void* ctx, void* tmp, void* y1, void* mid,
                                        void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    using T = zt::bf16;
    return (int)zt::encoder_layer_unfused<T>(
        (const T*)x, mask, B, L, H, nh, I, (const T*)wqkv_t, (const T*)bqkv, (const T*)wo_t,
        (const T*)bo, ln1s, ln1b, (const T*)w1_t, (const T*)b1, (const T*)w2_t, (const T*)b2,
        ln2s, ln2b, eps, (T*)qkv, (T*)ctx, (T*)tmp, (T*)y1, (T*)mid, (T*)out, s);
  }
  using F = float;
  return (int)zt::encoder_layer_unfused<F>(
      (const F*)x, mask, B, L, H, nh, I, (const F*)wqkv_t, (const F*)bqkv, (const F*)wo_t,
      (const F*)bo, ln1s, ln1b, (const F*)w1_t, (const F*)b1, (const F*)w2_t, (const F*)b2, ln2s,
      ln2b, eps, (F*)qkv, (F*)ctx, (F*)tmp, (F*)y1, (F*)mid, (F*)out, s);
}

// The walk of the persistent bf16 GEMM (gemm.cuh gemm_bf16_kernel, its
// GemmOrder) for (M, N, K). out[7]: m_tiles, n_tiles, cluster, groups,
// tiles, the clusters resident at once and the CTAs a launch runs. Returns
// a cudaError_t.
extern "C" int zt_gemm_order(int M, int N, int K, int* out) {
  zt::GemmOrder o;
  int clusters = 0;
  const cudaError_t err = zt::gemm_bf16_plan(M, N, K, &o, &clusters);
  if (err != cudaSuccess) return (int)err;
  const int vals[7] = {o.m_tiles, o.n_tiles, o.cluster, o.groups, o.tiles,
                       zt::gemm_bf16_fit[o.cluster], clusters * o.cluster};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}
