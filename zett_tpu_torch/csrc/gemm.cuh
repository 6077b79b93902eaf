// Row-major GEMM with a fused bias (and optional tanh-gelu) epilogue, used
// by attention_block.cu (kernel 4) and, for its f32 path, encoder_layer.cu
// (kernel 1); and the pieces of its bf16 pipeline that kernel 1's fused
// kernels are built from: the ring (Ring, ring_init), its producer
// (produce_tile) and consumer (consume_tile) over a BN-wide weight tile, BN
// 256 (wgmma m64n256k16) or 192 (m64n192k16: one head's [q | k | v]).
//
// C[M, N] = epilogue(A[M, K] @ Wt[N, K]^T): A row-major, the weight given
// transposed (N, K), K contiguous (PyTorch's Linear layout; the wrappers
// repack W (K, N) every call, so weights updated in place are never stale).
//
// bf16 runs on Hopper's tensor cores: a persistent, warp-specialised kernel.
// One block per SM walks 128 x 256 output tiles n-fastest (GemmOrder,
// below), on clusters of two CTAs that share each weight tile where K is
// long. Warpgroup 0's first thread is the producer: TMA brings 128 x 64
// tiles of A and 256 x 64 tiles of Wt, 128-byte swizzled, into a ring of 4
// stages guarded by full/empty mbarriers, running ahead across tiles. Warpgroups 1 and 2
// consume: each issues wgmma.mma_async m64n256k16 (bf16 in, f32 accumulate
// in 128 registers a thread; setmaxnreg moves registers from the producer to
// them) over its 64 rows, keeps one k-block's batch in flight and releases
// the stage before it. At the tile's end the epilogue runs in registers, on
// packed bf16 pairs, into 64 x 64 shared-memory chunks (two slots a
// warpgroup, 128-byte swizzled like the loads, so the fragment writes meet
// no bank conflict), and one thread hands each chunk to a TMA store; the
// warpgroup goes on to the next tile's products while the stores drain.
// (With the threads storing the tile themselves, the tensor cores sat idle
// through every epilogue.) N = 256, not 128: one A tile feeds 256 columns,
// so a stage carries 85 operations per byte loaded (64 at N = 128), and each
// k16 step reads 80 B/clock of shared memory, under the SM's 128. Ragged
// edges: TMA zero-fills the rows of A past M, the rows of Wt past N and the
// columns of both past K (a product over zero-filled K columns is exact),
// the epilogue reads no bias past N and skips chunks wholly past it, and the
// TMA store clips rows past M and columns past N. Needs rows of whole
// 16-byte units (N % 8 == 0, K % 8 == 0: TMA's stride rule) and 16-byte
// aligned A, Wt and C.
//
// Weights larger than L2 (the 7-8B hypernets' GEMMs serve _layer_kernel,
// zett_tpu/ops/pallas_attention.py:727, through kernel 1's seven launches,
// and _block_kernel, :530, through kernel 4). What bounds a GEMM here is
// the tensor cores' 989 TFLOP/s, as long as L2 keeps them fed. At
// Mistral-7B's widths each stage of a CTA brought 48 KB from L2 for 4.2
// MFLOP (85 operations a byte: 11.6 TB/s out of L2 at the tensor cores'
// rate). A cluster of two CTAs on neighbouring row tiles of the same N tile
// shares the weight tile: rank r loads half r (128 rows) and multicasts it
// into both CTAs, each loads its own A tile, so a CTA brings 32 KB a stage
// (128 operations a byte). A stage's full barrier in each CTA expects its A
// tile and both halves; its empty barrier counts both CTAs' consumer
// warpgroups, since either producer's half lands in both. The last row tile
// of an odd count has a peer past M: that CTA loads no A, computes on what
// the stage holds and stores nothing, so the pair stays in lockstep. Every
// product sums the same k blocks in the same order with the same epilogue
// as the single-CTA kernel: the outputs are bit-equal whatever the cluster.
// The weight itself (W_qkv 100.7 MB, W1 and W2 67.1 MB against 50 MB of
// L2) streams from device memory again every wave of tiles in the
// n-fastest walk; a walk in weight bands that stay in L2 was measured
// against it and gained 1-2% at the layer, less than the rounds' spread,
// and lost at the FFN out (NVIDIA H100 80GB HBM3, 700 W; PERF.md), so the
// walk stays n-fastest.
//
// f32 uses plain FMA tiles (no TF32), for comparisons at full precision.
//
// Numerics (zett_tpu/ops/pallas_attention.py:541-545, 741-744): the product
// accumulates in f32, is cast to T, and only then adds its bias in T, as
// flax nn.Dense does; gelu runs in f32 on that T value and is cast once.
#pragma once

#include "attention.cuh"

#include <cuda.h>
#include <dlfcn.h>
#include <stdint.h>

namespace zt {

using bf16 = __nv_bfloat16;

// tanh approximation (flax nn.gelu's default, the hypernet's gelu_new)
__device__ __forceinline__ float gelu_f(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float cdf = 0.5f * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x))));
  return x * cdf;
}

// act: 0 none, 1 tanh-gelu (the f32 path; bf16 is epilogue_pair below)
__device__ __forceinline__ float epilogue_f32(float acc, float bias, int act) {
  const float y = acc + bias;
  return act ? gelu_f(y) : y;
}

// ---------------------------------------------------------------- bf16 GEMM
// The epilogue of two neighbouring accumulators, packed: rounded to bf16,
// the bias pair added in bf16 (one rounding of the exact sum: the f32 sum
// of two bf16 values rounds to the same bf16), tanh-gelu in f32, one cast.
__device__ __forceinline__ __nv_bfloat162 epilogue_pair(float a0, float a1, __nv_bfloat162 bias,
                                                        int act) {
  __nv_bfloat162 y = __hadd2(__floats2bfloat162_rn(a0, a1), bias);
  if (act) {
    const float2 f = __bfloat1622float2(y);
    y = __floats2bfloat162_rn(gelu_f(f.x), gelu_f(f.y));
  }
  return y;
}

constexpr int GM = 128, GN = 256, GK = 64, GSTAGES = 4;
constexpr int kGemmConsumers = 2;                     // warpgroups of 64 rows each
constexpr int kGemmTcThreads = 128 * (1 + kGemmConsumers);
constexpr int kStageA = GM * GK * 2, kStageB = GN * GK * 2;  // bytes
// an epilogue chunk: a consumer's 64 rows x 64 columns, 128-byte swizzled;
// two slots a consumer
constexpr int kEpiCols = 64, kEpiSlot = 64 * kEpiCols * 2;
constexpr int kGemmSmem =
    GSTAGES * (kStageA + kStageB) + kGemmConsumers * 2 * kEpiSlot + 1024;  // + alignment

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// tma_load_2d into the same offset of every CTA of the cluster in `mask`
// (bit q: rank q), completing on the barrier at `bar`'s offset in each
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"((uint64_t)map), "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

// Byte offset of (row, col) in a tile of 64-column bf16 rows, 128-byte
// swizzled as TMA reads and writes it: 16-byte chunk col/8 of row r sits at
// chunk (col/8) ^ (r % 8).
__device__ __forceinline__ int swizzle128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) << 1));
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows,
// 128-byte swizzled (as TMA wrote it): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d[64 x 256] += A[64 x 16] * B[16 x 256], both from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 192] += A[64 x 16] * B[16 x 192]: one head's [q | k | v] (kernel 1)
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_tile<256>(float (&d)[128], uint64_t da, uint64_t db) {
  wgmma_m64n256k16(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_tile<192>(float (&d)[96], uint64_t da, uint64_t db) {
  wgmma_m64n192k16(d, da, db);
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma (their values are defined only after the wait).
template <int N>
__device__ __forceinline__ void fence_accumulators(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 1024-byte aligned start of dynamic shared memory (128-byte swizzled TMA
// tiles want it); the launches reserve 1024 bytes for this.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The ring every Hopper kernel here runs on: nst stages, each a GM x GK
// tile of A and a BN x GK tile of the transposed weight, guarded by
// full/empty mbarriers. The producer thread and each consumer warpgroup
// keep their own copy and walk the same tiles in the same order.
template <int BN>
struct Ring {
  static constexpr int kStageW = BN * GK * 2;  // bytes
  uint8_t* sa;
  uint8_t* sb;
  uint64_t* full;
  uint64_t* empty;
  int nst;
  int stage;
  unsigned phase;
  __device__ __forceinline__ Ring(uint8_t* smem, uint64_t* f, uint64_t* e, int n)
      : sa(smem), sb(smem + n * kStageA), full(f), empty(e), nst(n), stage(0), phase(0) {}
  __device__ __forceinline__ uint8_t* end() const { return sb + nst * kStageW; }
  __device__ __forceinline__ void advance() {
    if (++stage == nst) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// One thread: full counts the producer's arrival, empty both consumers' of
// each of the `peers` CTAs whose producers fill the stage (a cluster).
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty, int nst,
                                          int peers = 1) {
  for (int s = 0; s < nst; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], kGemmConsumers * peers);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// A consumer warpgroup's release of a stage: on its own CTA's empty
// barrier, and in a cluster of cs CTAs on every CTA's (each producer's
// half of the weight tile lands in all of them).
__device__ __forceinline__ void ring_release(uint64_t* empty, int cs) {
  if (cs == 1) {
    mbar_arrive(empty);
    return;
  }
  const uint32_t addr = smem_u32(empty);
  for (int q = 0; q < cs; ++q) mbar_arrive_remote(map_rank(addr, (uint32_t)q));
}

// ------------------------------------------------------------ the tile order
// Clusters of two where K is 2048 or more (and there are two row tiles to
// pair): there a tile's mainloop is long and a stage's L2 bytes are what
// the cluster saves; below it the products are short, the cluster's shared
// pace costs what the shared tile saves, and single CTAs run (measured on
// kernels 1 and 4's GEMMs, NVIDIA H100 80GB HBM3, 700 W: PERF.md).
__host__ __device__ inline int gemm_cluster(int M, int K) {
  return K >= 2048 && (M + GM - 1) / GM >= 2 ? 2 : 1;
}

// gemm_bf16_kernel's walk over its GN-column tiles. A work item is a row
// group (cluster row tiles, one a CTA of the cluster) by an N tile, n
// fastest: item t is group t / n_tiles, N tile t % n_tiles. A cluster
// takes items cid, cid + clusters, ...
struct GemmOrder {
  int m_tiles;  // GM-row tiles of A and C
  int n_tiles;  // GN-column tiles of the weight and C
  int cluster;  // CTAs a cluster: 1, or 2 on neighbouring row tiles
  int groups;   // row groups: ceil(m_tiles / cluster)
  int tiles;    // work items: groups x n_tiles
};

inline GemmOrder gemm_order(int M, int N, int K) {
  GemmOrder o;
  o.m_tiles = (M + GM - 1) / GM;
  o.n_tiles = (N + GN - 1) / GN;
  o.cluster = gemm_cluster(M, K);
  o.groups = (o.m_tiles + o.cluster - 1) / o.cluster;
  o.tiles = o.groups * o.n_tiles;
  return o;
}

// The producer: rows [m0, m0 + GM) of A and [n0, n0 + BN) of the weight,
// over k blocks [kb0, kb1), running ahead of the consumers by the ring's
// depth.
template <int BN>
__device__ __forceinline__ void produce_tile(Ring<BN>& r, const CUtensorMap* map_a,
                                             const CUtensorMap* map_w, int m0, int n0, int kb0,
                                             int kb1) {
  for (int kb = kb0; kb < kb1; ++kb) {
    mbar_wait(&r.empty[r.stage], r.phase ^ 1);
    mbar_expect_tx(&r.full[r.stage], kStageA + Ring<BN>::kStageW);
    tma_load_2d(r.sa + r.stage * kStageA, map_a, &r.full[r.stage], kb * GK, m0);
    tma_load_2d(r.sb + r.stage * Ring<BN>::kStageW, map_w, &r.full[r.stage], kb * GK, n0);
    r.advance();
  }
}

// The producer of a CTA of a two-CTA cluster: rows [m0, m0 + GM) of A into
// this CTA's stage, and half `rank` of the weight tile [n0, n0 + BN) (TMA
// boxes of BN / 2 rows, where one box of BN rows would put them),
// multicast into both CTAs. A row tile wholly past M loads no A (its
// products are never stored), a half wholly past N is not loaded (its
// columns are never stored); both CTAs count the same halves.
template <int BN>
__device__ __forceinline__ void produce_tile_pair(Ring<BN>& r, const CUtensorMap* map_a,
                                                  const CUtensorMap* map_w, int m0, int n0,
                                                  int kblocks, int M, int N, int rank) {
  constexpr int kHalf = Ring<BN>::kStageW / 2;
  const bool a_in = m0 < M;
  const int halves = n0 + BN / 2 < N ? 2 : 1;
  const unsigned bytes = (a_in ? kStageA : 0) + halves * kHalf;
  for (int kb = 0; kb < kblocks; ++kb) {
    mbar_wait(&r.empty[r.stage], r.phase ^ 1);
    mbar_expect_tx(&r.full[r.stage], bytes);
    if (a_in) tma_load_2d(r.sa + r.stage * kStageA, map_a, &r.full[r.stage], kb * GK, m0);
    if (rank < halves)
      tma_load_2d_multicast(r.sb + r.stage * Ring<BN>::kStageW + rank * kHalf, map_w,
                            &r.full[r.stage], kb * GK, n0 + rank * (BN / 2), 0x3);
    r.advance();
  }
}

// Consumer warpgroup c: its 64 rows of the tile into d (f32), one k
// block's wgmma batch in flight, each stage released once the batch after
// it is issued (in a cluster of cs CTAs, to every CTA's producer).
template <int BN>
__device__ __forceinline__ void consume_tile(Ring<BN>& r, float (&d)[BN / 2], int c,
                                             int kblocks, int cs = 1) {
  const int t128 = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
  int held = -1;  // the stage the batch in flight reads
  for (int kb = 0; kb < kblocks; ++kb) {
    mbar_wait(&r.full[r.stage], r.phase);
    fence_accumulators(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint8_t* a = r.sa + r.stage * kStageA + c * 64 * GK * 2;
    const uint8_t* b = r.sb + r.stage * Ring<BN>::kStageW;
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk)  // a k16 step is 32 bytes into the swizzled row
      wgmma_tile<BN>(d, wgmma_desc(a + 32 * kk), wgmma_desc(b + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // the previous batch
    fence_accumulators(d);
    if (held >= 0 && t128 == 0) ring_release(&r.empty[held], cs);
    held = r.stage;
    r.advance();
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_accumulators(d);
  if (t128 == 0) ring_release(&r.empty[held], cs);
}

// One kernel for one CTA a cluster and for two: templated on the cluster
// size, it ran about 1% faster at K 768 on one CTA and 1.1-1.8% slower on
// two at Mistral-7B's widths, where most of its time is (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md).
__global__ void __launch_bounds__(kGemmTcThreads, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_c, const bf16* __restrict__ bias, int M,
                 int N, int K, int act, GemmOrder o) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[GSTAGES], empty[GSTAGES];
  Ring<GN> ring(align1024(smem_raw), full, empty, GSTAGES);
  uint8_t* se = ring.end();  // [consumer][2 slots][64][64], swizzled

  const int wg = threadIdx.x / 128;
  const int cs = o.cluster, rank = (int)cluster_reg(0);
  const int cid = (int)cluster_reg(2), clusters = (int)cluster_reg(3);
  if (threadIdx.x == 0) ring_init(full, empty, GSTAGES, cs);
  __syncthreads();
  // the peer's barriers are initialised before a multicast or a remote
  // arrive reaches them
  if (cs > 1) cluster_sync();

  const int kblocks = (K + GK - 1) / GK;

  if (wg == 0) {
    // producer: one thread keeps the ring full, across tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0)
      for (int t = cid; t < o.tiles; t += clusters) {
        const int m0 = (t / o.n_tiles * cs + rank) * GM, n0 = t % o.n_tiles * GN;
        if (cs == 1)  // one box of GN weight rows, as before the clusters
          produce_tile(ring, &map_a, &map_w, m0, n0, 0, kblocks);
        else
          produce_tile_pair(ring, &map_a, &map_w, m0, n0, kblocks, M, N, rank);
      }
    // no CTA leaves while its peer may still arrive on its barriers
    if (cs > 1) cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;  // this warpgroup's 64 rows of the tile
    const int t128 = threadIdx.x % 128;
    const int frag_row = 16 * (t128 / 32) + (t128 % 32) / 4;  // within the 64
    const int frag_col = 2 * (t128 % 4);
    int chunk = 0;  // epilogue chunks stored so far: their slots alternate
    float d[128];
    for (int t = cid; t < o.tiles; t += clusters) {
      const int m0 = (t / o.n_tiles * cs + rank) * GM, n0 = t % o.n_tiles * GN;
      consume_tile(ring, d, c, kblocks, cs);
      if (m0 + 64 * c >= M) continue;  // rows wholly past M (a pair's odd last tile)
      // accumulator j of m64nNk16: row 8*((j/2)%2) + the thread's row,
      // column 8*(j/4) + (j%2) + the thread's column pair
#pragma unroll
      for (int q = 0; q < GN / kEpiCols; ++q) {
        if (n0 + kEpiCols * q >= N) break;  // the ragged last N tile ends here
        uint8_t* slot = se + (2 * c + (chunk++ & 1)) * kEpiSlot;
        // the store that last read this slot (two chunks back) is done
        if (t128 == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");  // this warpgroup
#pragma unroll
        for (int j = 0; j < kEpiCols / 8; ++j) {
          const int j8 = q * (kEpiCols / 8) + j;
          const int col = 8 * j + frag_col;
          const int gcol = n0 + kEpiCols * q + col;  // N is even: gcol + 1 < N too
          const __nv_bfloat162 bb =
              gcol < N ? *reinterpret_cast<const __nv_bfloat162*>(bias + gcol)
                       : __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<__nv_bfloat162*>(slot + swizzle128(frag_row + 8 * hh, col)) =
                epilogue_pair(d[4 * j8 + 2 * hh], d[4 * j8 + 2 * hh + 1], bb, act);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by TMA
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
        if (t128 == 0) {
          tma_store_2d(&map_c, slot, n0 + kEpiCols * q, m0 + 64 * c);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
    if (t128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    if (cs > 1) cluster_sync();
  }
}

// cuTensorMapEncodeTiled, from the libcuda that the CUDA runtime has
// already loaded (no -lcuda at build time)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Internal linkage (static, not inline) for the function-local statics
// here and in gemm_setup: a static local of an inline function is one
// object across all the libraries of a process (GNU unique), so the first
// library to call would set it for all.
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* cuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (cuda == nullptr) cuda = dlopen("libcuda.so.1", RTLD_NOW);
    if (cuda != nullptr) fn = (EncodeTiledFn)dlsym(cuda, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix read or written in (box_rows, 64)
// tiles, 128-byte swizzled; rows past the end read as zeros and are not
// written.
static bool tile_map(CUtensorMap* map, const bf16* ptr, int rows, int cols, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)GK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)ptr, dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------- f32 GEMM
// Plain FMA tiles 64 x 64 x 16, 4 x 4 outputs per thread (no tensor cores,
// no TF32): the full-precision path. Guarded along M, N and K.
constexpr int kGemmThreads = 256;
constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(kGemmThreads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ Wt,
                const float* __restrict__ bias, float* __restrict__ C, int M, int N, int K,
                int act) {
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
      const bool k_ok = k0 + c < K;
      As[c][r] = (m0 + r < M && k_ok) ? A[(size_t)(m0 + r) * K + k0 + c] : 0.0f;
      Bs[c][r] = (n0 + r < N && k_ok) ? Wt[(size_t)(n0 + r) * K + k0 + c] : 0.0f;
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
      if (col < N) C[(size_t)row * N + col] = epilogue_f32(acc[i][j], bias[col], act);
    }
  }
}

template <typename T>
cudaError_t gemm(const T* A, const T* Wt, const T* bias, T* C, int M, int N, int K, int act,
                 cudaStream_t s);

// The SM count, and this library's kernel's opt-in to its shared memory,
// once.
static cudaError_t gemm_setup(int* sms) {
  static int count = 0;
  if (count == 0) {
    int dev = 0, n = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kGemmSmem);
    if (err != cudaSuccess) return err;
    count = n;
  }
  *sms = count;
  return cudaSuccess;
}

// A launch on clusters of cs CTAs (1 or 2): `clusters` of them.
static void cluster_launch(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int threads,
                           int smem, int cs, int clusters, cudaStream_t s) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(clusters * cs));
  cfg->blockDim = dim3((unsigned)threads);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = s;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The clusters of cs CTAs of `kernel` that the card holds at once, cached
// in *slot (a static of this library's). None fitting is an error: the
// launch is refused, never run another way.
template <typename Kernel>
static cudaError_t resident_clusters(Kernel kernel, int threads, int smem, int cs, int* slot) {
  if (*slot > 0) return cudaSuccess;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch(&cfg, attr, threads, smem, cs, 1, 0);
  int fit = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  *slot = fit;
  return cudaSuccess;
}

static int gemm_bf16_fit[3];  // resident clusters of gemm_bf16_kernel by cluster size

// gemm_bf16_kernel's walk of (M, N, K) and the clusters it launches: those
// resident at once, at most one a work item.
static cudaError_t gemm_bf16_plan(int M, int N, int K, GemmOrder* o, int* clusters) {
  if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  *o = gemm_order(M, N, K);
  const int cs = o->cluster;
  int sms = 0;
  cudaError_t err = gemm_setup(&sms);
  if (err == cudaSuccess)
    err = resident_clusters(gemm_bf16_kernel, kGemmTcThreads, kGemmSmem, cs, &gemm_bf16_fit[cs]);
  if (err != cudaSuccess) return err;
  *clusters = o->tiles < gemm_bf16_fit[cs] ? o->tiles : gemm_bf16_fit[cs];
  return cudaSuccess;
}

template <>
inline cudaError_t gemm<bf16>(const bf16* A, const bf16* Wt, const bf16* bias, bf16* C, int M,
                              int N, int K, int act, cudaStream_t s) {
  if (M < 1 || N < 8 || K < 8 || N % 8 || K % 8) return cudaErrorInvalidValue;
  GemmOrder o;
  int clusters = 0;
  cudaError_t err = gemm_bf16_plan(M, N, K, &o, &clusters);
  if (err != cudaSuccess) return err;
  CUtensorMap map_a, map_w, map_c;
  // the weight in boxes of GN rows, or of GN / 2 on a pair (a half each)
  if (!tile_map(&map_a, A, M, K, GM) || !tile_map(&map_w, Wt, N, K, GN / o.cluster) ||
      !tile_map(&map_c, C, M, N, kEpiCols))
    return cudaErrorInvalidValue;
  if (o.cluster == 1) {
    // a plain launch: a launch with the cluster attribute ran 1-2% slower
    // at one CTA a cluster (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
    gemm_bf16_kernel<<<clusters, kGemmTcThreads, kGemmSmem, s>>>(map_a, map_w, map_c, bias,
                                                                      M, N, K, act, o);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch(&cfg, attr, kGemmTcThreads, kGemmSmem, o.cluster, clusters, s);
  err = cudaLaunchKernelEx(&cfg, gemm_bf16_kernel, map_a, map_w, map_c, bias, M, N, K, act, o);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <>
inline cudaError_t gemm<float>(const float* A, const float* Wt, const float* bias, float* C,
                               int M, int N, int K, int act, cudaStream_t s) {
  dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
  gemm_f32_kernel<<<grid, kGemmThreads, 0, s>>>(A, Wt, bias, C, M, N, K, act);
  return cudaGetLastError();
}

}  // namespace zt
