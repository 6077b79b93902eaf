// Hopper's barriers and copies as the port's kernels use them: mbarriers
// (a TMA ring's full and empty slots), thread block clusters (a CTA's rank,
// its peers' shared memory through mapa, the cluster-wide barrier) and the
// bulk copy engine (cp.async.bulk: one thread moves a contiguous run of
// bytes from device memory into shared memory and completes it on an
// mbarrier). Shared by gemm.cuh (kernels 1 and 4's GEMM ring),
// encoder_layer.cu (kernel 1's LayerNorm clusters) and attention.cuh (the
// attention core's cluster kernel past 16 heads of 128).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace zt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// raise the phase's expected transaction bytes without arriving
__device__ __forceinline__ void mbar_add_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Returns once the barrier's phase differs from `parity`. A wait of more
// than ~2^36 clocks (tens of seconds; a stage takes microseconds) can only
// be a broken pipeline: it traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 36)) __trap();
  }
}

// ------------------------------------------------------------------ clusters
__device__ __forceinline__ uint32_t cluster_reg(int which) {
  uint32_t v;
  switch (which) {
    case 0: asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v)); break;
    case 1: asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(v)); break;
    case 2: asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(v)); break;
    default: asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(v)); break;
  }
  return v;
}
// the shared::cluster address of a shared::cta address in CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_cluster_f2(uint32_t addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v.x), "f"(v.y)
               : "memory");
}
__device__ __forceinline__ uint4 ld_cluster_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
// arrive on a peer's mbarrier; release: this thread's stores before it are
// seen by whoever acquires the phase
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}
// arrive on a peer's (or this CTA's own, through its cluster address)
// mbarrier with the default semantics (release at CTA scope), as a TMA
// ring's consumers release a stage that the cluster's producers refill:
// the stage's readers are wgmma, done once waited for, and the refill is
// TMA. With these arrives at cluster scope (mbar_arrive_cluster) and the
// producer's waits too (mbar_wait_cluster), a two-CTA GEMM ran at half its
// rate (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t addr) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(addr) : "memory");
}
// mbar_wait with cluster-scope acquire (the peers' stores are visible after)
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 36)) __trap();
  }
}
// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// cluster_sync in two halves: work between them overlaps the peers' arrival
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// ---------------------------------------------------------------- bulk copy
// `bytes` (a multiple of 16; both addresses 16-byte aligned) from device
// memory into this CTA's shared memory, completed on `bar` (whose expected
// transaction count must cover them)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// this thread's generic-proxy accesses to shared memory are ordered before
// later async-proxy ones (a bulk copy or TMA into the same bytes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace zt
