// Hopper's bulk asynchronous copies (cp.async.bulk, the 1-D TMA), their
// mbarriers and thread-block clusters, as small inline-PTX helpers.  Used
// by dft_tc.cuh, pretranspose.cu and tile_bench.cu.
//
// The rules these kernels keep:
//   - a bulk copy's global and shared addresses are 16-byte aligned and
//     its size is a multiple of 16 (the bytes around a span that is not
//     are copied by threads);
//   - a load completes on an mbarrier (complete_tx of its bytes); the
//     waiting threads see the bytes once the phase completes;
//   - generic-proxy writes to shared memory that a bulk store reads, or
//     that a later bulk load overwrites, are ordered by
//     fence.proxy.async.shared::cta before the barrier that hands the
//     buffer over;
//   - a store's source buffer is reused only after wait_group.read;
//   - in a cluster, every block's mbarriers are initialised and fenced
//     (fence.mbarrier_init) before a cluster-wide barrier, and no block
//     exits before a cluster-wide barrier at the end while a peer may
//     still multicast into its shared memory or arrive on its mbarriers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(b)),
               "r"(count)
               : "memory");
}

// this thread's arrival
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(b))
               : "memory");
}

// this thread's arrival, and `bytes` more to come by complete_tx
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   saddr(b)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a phase that
// never completes (a lost copy) traps after 2^24 polls, an error instead
// of a hung card.  kCluster: acquire at cluster scope, for arrivals from the
// cluster's other blocks (else this block's threads and its bulk copies)
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    if (n == (1u << 24)) __trap();
    if (kCluster)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(saddr(b)), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(saddr(b)), "r"(parity)
          : "memory");
  }
}

// one arrival on the mbarrier at b's offset in the shared memory of the
// cluster's block `rank` (release at cluster scope)
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* b,
                                                   uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n" ::
          "r"(saddr(b)),
      "r"(rank)
      : "memory");
}

// global -> this block's shared memory, completion on bar
__device__ __forceinline__ void load(void* dst, const void* src,
                                     uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// global -> the same offset in the shared memory of every block of the
// cluster whose rank bit is set in `mask`, completion on the mbarrier at
// bar's offset in each
__device__ __forceinline__ void load_multicast(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar)), "h"(mask)
      : "memory");
}

// this block's shared memory -> global, in this thread's bulk group
__device__ __forceinline__ void store(void* dst, const void* src,
                                      uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(saddr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// at most N of this thread's bulk groups still reading shared memory
template <int N>
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// all of this thread's bulk groups complete (their writes performed)
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// generic-proxy shared-memory accesses -> ordered before the async proxy's
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void named_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

}  // namespace bulk
