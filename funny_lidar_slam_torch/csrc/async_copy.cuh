// mbarrier and 1-D bulk async copy primitives (PTX, sm_90): the Hopper
// counterpart of pltpu.make_async_copy plus a DMA semaphore. Included by
// probes.cu (dma_rows).
//
// A load is `cp.async.bulk` global -> shared, counted on an mbarrier as
// transaction bytes: the issuing thread arms the barrier with
// mbar_expect_tx(bytes) and starts the copy; a thread that sees the phase
// flip (mbar_wait on the phase's parity) sees the bytes. A store is
// `cp.async.bulk` shared -> global in a bulk group: commit it, and wait with
// bulk_wait_read before the shared source is written again or the block
// exits. Sizes are multiples of 16 bytes, both ends 16-byte aligned, and one
// barrier's transaction count stays under 2^20 bytes.

#pragma once

#include <cstdint>

namespace async_copy {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes this thread's mbar_init visible to the async proxy (and, after a
// block barrier, to the other threads)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// orders this thread's generic-proxy accesses of shared memory before its
// later async-proxy ones (a bulk copy into or out of the same bytes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// global -> shared; completion is counted on `bar` as transaction bytes
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global, in this thread's current bulk group
__device__ __forceinline__ void bulk_copy_s2g(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until every bulk group this thread committed has read its source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

}  // namespace async_copy
