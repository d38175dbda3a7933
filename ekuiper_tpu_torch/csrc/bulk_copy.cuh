// Hopper's 1D bulk copy (the Tensor Memory Accelerator without a tensor
// map) from device memory into shared memory, completing on an mbarrier
// in shared memory. One thread asks for a whole contiguous run; the
// hardware moves it and counts its bytes into the barrier, whose phase
// flips when they have all arrived. No register or instruction of the
// waiting threads is spent on the copy.
//
// Use (one barrier a buffer, one copy in flight a barrier): the owner
// initialises the barrier once (bulk_bar_init, then bulk_bar_fence before
// any other thread touches it); one thread calls bulk_load; the readers
// call bulk_wait with the parity of the barrier's use (0 for its first
// copy, 1 for its second, ...). Before a buffer takes its next copy, every
// reader must be done with it (a __syncwarp or __syncthreads) and the
// issuing thread calls bulk_reuse_fence, which orders those generic-proxy
// reads before the async-proxy write.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t bulk_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The barrier expects one arrival (the issuing thread's, with the bytes).
__device__ __forceinline__ void bulk_bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   bulk_smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_bar_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Copy `bytes` (a multiple of 16; src and dst 16-byte aligned) from
// src in device memory to dst in shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t b = bulk_smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(bulk_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bulk_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = bulk_smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_reuse_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
