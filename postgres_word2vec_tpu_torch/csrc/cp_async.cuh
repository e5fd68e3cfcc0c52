// Asynchronous copies from device memory into shared memory.
//
// - cp.async: 16-byte copies that a thread starts and walks on from, grouped
//   so that it can wait for the older groups while the newer ones are still
//   in flight. Used by the ADC walk (adc_common.cuh).
// - cp.async.bulk: one thread asks the copy engine (TMA) for a whole run of
//   bytes, and an mbarrier in shared memory counts the bytes that have
//   landed; threads spend no instructions on addresses. Used by the budget
//   kernels' tile copies (budget_common.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t adc_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ------------------------------------------------------- mbarrier + bulk
//
// An mbarrier is a 64-bit word in shared memory, named here by its shared
// address. Its phase completes when its expected arrivals have arrived and
// the bytes announced by mbar_expect_tx have landed.

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// After the last mbar_init, before a barrier lets other threads and the copy
// engine at the mbarriers.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One arrival that also announces `bytes` of copies to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of the given parity to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) global -> shared;
// the mbarrier's byte count drops by `bytes` when they have landed.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
