// The 1-D bulk asynchronous copy from global to shared memory whose
// completion is counted in bytes on an mbarrier: the weight ring of the
// persistent decode kernel (decode_step_persistent.cuh) and the probes'
// rings (p1_int4_probe.cu, p3_stream_probe.cu) are built from these.  The
// wait around mbar_test, and what it does when it gives up, is each user's.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// Shared memory a block may opt in to on sm_90 (227 KB).
constexpr size_t SMEM_OPTIN = 232448;

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread, before the block's first copy: ``n`` barriers that each
// complete a phase on one arrival and the bytes that arrival announces.
static __device__ __forceinline__ void mbar_init(unsigned long long* bar, int n) {
  for (int i = 0; i < n; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar + i)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The phase's one arrival, announcing ``bytes`` of copies.  A copy may land
// before it: the barrier's byte count goes below zero until the arrival.
static __device__ __forceinline__ void mbar_expect(unsigned long long* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// ``bytes`` (a multiple of 16, both ends 16-byte aligned, under 1 MB) from
// global to shared memory; completion lands on ``bar``.
static __device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                                 unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One copy that is its barrier's whole phase: the arrival and the copy.
static __device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                                 unsigned long long* bar) {
  mbar_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// One poll: whether phase ``parity`` of the barrier at shared address
// ``addr`` has completed.
static __device__ __forceinline__ bool mbar_test(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  return done != 0;
}
