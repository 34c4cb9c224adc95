// What the probe kernels (p1_int4_probe.cu, p3_stream_probe.cu) add to the
// bulk copies of bulk_copy.cuh, which the persistent decode kernel streams
// its weights with: a wait that gives up instead of hanging the card, and
// the opt-in to more than 48 KB of dynamic shared memory.
#pragma once

#include "bulk_copy.cuh"

// A wait that has not ended after this many polls sets PROBE_ERR_WAIT in the
// launch's error word and returns; the launch's results are void.
constexpr unsigned PROBE_SPIN_LIMIT = 1u << 22;
constexpr int PROBE_ERR_WAIT = 1;

// Wait for phase ``parity`` of ``bar`` to complete.  As the persistent
// kernel's ps_mbar_wait: the limit is looked at every 1024th failed poll.
static __device__ __forceinline__ void probe_wait(unsigned long long* bar, uint32_t parity,
                                                  int* err) {
  const uint32_t addr = smem_u32(bar);
  unsigned spins = 0;
  while (!mbar_test(addr, parity)) {
    if ((++spins & 1023u) == 0 && spins >= PROBE_SPIN_LIMIT) {
      atomicOr(err, PROBE_ERR_WAIT);
      return;
    }
  }
}

// Let ``kernel`` ask for up to SMEM_OPTIN bytes of dynamic shared memory on
// the current device (set once per device, 64 at most; ``done`` is the
// caller's mask of devices already set).
static int probe_allow_smem(const void* kernel, unsigned long long* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if ((*done >> dev) & 1ull) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_OPTIN);
  if (e != cudaSuccess) return (int)e;
  *done |= 1ull << dev;
  return 0;
}
