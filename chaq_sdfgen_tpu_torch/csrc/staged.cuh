// Helpers of the staged kernels (softmin.cu, soft_fused.cu, brute.cu): cp.async copies
// into shared memory, and the reach of a tap loop from a float32 estimate.

#pragma once

#include <cuda_runtime.h>

// One 4-byte cp.async from device memory into shared memory, cached in L1.
static __device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
// One 16-byte cp.async (both addresses 16-byte aligned), past L1.
static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
static __device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
static __device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// The largest r in [0, band] with ok(r), ok falling in r (true up to some r,
// false past it), as "r = 0; while (r < band && ok(r + 1)) ++r" finds it: a
// float32 estimate, then a step or two to the exact integer.
template <class Ok>
static __device__ __forceinline__ int reach_of(Ok ok, float estimate, int band) {
  int r = estimate >= (float)band ? band : (int)fmaxf(estimate, 0.0f);
  while (r > 0 && !ok(r)) --r;
  while (r < band && ok(r + 1)) ++r;
  return r;
}
