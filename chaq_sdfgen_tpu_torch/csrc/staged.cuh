// Helpers of the staged kernels (softmin.cu, soft_fused.cu, brute.cu, edt.cu): cp.async
// copies into shared memory, the reach of a tap loop from a float32 estimate, and a
// block's dynamic shared memory.

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

// The dynamic shared memory a block of `kernel` may take on the current
// device: the opt-in limit per block less the kernel's own static shared
// memory (a launch that asks for more fails). Cached per device in cache[64].
template <class K>
static int dyn_smem_limit(K kernel, size_t* cache, size_t* limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && cache[dev] != 0) {
    *limit = cache[dev];
    return 0;
  }
  int optin = 0;
  cudaFuncAttributes attr;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  *limit = (size_t)optin - attr.sharedSizeBytes;
  if (dev < 64) cache[dev] = *limit;
  return 0;
}

// Let `kernel` take `smem` bytes of dynamic shared memory on the current
// device (the attribute is set once per size and device in allowed[64]).
template <class K>
static int allow_smem(K kernel, size_t smem, size_t* allowed) {
  int dev = 0;
  const cudaError_t e0 = cudaGetDevice(&dev);
  if (e0 != cudaSuccess) return (int)e0;
  if (smem + 1024 > 48 * 1024 && (dev >= 64 || smem > allowed[dev])) {  // past 48 KB with the static part
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) allowed[dev] = smem;
  }
  return 0;
}
