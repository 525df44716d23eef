// The correctly rounded float32 sqrt of the hard kernels (edt.cu, brute.cu):
// numerics.refined_sqrt, with every op an explicit _rn intrinsic so that nvcc
// cannot contract a multiply and an add into an FMA, which would break the
// Veltkamp split of the Newton step.

#pragma once

#include <cuda_runtime.h>

static __device__ __forceinline__ float refined_sqrt_f32(float n) {
  const float s0 = __fsqrt_rn(n);
  const float c = __fmul_rn(s0, 4097.0f);
  const float hi = __fsub_rn(c, __fsub_rn(c, s0));
  const float lo = __fsub_rn(s0, hi);
  const float e = __fsub_rn(
      __fsub_rn(__fsub_rn(n, __fmul_rn(hi, hi)), __fmul_rn(__fmul_rn(2.0f, hi), lo)),
      __fmul_rn(lo, lo));
  const float denom = __fmul_rn(2.0f, s0);
  const float corr = __fdiv_rn(e, denom > 0.0f ? denom : 1.0f);
  return n > 0.0f ? __fadd_rn(s0, corr) : 0.0f;
}
