// The soft training step's elementwise front end and its MSE loss for
// Hopper (sm_90a): models/soft_model.py through ops/soft_front.py.
//
// These replace no Pallas kernel: the JAX package leaves the front end and
// the loss to XLA, which fuses each chain into a pass or two. PyTorch runs
// them eagerly, about 25 elementwise and reduction passes a training step
// over (2, 4096^2) float32 fields. Four launchers:
//
// chaq_soft_front_fwd   (..., 2) float32 img2ch -> v (...), one pass:
//     g = fl(x0 m0) + fl(x1 m1) - bias,  v = (g - 127.5) / tau * tau_s + 127.5
//   with m = softmax(channel_mix), tau = exp(log_tau) and the bias read
//   through device pointers (no host read), each operation an explicit _rn
//   intrinsic in the torch chain's order, so v is bitwise the chain's
//   (x * mix, .sum(-1), - bias, - 127.5, / tau, * tau_s, + 127.5).
// chaq_soft_front_bwd   dv and img2ch -> the parameters' gradients, and the
//   pixels' where asked, one pass: with dg = fl(fl(dv tau_s) / tau) (the
//   chain's own rounding of the gradient at g), the block partials of
//   sum dg, sum dg (g - 127.5), sum dg x0, sum dg x1, then one block that
//   sums them in a fixed order and writes [d mix0, d mix1, d bias, d tau] =
//   [sum dg x0, sum dg x1, -sum dg, -sum dg (g - 127.5) / tau]; the pixels'
//   gradient dimg2ch = (fl(dg m0), fl(dg m1)).
// chaq_soft_mse_fwd     sum (pred - target)^2 / divisor: block partials, then
//   one block that finishes them.
// chaq_soft_mse_bwd     dpred = fl(fl(g inv_n) fl(2 (pred - target))) with the
//   loss's cotangent g read by pointer, the chain's mean and pow backward.
//
// Sums: each product of two floats is exact in double, each thread adds in
// double, the block and the finishing block add in a fixed tree, and no
// atomics: two identical calls give the same bits. A launch's partition
// depends only on the element count and whether the pointers take 16-byte
// vectors.
//
// Bound: bytes. The front end reads 8 B and writes 4 B a pixel forward,
// reads 12 B backward (and writes 8 B with the pixels' gradient); the loss
// reads 8 B an element forward, 8 B and writes 4 B backward. At (2, 4096^2)
// on an H100 80GB HBM3 (700 W) each runs at 78-86% of that at 3.35 TB/s
// (PERF.md §6). Design: grid-stride loops over 16-byte vectors (two
// pixels of img2ch, four of a field), the ragged end and unaligned tensors
// a scalar at a time; the double sums cost four conversions a pixel, under
// the bytes' time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStreamBlocks = 4096;  // elementwise passes: enough blocks to fill the card, then a stride
constexpr int kReduceBlocks = 1024;  // reductions: the partials' capacity (ops/soft_front.REDUCE_BLOCKS)

struct Front {
  const float* mix;   // softmax(channel_mix): m0, m1
  const float* bias;  // threshold_bias
  const float* tau;   // exp(log_tau)
  float tau_s;        // the configured tau the field's kernels run at
};

struct FrontScalars {
  float m0, m1, bias, tau, tau_s;
};

__device__ __forceinline__ FrontScalars scalars(const Front& f) {
  return {__ldg(f.mix), __ldg(f.mix + 1), __ldg(f.bias), __ldg(f.tau), f.tau_s};
}

// g: the channel pair mixed (each product rounded, then their sum, as the
// chain's multiply and .sum(-1)), less the bias
__device__ __forceinline__ float mixed(const FrontScalars& s, float x0, float x1) {
  return __fsub_rn(__fadd_rn(__fmul_rn(x0, s.m0), __fmul_rn(x1, s.m1)), s.bias);
}

// v: the learnable tau folded into the value, so the field runs at tau_s
__device__ __forceinline__ float folded(const FrontScalars& s, float g) {
  return __fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(g, 127.5f), s.tau), s.tau_s), 127.5f);
}

// The sums of N doubles over the block's threads, a fixed tree into out[0 .. N).
template <int N>
__device__ __forceinline__ void block_sum(const double (&acc)[N], double* out) {
  __shared__ double part[N][kThreads];
#pragma unroll
  for (int k = 0; k < N; ++k) part[k][threadIdx.x] = acc[k];
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
#pragma unroll
      for (int k = 0; k < N; ++k) part[k][threadIdx.x] += part[k][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x < N) out[threadIdx.x] = part[threadIdx.x][0];
}

// One block: the partials of `blocks` blocks (N each) summed in a fixed
// order, then fin(total) on one thread.
template <int N, typename Finish>
__global__ void __launch_bounds__(kThreads) finish_kernel(const double* __restrict__ partials, int blocks,
                                                          Finish fin) {
  double acc[N] = {};
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] += partials[(size_t)b * N + k];
  }
  __shared__ double total[N];
  block_sum<N>(acc, total);
  __syncthreads();
  if (threadIdx.x == 0) fin(total);
}

struct FrontFinish {
  float* grads;  // [d mix0, d mix1, d bias, d tau]
  const float* tau;
  __device__ void operator()(const double* t) const {
    grads[0] = (float)t[2];
    grads[1] = (float)t[3];
    grads[2] = (float)(-t[0]);
    grads[3] = (float)(-t[1] / (double)__ldg(tau));
  }
};

struct MseFinish {
  float* loss;
  double divisor;
  __device__ void operator()(const double* t) const { loss[0] = (float)(t[0] / divisor); }
};

// ------------------------------------------------------------- front end

template <bool kVec>
__global__ void __launch_bounds__(kThreads) soft_front_fwd_kernel(const float* __restrict__ img,
                                                                  float* __restrict__ v, Front f,
                                                                  long long pixels) {
  const FrontScalars s = scalars(f);
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long pairs = kVec ? pixels / 2 : 0;
  for (long long p = first; p < pairs; p += stride) {
    const float4 x = reinterpret_cast<const float4*>(img)[p];
    reinterpret_cast<float2*>(v)[p] = make_float2(folded(s, mixed(s, x.x, x.y)), folded(s, mixed(s, x.z, x.w)));
  }
  for (long long p = 2 * pairs + first; p < pixels; p += stride) v[p] = folded(s, mixed(s, img[2 * p], img[2 * p + 1]));
}

// One pixel of the backward: its terms of the four sums, and its pixel
// gradient (fl(dg m0), fl(dg m1)).
__device__ __forceinline__ float2 front_pixel_bwd(const FrontScalars& s, float dv, float x0, float x1,
                                                  double (&acc)[4]) {
  const float dg = __fdiv_rn(__fmul_rn(dv, s.tau_s), s.tau);
  const double d = (double)dg;
  acc[0] += d;
  acc[1] = fma(d, (double)__fsub_rn(mixed(s, x0, x1), 127.5f), acc[1]);
  acc[2] = fma(d, (double)x0, acc[2]);
  acc[3] = fma(d, (double)x1, acc[3]);
  return make_float2(__fmul_rn(dg, s.m0), __fmul_rn(dg, s.m1));
}

// dimg null: no pixel gradient. The partials (4 a block) are always written.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) soft_front_bwd_kernel(const float* __restrict__ dv,
                                                                  const float* __restrict__ img,
                                                                  float* __restrict__ dimg, Front f,
                                                                  long long pixels,
                                                                  double* __restrict__ partials) {
  const FrontScalars s = scalars(f);
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long pairs = kVec ? pixels / 2 : 0;
  double acc[4] = {};
  for (long long p = first; p < pairs; p += stride) {
    const float2 g = reinterpret_cast<const float2*>(dv)[p];
    const float4 x = reinterpret_cast<const float4*>(img)[p];
    const float2 a = front_pixel_bwd(s, g.x, x.x, x.y, acc);
    const float2 b = front_pixel_bwd(s, g.y, x.z, x.w, acc);
    if (dimg != nullptr) reinterpret_cast<float4*>(dimg)[p] = make_float4(a.x, a.y, b.x, b.y);
  }
  for (long long p = 2 * pairs + first; p < pixels; p += stride) {
    const float2 a = front_pixel_bwd(s, dv[p], img[2 * p], img[2 * p + 1], acc);
    if (dimg != nullptr) {
      dimg[2 * p] = a.x;
      dimg[2 * p + 1] = a.y;
    }
  }
  block_sum<4>(acc, partials + (size_t)blockIdx.x * 4);
}

// ------------------------------------------------------------------- loss

__device__ __forceinline__ double sq_diff(float p, float t, double acc) {
  const double d = (double)__fsub_rn(p, t);
  return fma(d, d, acc);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) soft_mse_fwd_kernel(const float* __restrict__ pred,
                                                                 const float* __restrict__ target,
                                                                 long long n, double* __restrict__ partials) {
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long quads = kVec ? n / 4 : 0;
  double acc[1] = {};
  for (long long q = first; q < quads; q += stride) {
    const float4 a = reinterpret_cast<const float4*>(pred)[q];
    const float4 b = reinterpret_cast<const float4*>(target)[q];
    acc[0] = sq_diff(a.w, b.w, sq_diff(a.z, b.z, sq_diff(a.y, b.y, sq_diff(a.x, b.x, acc[0]))));
  }
  for (long long i = 4 * quads + first; i < n; i += stride) acc[0] = sq_diff(pred[i], target[i], acc[0]);
  block_sum<1>(acc, partials + blockIdx.x);
}

// the chain's mean backward (g times the float reciprocal of n) times its
// pow backward (2 (pred - target)), each rounded
__device__ __forceinline__ float mse_grad(float c, float p, float t) {
  return __fmul_rn(c, __fmul_rn(2.0f, __fsub_rn(p, t)));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) soft_mse_bwd_kernel(const float* __restrict__ pred,
                                                                 const float* __restrict__ target,
                                                                 const float* __restrict__ g, float inv_n,
                                                                 float* __restrict__ dpred, long long n) {
  const float c = __fmul_rn(__ldg(g), inv_n);
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long quads = kVec ? n / 4 : 0;
  for (long long q = first; q < quads; q += stride) {
    const float4 a = reinterpret_cast<const float4*>(pred)[q];
    const float4 b = reinterpret_cast<const float4*>(target)[q];
    reinterpret_cast<float4*>(dpred)[q] =
        make_float4(mse_grad(c, a.x, b.x), mse_grad(c, a.y, b.y), mse_grad(c, a.z, b.z), mse_grad(c, a.w, b.w));
  }
  for (long long i = 4 * quads + first; i < n; i += stride) dpred[i] = mse_grad(c, pred[i], target[i]);
}

// ---------------------------------------------------------------- launch

int blocks_for(long long items, int cap) {
  const long long b = (items + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : b > cap ? cap : b);
}

bool aligned(const void* p, unsigned bytes) { return p == nullptr || (uintptr_t)p % bytes == 0; }

}  // namespace

// (img2ch, v, mix, bias, tau, tau_s, pixels, stream)
extern "C" int chaq_soft_front_fwd(const void* img, void* v, const void* mix, const void* bias, const void* tau,
                                   float tau_s, long long pixels, void* stream) {
  if (pixels <= 0) return 0;
  const Front f{(const float*)mix, (const float*)bias, (const float*)tau, tau_s};
  const bool vec = aligned(img, 16) && aligned(v, 8);
  const int blocks = blocks_for(vec ? pixels / 2 : pixels, kStreamBlocks);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    soft_front_fwd_kernel<true><<<blocks, kThreads, 0, st>>>((const float*)img, (float*)v, f, pixels);
  else
    soft_front_fwd_kernel<false><<<blocks, kThreads, 0, st>>>((const float*)img, (float*)v, f, pixels);
  return (int)cudaGetLastError();
}

// (dv, img2ch, dimg2ch or null, partials (kReduceBlocks x 4 doubles), grads (4 floats), mix, bias, tau,
//  tau_s, pixels, stream)
extern "C" int chaq_soft_front_bwd(const void* dv, const void* img, void* dimg, void* partials, void* grads,
                                   const void* mix, const void* bias, const void* tau, float tau_s,
                                   long long pixels, void* stream) {
  const Front f{(const float*)mix, (const float*)bias, (const float*)tau, tau_s};
  const bool vec = aligned(dv, 8) && aligned(img, 16) && aligned(dimg, 16);
  const int blocks = blocks_for(vec ? pixels / 2 : pixels, kReduceBlocks);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    soft_front_bwd_kernel<true><<<blocks, kThreads, 0, st>>>((const float*)dv, (const float*)img, (float*)dimg,
                                                             f, pixels, (double*)partials);
  else
    soft_front_bwd_kernel<false><<<blocks, kThreads, 0, st>>>((const float*)dv, (const float*)img, (float*)dimg,
                                                              f, pixels, (double*)partials);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  finish_kernel<4><<<1, kThreads, 0, st>>>((const double*)partials, blocks, FrontFinish{(float*)grads, f.tau});
  return (int)cudaGetLastError();
}

// (pred, target, partials (kReduceBlocks doubles), loss (1 float), n, divisor, stream)
extern "C" int chaq_soft_mse_fwd(const void* pred, const void* target, void* partials, void* loss, long long n,
                                 double divisor, void* stream) {
  const bool vec = aligned(pred, 16) && aligned(target, 16);
  const int blocks = blocks_for(vec ? n / 4 : n, kReduceBlocks);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    soft_mse_fwd_kernel<true><<<blocks, kThreads, 0, st>>>((const float*)pred, (const float*)target, n,
                                                           (double*)partials);
  else
    soft_mse_fwd_kernel<false><<<blocks, kThreads, 0, st>>>((const float*)pred, (const float*)target, n,
                                                            (double*)partials);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  finish_kernel<1><<<1, kThreads, 0, st>>>((const double*)partials, blocks, MseFinish{(float*)loss, divisor});
  return (int)cudaGetLastError();
}

// (pred, target, g (1 float), dpred, n, inv_n, stream)
extern "C" int chaq_soft_mse_bwd(const void* pred, const void* target, const void* g, void* dpred, long long n,
                                 float inv_n, void* stream) {
  if (n <= 0) return 0;
  const bool vec = aligned(pred, 16) && aligned(target, 16) && aligned(dpred, 16);
  const int blocks = blocks_for(vec ? n / 4 : n, kStreamBlocks);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    soft_mse_bwd_kernel<true><<<blocks, kThreads, 0, st>>>((const float*)pred, (const float*)target,
                                                           (const float*)g, inv_n, (float*)dpred, n);
  else
    soft_mse_bwd_kernel<false><<<blocks, kThreads, 0, st>>>((const float*)pred, (const float*)target,
                                                            (const float*)g, inv_n, (float*)dpred, n);
  return (int)cudaGetLastError();
}
