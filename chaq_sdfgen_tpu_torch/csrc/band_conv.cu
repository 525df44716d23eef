// Banded Gaussian cols-conv kernels for Hopper (sm_90a): the pass 2 of the
// sharded declared-range soft field (parallel/sharded.py, the shard-local
// two-conv split of chaq_sdfgen_tpu/parallel/sharded.py:_local_soft_mm),
// which reads the pass-1 sums of a shard with a halo of k rows of its
// neighbours on each side.
//
// cols_conv replaces chaq_sdfgen_tpu/ops/pallas_band_conv.py:_cols_kernel
//   (cols_conv). out[o] = sum_{d = -k..k} w(d) in[o + row_off + d], w(d) =
//   exp(-d^2/T), zero outside the input's rows. The conv is its own adjoint
//   (symmetric taps, zero boundary), so one kernel serves both directions:
//   the forward reads the (h + 2k)-row halo'd slab and writes its h interior
//   rows (row_off = k); the backward reads the h-row cotangent and writes
//   the slab's h + 2k rows (row_off = -k). Tap radii up to 128: the TPU
//   kernel stops at 16, the alignment of its 16-row halo blocks, and runs
//   wider taps as an XLA einsum.
// p2_fused_fwd replaces _p2f_kernel (p2_fused_fwd): the cols conv of both
//   pass-1 sums (a_in, a_out) then the tails (soft_tails.cuh): d2 = c -
//   T log s (1e30 where s <= 1e-30), d = sqrt(max(d2, 0) + eps), field =
//   d_out - max(d_in - 1, 0), and the two d2 memos; (h + 2k) rows in, h out.
// p2_fused_bwd replaces _p2b_kernel (p2_fused_bwd): the tails' VJP from the
//   cotangent and the memos (dead windows give 0, never through the exp),
//   then the cols conv of ds_in and ds_out; h rows in, h + 2k out (the
//   halo rows' cotangents go back to their owners through the halo
//   exchange's VJP).
//
// Bound: bytes for small k (4 B per pixel per operand read or written; at
// k = 10, 2 x 21 multiply-adds per pixel). Design: one block of 256 threads
// per 64-column x 64-row output tile. The block first stages the tile's
// column window of the producer (the input, or the tails' VJP of it) over
// its 64 + 2k input rows in shared memory, each value computed once, then
// each thread takes one column and every fourth row of the tile and sums the
// 2k + 1 taps down its column. Shared memory: 4 (64 + 2k) 64 B per field,
// 24-80 KB (k 16-128, one field) or 48 KB (two fields, k 16). Float32 on
// CUDA cores, no tensor cores: TF32 or bf16 products move knee-pixel
// gradients by percents.
//
// Exact numbers: the sums run in the order d = -k .. k, each multiply and
// add an _rn intrinsic, so nvcc contracts nothing into an FMA; logf, expf,
// IEEE sqrt and division, no --use_fast_math. Each kernel's arithmetic is its
// plain version's (ops/band_conv.py), op for op.

#include <cuda_runtime.h>

#include "soft_tails.cuh"

namespace {

constexpr int kMaxK = 128;  // tap radius limit
constexpr int kTaps = 2 * kMaxK + 1;
constexpr int kTileW = 64;  // output columns per block, one per thread
constexpr int kTileH = 64;  // output rows per block
constexpr int kThreads = 256;
constexpr int kLanes = kThreads / kTileW;  // row lanes: each thread takes every kLanes-th row

struct Taps {
  float w[kTaps];  // w[i] = w(i - k), i <= 2k
};

// Input planes of h_in rows, output planes of h_out rows, both w wide;
// output row o sums input rows o + row_off - k .. o + row_off + k.
struct Frame {
  int h_in, h_out, w, k, row_off;
};

// Producers: the value(s) at one input pixel.
struct Load1 {
  const float* in;
  __device__ __forceinline__ void operator()(size_t i, float* v) const { v[0] = in[i]; }
};

struct Load2 {
  const float* a;
  const float* b;
  __device__ __forceinline__ void operator()(size_t i, float* v) const {
    v[0] = a[i];
    v[1] = b[i];
  }
};

struct Vjp2 {
  TailsVjp vjp;
  __device__ __forceinline__ void operator()(size_t i, float* v) const { vjp(i, v[0], v[1]); }
};

// Epilogues: the sums at one output pixel.
struct Store1 {
  float* out;
  __device__ __forceinline__ void operator()(size_t i, const float* s) const { out[i] = s[0]; }
};

struct Store2 {
  float* a;
  float* b;
  __device__ __forceinline__ void operator()(size_t i, const float* s) const {
    a[i] = s[0];
    b[i] = s[1];
  }
};

struct TailsEpi {
  Tails tails;
  __device__ __forceinline__ void operator()(size_t i, const float* s) const { tails(i, s[0], s[1]); }
};

// One output tile of image blockIdx.z over NF fields.
template <int NF, class Producer, class Epilogue>
__device__ __forceinline__ void cols_tile(const Producer& prod, const Epilogue& epi, const Frame& f,
                                          const Taps& taps) {
  extern __shared__ float win[];  // [NF][64 + 2k][kTileW]
  __shared__ float w[kTaps];
  const int k = f.k, rows = kTileH + 2 * k;
  for (int i = threadIdx.x; i <= 2 * k; i += kThreads) w[i] = taps.w[i];

  const int q = threadIdx.x % kTileW, lane = threadIdx.x / kTileW;
  const int x = blockIdx.x * kTileW + q, o0 = blockIdx.y * kTileH;
  const size_t in_plane = (size_t)blockIdx.z * f.h_in * f.w;
  const size_t out_plane = (size_t)blockIdx.z * f.h_out * f.w;

  // stage: the producer over input rows o0 + row_off - k + r, zero outside
  for (int r = lane; r < rows; r += kLanes) {
    const int y = o0 + f.row_off - k + r;
    float v[NF];
    for (int j = 0; j < NF; ++j) v[j] = 0.0f;
    if (x < f.w && y >= 0 && y < f.h_in) prod(in_plane + (size_t)y * f.w + x, v);
    for (int j = 0; j < NF; ++j) win[(j * rows + r) * kTileW + q] = v[j];
  }
  __syncthreads();
  if (x >= f.w) return;

  // sums down the column, d = -k .. k
  for (int o = lane; o < kTileH && o0 + o < f.h_out; o += kLanes) {
    float s[NF];
    for (int j = 0; j < NF; ++j) s[j] = 0.0f;
    for (int i = 0; i <= 2 * k; ++i) {
      const float wv = w[i];
      for (int j = 0; j < NF; ++j)
        s[j] = __fadd_rn(s[j], __fmul_rn(wv, win[(j * rows + o + i) * kTileW + q]));
    }
    epi(out_plane + (size_t)(o0 + o) * f.w + x, s);
  }
}

__global__ void __launch_bounds__(kThreads) cols_conv_kernel(Load1 prod, Store1 epi, Frame f, Taps taps) {
  cols_tile<1>(prod, epi, f, taps);
}

__global__ void __launch_bounds__(kThreads) p2_fused_fwd_kernel(Load2 prod, TailsEpi epi, Frame f, Taps taps) {
  cols_tile<2>(prod, epi, f, taps);
}

__global__ void __launch_bounds__(kThreads) p2_fused_bwd_kernel(Vjp2 prod, Store2 epi, Frame f, Taps taps) {
  cols_tile<2>(prod, epi, f, taps);
}

size_t smem_bytes(int fields, int k) { return sizeof(float) * (size_t)fields * (kTileH + 2 * k) * kTileW; }

// Validates the launch, fills the frame and taps, and allows the kernel the
// shared memory its widest launch needs.
template <class Kernel>
int prepare(Kernel kernel, int fields, int n, int h_in, int h_out, int w, int k, int row_off,
            const float* taps_host, Frame* f, Taps* taps, dim3* grid) {
  if (n < 1 || n > 65535 || h_in < 1 || h_out < 1 || w < 1 || k < 0 || k > kMaxK || taps_host == nullptr)
    return (int)cudaErrorInvalidValue;
  *grid = dim3((unsigned)((w + kTileW - 1) / kTileW), (unsigned)((h_out + kTileH - 1) / kTileH), (unsigned)n);
  if (grid->y > 65535) return (int)cudaErrorInvalidValue;
  *f = Frame{h_in, h_out, w, k, row_off};
  for (int i = 0; i < kTaps; ++i) taps->w[i] = i <= 2 * k ? taps_host[i] : 0.0f;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes(fields, kMaxK));
}

}  // namespace

// Launchers: plain C entry points for ctypes. Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError(). taps holds
// the 2k + 1 taps w(-k .. k). Output row o reads input rows o + row_off - k ..
// o + row_off + k of the h_in-row input (zero outside).

extern "C" int chaq_cols_conv(const void* in, void* out, int n, int h_in, int h_out, int w, int k,
                              int row_off, const float* taps, void* stream) {
  Frame f;
  Taps tp;
  dim3 grid;
  const int rc = prepare(cols_conv_kernel, 1, n, h_in, h_out, w, k, row_off, taps, &f, &tp, &grid);
  if (rc != 0) return rc;
  cols_conv_kernel<<<grid, kThreads, smem_bytes(1, k), (cudaStream_t)stream>>>(
      Load1{(const float*)in}, Store1{(float*)out}, f, tp);
  return (int)cudaGetLastError();
}

// a_in, a_out: (n, h_in, w); field and the memos (null: none): (n, h_out, w).
extern "C" int chaq_p2_fused_fwd(const void* a_in, const void* a_out, void* field, void* d2_in,
                                 void* d2_out, int n, int h_in, int h_out, int w, int k, int row_off,
                                 const float* taps, float t, float eps, float shift, void* stream) {
  if ((d2_in == nullptr) != (d2_out == nullptr)) return (int)cudaErrorInvalidValue;
  Frame f;
  Taps tp;
  dim3 grid;
  const int rc = prepare(p2_fused_fwd_kernel, 2, n, h_in, h_out, w, k, row_off, taps, &f, &tp, &grid);
  if (rc != 0) return rc;
  p2_fused_fwd_kernel<<<grid, kThreads, smem_bytes(2, k), (cudaStream_t)stream>>>(
      Load2{(const float*)a_in, (const float*)a_out},
      TailsEpi{Tails{(float*)field, (float*)d2_in, (float*)d2_out, shift, t, eps}}, f, tp);
  return (int)cudaGetLastError();
}

// ct, d2_in, d2_out: (n, h_in, w); da_in, da_out: (n, h_out, w).
extern "C" int chaq_p2_fused_bwd(const void* ct, const void* d2_in, const void* d2_out, void* da_in,
                                 void* da_out, int n, int h_in, int h_out, int w, int k, int row_off,
                                 const float* taps, float t, float eps, float shift, void* stream) {
  Frame f;
  Taps tp;
  dim3 grid;
  const int rc = prepare(p2_fused_bwd_kernel, 2, n, h_in, h_out, w, k, row_off, taps, &f, &tp, &grid);
  if (rc != 0) return rc;
  p2_fused_bwd_kernel<<<grid, kThreads, smem_bytes(2, k), (cudaStream_t)stream>>>(
      Vjp2{TailsVjp{(const float*)ct, (const float*)d2_in, (const float*)d2_out, shift, t, eps}},
      Store2{(float*)da_in, (float*)da_out}, f, tp);
  return (int)cudaGetLastError();
}
