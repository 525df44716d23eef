// Declared-range soft SDF kernels for Hopper (sm_90a): the collapsed
// two-conv form of ops/soft_mxu.py, forward and backward.
//
// soft_mm_fwd replaces chaq_sdfgen_tpu/ops/pallas_soft_mm.py:_fwd_kernel
//   (mm_fused_fwd). Per pixel, the shifted occupancy of both fields,
//     l = +-(g - 127.5)/tau,
//     e_in = exp(c/T + log sigmoid(l)),  e_out = exp(c/T + log sigmoid(-l))
//   (the TPU kernel forms the second as exp(c/T + log sigmoid(l) - l), equal
//   in exact arithmetic, which cancels to an ulp of |l| where l << 0);
//   a banded Gaussian conv along x (radius k1, taps w(d) = exp(-d^2/T)),
//   one along y (radius k2), zero outside the image; then the tails
//     d2 = s > 1e-30 ? c - T log(s) : 1e30,  d = sqrt(max(d2, 0) + eps),
//     field = d_out - max(d_in - 1, 0),
//   and, for training, the two d2 memos.
//
// soft_mm_bwd replaces chaq_sdfgen_tpu/ops/pallas_soft_mm.py:_bwd_kernel
//   (mm_fused_bwd). Per pixel, the tails' VJP from the cotangent and the
//   memos, ds = ct_d2 (-T) exp((d2 - c)/T) (zero where d2 >= 1e29); the
//   transposed convs, which are the convs themselves (symmetric taps, zero
//   boundary) and commute (one acts on x, the other on y), so the backward
//   runs rows then cols like the forward and shares its tiling; then the
//   occupancy VJP, dg = (dE_in e_in sigmoid(-l) - dE_out e_out sigmoid(l))
//   (+-1/tau).
//
// Halo frames (the sharded tier). The producer reads an input frame of
// h_in rows and the epilogue writes h_out rows: output row o is input row
// o + row_off. A live window [ylo, yhi) x [xlo, xhi) of the input frame
// marks the pixels inside the image: outside it, and outside the frame, a
// pixel produces zeros (the convs' zero boundary), and the backward writes a
// zero dgray. The forward of a shard reads [k2 halo | local | k2 halo] gray
// rows and writes its local rows; the backward reads the neighbours' k2 edge
// rows of the cotangent and the memos and writes the complete dgray of its
// own rows. A single-device call is the frame with no halo and the whole
// image live, and computes what it computed before.
//
// Bound: operations. Per pixel about 2 fields x 2 convs x (2k+1) taps of a
// multiply and an add, plus ~10 transcendentals; the bytes are 8-16
// (forward) and 20 (backward) per pixel.
//
// Design (PERF.md rows 6-7): one strip walker serves both directions, with
// a producer and an epilogue of each. What held the first design, a 64 x 64
// output tile a block, back: each tap of each conv read its weight and both
// fields' inputs from shared memory (3 shared loads for 4 float operations,
// ~145 loads a pixel at k = 10), and the producer ran 1.72 times a pixel
// (over the 84 x 84 halo'd inputs of a 64 x 64 tile). Now a block of 256
// threads owns 128 output columns and walks a strip of rows, 16 a chunk:
//   * a batch of 16 input rows (the tile's columns and a k1 halo each side)
//     arrives through cp.async while the last batch's convs run: gray for
//     the forward, the cotangent and both memos for the backward; the
//     producer turns it into the two fields' conv inputs once a staged pixel
//     (128 + 2 k1 columns for 128, and 2 k2 rows once a strip): the shifted
//     occupancies from gray (forward), the tails' VJP ds (backward);
//   * the rows conv: a thread takes 8 consecutive outputs of one row of the
//     batch, its inputs in a register window (each staged value read once a
//     thread, not once a tap), into a ring of 48 rows (3 batches);
//   * the cols conv: a thread takes 8 consecutive rows of one column of the
//     chunk from the ring the same way, then the epilogue: the tails, the
//     field and the memos (forward), the occupancy VJP (backward);
//   * the tap loops are unrolled over the 33 taps the kernels take, each
//     step behind a test of the radius (uniform over the block), so the
//     taps come from the kernel's parameters at fixed offsets, out of
//     shared memory;
//   * shared memory: the staged inputs (10 KB forward, 30 KB backward), 26
//     KB of conv inputs (a column skewed by one every 8, so that a warp's 16
//     windows fall in distinct banks) and 50 KB of ring (a column's low bits
//     xor-swizzled by its 32-column block, so that a row's 8-wide stores
//     spread over the banks): 86 KB forward, 106 KB backward, 2 blocks an SM.
// x / T and x / tau are exact products where T or tau is a power of two
// (div_by): the same bits as the division.

// Exact numbers: every multiply that feeds an add is an explicit _rn
// intrinsic, so nvcc contracts nothing into an FMA, and the sums run in the
// order d = -k .. k: the arithmetic is that of the plain version
// (ops/soft_mxu.py, ops/cuda_soft_mm.py), op for op. expf, logf, log1pf and
// IEEE sqrt and division; no --use_fast_math, no __expf or __logf. The
// exponent of the occupancy is formed as one sum (c/T + log sigmoid), never
// as a product of exponentials: with tau 1 and T 0.5 the terms span e^-60 to
// e^70, inside float32 only that way. No tensor cores: TF32 or bf16 passes
// would move knee-pixel gradients by percents.

#include <cuda_runtime.h>

#include "soft_tails.cuh"
#include "staged.cuh"

namespace {

constexpr int kMaxK = 16;                     // tap radius limit (pallas_soft_mm._HK)
constexpr int kTaps = 2 * kMaxK + 1;
constexpr int kCols = 128;                    // output columns per block
constexpr int kRows = 16;                     // rows a batch (producer, rows conv) and a chunk (cols conv)
constexpr int kPer = 8;                       // consecutive outputs a thread in each conv
constexpr int kThreads = kCols * kRows / kPer;  // one conv item a thread (256)
constexpr int kRingRows = 3 * kRows;          // the ring: 3 batches, 16 + 2 k2 <= 48 rows
constexpr int kIn = kCols + 2 * kMaxK;        // staged columns, at most
constexpr int kDsStride = 208;                // a conv-input row: kIn columns skewed (180), 16 mod 32
constexpr int kRingStride = kCols + 4;        // a ring row: the next row 4 banks on

struct Taps {
  float w1[kTaps];  // rows conv, w1[i] = w(i - k1), i <= 2 k1
  float w2[kTaps];  // cols conv
};

// The frame: input planes of h_in rows, output planes of h_out rows (output
// row o is input row o + row_off), both w wide; the live window of the input
// frame, clamped to it.
struct Geometry {
  int h_in, h_out, w, k1, k2, row_off, ylo, yhi, xlo, xhi;
};

// The two shifted occupancies exp(c/T + log sigmoid(+-l)), with
// log sigmoid(+-l) = min(+-l, 0) - log1p(exp(-|l|)), as ops/soft_mxu.py's
// occupancy() forms them.
__device__ __forceinline__ void occupancies_of(float l, float sp, float ct1, float& e_in, float& e_out) {
  e_in = expf(__fadd_rn(ct1, __fsub_rn(fminf(l, 0.0f), sp)));
  e_out = expf(__fadd_rn(ct1, __fsub_rn(fminf(-l, 0.0f), sp)));
}

// l = +-(g - 127.5) / tau.
__device__ __forceinline__ float logit(float g, float tau, float inv_tau2, bool above) {
  const float l = div_by(__fsub_rn(g, 127.5f), tau, inv_tau2);
  return above ? l : -l;
}

// Forward producer: gray staged (one plane), then the two shifted
// occupancies of a live pixel.
struct Occupancy {
  static constexpr int kPlanes = 1;
  const float* gray;
  float tau, inv_tau2;  // inv_tau2: 1/tau where tau is a power of two, else 0 (div_by)
  float ct1;            // c / T
  bool above;
  __device__ __forceinline__ void stage(float* raw, int e, size_t i) const { cp_async4(raw + e, gray + i); }
  __device__ __forceinline__ void operator()(const float* raw, int e, float& e_in, float& e_out) const {
    const float l = logit(raw[e], tau, inv_tau2, above);
    occupancies_of(l, log1pf(expf(-fabsf(l))), ct1, e_in, e_out);
  }
};

// Backward producer: the cotangent and both memos staged, then the tails'
// VJP ds of a live pixel.
struct DsOfTails {
  static constexpr int kPlanes = 3;
  TailsVjp vjp;
  __device__ __forceinline__ void stage(float* raw, int e, size_t i) const {
    cp_async4(raw + e, vjp.ct + i);
    cp_async4(raw + kRows * kIn + e, vjp.d2_in + i);
    cp_async4(raw + 2 * kRows * kIn + e, vjp.d2_out + i);
  }
  __device__ __forceinline__ void operator()(const float* raw, int e, float& ds_in, float& ds_out) const {
    vjp(raw[e], raw[kRows * kIn + e], raw[2 * kRows * kIn + e], ds_in, ds_out);
  }
};

// Forward epilogue: the tails, the field and the memos, at every output
// pixel (the caller crops what lies outside the image).
struct FwdTails {
  Tails tails;
  __device__ __forceinline__ float ahead(size_t) const { return 0.0f; }
  __device__ __forceinline__ void operator()(size_t i, float, float s_in, float s_out, bool) const {
    tails(i, s_in, s_out);
  }
};

// Backward epilogue: the occupancy VJP, dgray from the pixel's gray (loaded
// ahead of the cols conv), zero outside the live window. exp(-|l|) is the
// occupancy's and one of the sigmoids' (exp(l) where l <= 0, exp(-l) where l
// >= 0), so it is formed once: the same values as forming each.
struct OccupancyVjp {
  const float* gray;
  float* dgray;
  float tau, ct1;
  bool above;
  float inv_tau2;  // 1/tau where tau is a power of two, else 0 (div_by)
  __device__ __forceinline__ float ahead(size_t i) const { return gray[i]; }
  __device__ __forceinline__ void operator()(size_t i, float g, float de_in, float de_out, bool live) const {
    if (!live) {
      dgray[i] = 0.0f;
      return;
    }
    const float l = logit(g, tau, inv_tau2, above);
    const float e = expf(-fabsf(l)), f = expf(fabsf(l));
    float e_in, e_out;
    occupancies_of(l, log1pf(e), ct1, e_in, e_out);
    const float sig_m = __fdiv_rn(1.0f, __fadd_rn(1.0f, l <= 0.0f ? e : f));  // sigmoid(-l)
    const float sig_p = __fdiv_rn(1.0f, __fadd_rn(1.0f, l >= 0.0f ? e : f));  // sigmoid(l)
    const float dg = div_by(__fsub_rn(__fmul_rn(__fmul_rn(de_in, e_in), sig_m),
                                      __fmul_rn(__fmul_rn(de_out, e_out), sig_p)),
                            tau, inv_tau2);
    dgray[i] = above ? dg : -dg;
  }
};

// Shared memory of a block, in floats: the staged planes, the conv inputs of
// both fields, the ring of both fields.
template <class Producer>
constexpr int smem_floats() {
  return Producer::kPlanes * kRows * kIn + 2 * kRows * kDsStride + 2 * kRingRows * kRingStride;
}

// A conv-input row's column c, skewed by one every 8: the 16 windows of a
// warp's row (8 columns apart) start in distinct banks, and the warp's two
// rows 16 banks apart.
__device__ __forceinline__ int ds_col(int c) { return c + (c >> 3); }

// The taps 0 .. 2 k of one conv for 8 consecutive outputs: out[q] = sum_i
// w[i] src[at(q + i)], i ascending from 0, each multiply and add rounded on
// its own (the plain version's order). Each staged value is read once into a
// register window; the loop is unrolled over the 33 taps the kernels take,
// each step behind a test of the radius (uniform over the block), so w[i] is
// a kernel parameter at a fixed offset.
template <class At>
__device__ __forceinline__ void conv_taps(const float* src0, const float* src1, At at, const float* w, int k,
                                          float (&out0)[kPer], float (&out1)[kPer]) {
  float v0[kPer + 2 * kMaxK], v1[kPer + 2 * kMaxK];
#pragma unroll
  for (int q = 0; q < kPer; ++q) out0[q] = out1[q] = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer - 1; ++j) {
    v0[j] = src0[at(j)];
    v1[j] = src1[at(j)];
  }
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
    if (i <= 2 * k) {
      v0[i + kPer - 1] = src0[at(i + kPer - 1)];
      v1[i + kPer - 1] = src1[at(i + kPer - 1)];
      const float wv = w[i];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        out0[q] = __fadd_rn(out0[q], __fmul_rn(wv, v0[q + i]));
        out1[q] = __fadd_rn(out1[q], __fmul_rn(wv, v1[q + i]));
      }
    }
  }
}

// A block of either kernel: output columns [x0, x0 + 128) and rows [o_start,
// o_end) of image blockIdx.z. Ring row u holds the rows conv at input row
// y_base + u (y_base = o_start + row_off - k2) in ring slot u mod 48; batch b
// is ring rows 16 b .. 16 b + 15, and output row o_start + t sums ring rows t
// .. t + 2 k2. Per chunk of 16 output rows: the batches it needs that are not
// in yet (each: wait for its staged inputs, the producer into the conv
// inputs, start the next batch's copies, the rows conv into the ring), then
// the cols conv and the epilogue. A pixel outside the live window (or the
// frame) gives zero conv inputs (the convs' zero boundary); it is not staged.
template <class Producer, class Epilogue>
__device__ __forceinline__ void strip_walk(const Producer& prod, const Epilogue& epi, const Geometry& geo,
                                           const Taps& taps, int strip) {
  extern __shared__ float smem[];
  float* raw = smem;                                    // [planes][16][160]: a batch as staged
  float* dsb = raw + Producer::kPlanes * kRows * kIn;   // [2][16][kDsStride]: the batch's conv inputs
  float* ring = dsb + 2 * kRows * kDsStride;            // [2][48][kRingStride]: the rows conv
  const int k1 = geo.k1, k2 = geo.k2, cw = kCols + 2 * k1;
  const int tid = threadIdx.x, x0 = blockIdx.x * kCols;
  const int o_start = blockIdx.y * strip, o_end = min(o_start + strip, geo.h_out);
  const int y_base = o_start + geo.row_off - k2;
  const int batches = (o_end - o_start + 2 * k2 + kRows - 1) / kRows;
  const size_t in_plane = (size_t)blockIdx.z * geo.h_in * geo.w;
  const size_t out_plane = (size_t)blockIdx.z * geo.h_out * geo.w;
  // a thread's pixels of a batch are n = tid + 256 m = cw r + c (row r,
  // column c < cw), staged at e = 160 r + c
  const int r_first = tid / cw, c_first = tid - r_first * cw;
  auto live = [&](int y, int x) { return y >= geo.ylo && y < geo.yhi && x >= geo.xlo && x < geo.xhi; };
  auto stage = [&](int b) {  // start batch b's copies
    int r = r_first, c = c_first;
    for (int n = tid; n < kRows * cw; n += kThreads) {
      const int y = y_base + kRows * b + r, x = x0 - k1 + c;
      if (live(y, x)) prod.stage(raw, r * kIn + c, in_plane + (size_t)y * geo.w + x);
      for (c += kThreads; c >= cw; c -= cw) ++r;
    }
    cp_commit();
  };

  stage(0);
  int b = 0;
  for (int t0 = 0; t0 < o_end - o_start; t0 += kRows) {
    const int need = min((t0 + kRows - 1 + 2 * k2) / kRows, batches - 1);
    for (; b <= need; ++b) {
      cp_wait_all();
      __syncthreads();  // batch b is in; the last convs are done with the conv inputs and the ring slot
      // the producer, every staged pixel
      {
        int r = r_first, c = c_first;
        for (int n = tid; n < kRows * cw; n += kThreads) {
          float a = 0.0f, z = 0.0f;
          if (live(y_base + kRows * b + r, x0 - k1 + c)) prod(raw, r * kIn + c, a, z);
          dsb[r * kDsStride + ds_col(c)] = a;
          dsb[(kRows + r) * kDsStride + ds_col(c)] = z;
          for (c += kThreads; c >= cw; c -= cw) ++r;
        }
      }
      __syncthreads();  // the conv inputs are in; the staging buffer is free
      if (b + 1 < batches) stage(b + 1);
      {
        // rows conv: row r of the batch, outputs c0 .. c0 + 7, into ring slot
        // 16 (b mod 3) + r, columns xor'd with their 32-column block
        const int r = tid / (kCols / kPer), c0 = kPer * (tid % (kCols / kPer));
        float a0[kPer], a1[kPer];
        const float* s0 = dsb + r * kDsStride;
        conv_taps(s0, s0 + kRows * kDsStride, [c0](int j) { return ds_col(c0 + j); }, taps.w1, k1, a0, a1);
        float* d0 = ring + (kRows * (b % 3) + r) * kRingStride + c0;
        float* d1 = d0 + kRingRows * kRingStride;
        const int sw = (c0 >> 5) & 3;
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          d0[q ^ sw] = a0[q];
          d1[q ^ sw] = a1[q];
        }
      }
    }
    __syncthreads();  // the ring holds the chunk's rows
    // cols conv: column q, tile rows t .. t + 7 (ring rows t .. t + 7 + 2 k2)
    const int q = tid % kCols, t = t0 + kPer * (tid / kCols);
    const int x = x0 + q;
    float pre[kPer];  // what the epilogue loads, ahead of the conv
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int o = o_start + t + m;
      pre[m] = (x < geo.w && o < o_end) ? epi.ahead(out_plane + (size_t)o * geo.w + x) : 0.0f;
    }
    const int us = t % kRingRows;
    const float* c0 = ring + (q ^ ((q >> 5) & 3));
    float e0[kPer], e1[kPer];
    conv_taps(c0, c0 + kRingRows * kRingStride,
              [us](int j) { return (us + j >= kRingRows ? us + j - kRingRows : us + j) * kRingStride; }, taps.w2,
              k2, e0, e1);
    if (x < geo.w) {
      const bool x_in = x >= geo.xlo && x < geo.xhi;
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int o = o_start + t + m, y = o + geo.row_off;
        if (o < o_end)
          epi(out_plane + (size_t)o * geo.w + x, pre[m], e0[m], e1[m], x_in && y >= geo.ylo && y < geo.yhi);
      }
    }
  }
}

// grid (column tiles, strips, N); block 256.
__global__ void __launch_bounds__(kThreads, 2)
soft_mm_fwd_kernel(Occupancy prod, FwdTails epi, const __grid_constant__ Geometry geo,
                   const __grid_constant__ Taps taps, int strip) {
  strip_walk(prod, epi, geo, taps, strip);
}

__global__ void __launch_bounds__(kThreads, 2)
soft_mm_bwd_kernel(DsOfTails prod, OccupancyVjp epi, const __grid_constant__ Geometry geo,
                   const __grid_constant__ Taps taps, int strip) {
  strip_walk(prod, epi, geo, taps, strip);
}

// Validates the launch and fills the geometry and taps. The window is
// clamped to the input frame.
int prepare(int n, int h_in, int h_out, int w, int row_off, int ylo, int yhi, int xlo, int xhi,
            int k1, int k2, const float* taps_host, Geometry* geo, Taps* taps) {
  if (n < 1 || h_in < 1 || h_out < 1 || w < 1 || n > 65535 || k1 < 0 || k2 < 0 || k1 > kMaxK ||
      k2 > kMaxK || taps_host == nullptr)
    return (int)cudaErrorInvalidValue;
  ylo = ylo < 0 ? 0 : ylo;
  yhi = yhi > h_in ? h_in : yhi;
  xlo = xlo < 0 ? 0 : xlo;
  xhi = xhi > w ? w : xhi;
  *geo = Geometry{h_in, h_out, w, k1, k2, row_off, ylo, yhi, xlo, xhi};
  for (int i = 0; i < kTaps; ++i) {
    taps->w1[i] = taps_host[i];
    taps->w2[i] = taps_host[kTaps + i];
  }
  return 0;
}

// Launches a strip kernel: strips of whole chunks, one block per SM slot in
// all where the image has enough: a strip's 2 k2 halo rows stay a small
// share, and every block does the same work, so one wave leaves no tail.
template <class Kernel, class Producer, class Epilogue>
int launch_strips(Kernel kernel, const Producer& prod, const Epilogue& epi, const Geometry& geo, const Taps& taps,
                  int n, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * smem_floats<Producer>();
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  const long long cols = (long long)((geo.w + kCols - 1) / kCols) * n, chunks = (geo.h_out + kRows - 1) / kRows;
  long long strips = (long long)sms * (per_sm > 0 ? per_sm : 1) / cols;
  strips = strips < 1 ? 1 : (strips > chunks ? chunks : strips);
  const int strip = (int)((chunks + strips - 1) / strips) * kRows;
  const dim3 grid((unsigned)((geo.w + kCols - 1) / kCols), (unsigned)((geo.h_out + strip - 1) / strip), (unsigned)n);
  kernel<<<grid, kThreads, smem, stream>>>(prod, epi, geo, taps, strip);
  return (int)cudaGetLastError();
}

}  // namespace

// Launchers: plain C entry points for ctypes. Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError(). The frame:
// the producer's input planes have h_in rows, the output planes h_out
// (forward: field and memos; backward: gray and dgray), output row o is input
// row o + row_off, and [ylo, yhi) x [xlo, xhi) is the live window of the
// input frame. taps holds 2 x 33 floats: the rows-conv taps w(-k1 .. k1),
// then the cols-conv taps w(-k2 .. k2), each padded to 33. shift is c, a
// runtime argument.

extern "C" int chaq_soft_mm_fwd(const void* gray, void* field, void* d2_in, void* d2_out, int n,
                                int h_in, int h_out, int w, int row_off, int ylo, int yhi, int xlo,
                                int xhi, int k1, int k2, const float* taps, float tau, float t,
                                float eps, float shift, int test_above, void* stream) {
  Geometry geo;
  Taps tp;
  const int rc = prepare(n, h_in, h_out, w, row_off, ylo, yhi, xlo, xhi, k1, k2, taps, &geo, &tp);
  if (rc != 0) return rc;
  if ((d2_in == nullptr) != (d2_out == nullptr)) return (int)cudaErrorInvalidValue;
  const Occupancy prod{(const float*)gray, tau, pow2_inverse(tau), shift / t, test_above != 0};
  const FwdTails epi{Tails{(float*)field, (float*)d2_in, (float*)d2_out, shift, t, eps}};
  return launch_strips(soft_mm_fwd_kernel, prod, epi, geo, tp, n, (cudaStream_t)stream);
}

extern "C" int chaq_soft_mm_bwd(const void* ct, const void* d2_in, const void* d2_out,
                                const void* gray, void* dgray, int n, int h_in, int h_out, int w,
                                int row_off, int ylo, int yhi, int xlo, int xhi, int k1, int k2,
                                const float* taps, float tau, float t, float eps, float shift,
                                int test_above, void* stream) {
  Geometry geo;
  Taps tp;
  const int rc = prepare(n, h_in, h_out, w, row_off, ylo, yhi, xlo, xhi, k1, k2, taps, &geo, &tp);
  if (rc != 0) return rc;
  const DsOfTails prod{
      TailsVjp{(const float*)ct, (const float*)d2_in, (const float*)d2_out, shift, t, eps, pow2_inverse(t)}};
  const OccupancyVjp epi{(const float*)gray, (float*)dgray, tau, shift / t, test_above != 0, pow2_inverse(tau)};
  return launch_strips(soft_mm_bwd_kernel, prod, epi, geo, tp, n, (cudaStream_t)stream);
}
