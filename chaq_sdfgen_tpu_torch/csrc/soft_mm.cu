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
// multiply and an add, plus ~10 transcendentals (the occupancy of the halo
// pixels is computed again by each tile that reads them); the bytes are
// 8-16 (forward) and 20 (backward) per pixel. Design: one block of 256
// threads per 64x64 output tile. Each warp takes rows of the tile plus a
// halo of k2 rows: it evaluates the per-pixel producer (occupancy, or the
// tails' VJP) for the 64 + 2 k1 pixels of the row into a warp-private
// shared buffer, then the rows conv into a (64 + 2 k2) x 64 shared tile per
// field. After one barrier each thread takes one column and 16 rows of the
// tile for the cols conv and the per-pixel epilogue (the tails, or the
// occupancy VJP). Shared memory: 49-55 KB per block (k2 = 10-16).
//
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

namespace {

constexpr int kMaxK = 16;               // tap radius limit (pallas_soft_mm._HK)
constexpr int kTaps = 2 * kMaxK + 1;
constexpr int kTile = 64;               // output tile: kTile x kTile pixels
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBuf = kTile + 2 * kMaxK;  // one field of a warp's row buffer

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
__device__ __forceinline__ void occupancies(float l, float ct1, float& e_in, float& e_out) {
  const float sp = log1pf(expf(-fabsf(l)));
  e_in = expf(__fadd_rn(ct1, __fsub_rn(fminf(l, 0.0f), sp)));
  e_out = expf(__fadd_rn(ct1, __fsub_rn(fminf(-l, 0.0f), sp)));
}

__device__ __forceinline__ float logit(float g, float tau, bool above) {
  const float l = __fdiv_rn(__fsub_rn(g, 127.5f), tau);
  return above ? l : -l;
}

// Forward producer: the two shifted occupancies of a pixel.
struct Occupancy {
  const float* gray;
  float tau, ct1;  // ct1 = c / T
  bool above;
  __device__ __forceinline__ void operator()(size_t i, float& e_in, float& e_out) const {
    occupancies(logit(gray[i], tau, above), ct1, e_in, e_out);
  }
};

// Forward epilogue: the tails, the field and the memos, at every output
// pixel (the caller crops what lies outside the image).
struct FwdTails {
  Tails tails;
  __device__ __forceinline__ void operator()(size_t i, float s_in, float s_out, bool) const {
    tails(i, s_in, s_out);
  }
};

// Backward epilogue: the occupancy VJP into dgray.
struct OccupancyVjp {
  const float* gray;
  float* dgray;
  float tau, ct1;
  bool above;
  __device__ __forceinline__ void operator()(size_t i, float de_in, float de_out, bool live) const {
    if (!live) {
      dgray[i] = 0.0f;
      return;
    }
    const float l = logit(gray[i], tau, above);
    float e_in, e_out;
    occupancies(l, ct1, e_in, e_out);
    const float sig_m = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(l)));   // sigmoid(-l)
    const float sig_p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-l)));  // sigmoid(l)
    const float dg = __fdiv_rn(__fsub_rn(__fmul_rn(__fmul_rn(de_in, e_in), sig_m),
                                         __fmul_rn(__fmul_rn(de_out, e_out), sig_p)),
                               tau);
    dgray[i] = above ? dg : -dg;
  }
};

// Shared memory of a block, in floats.
__host__ __device__ constexpr int smem_floats(int k2) {
  return 2 * (kTile + 2 * k2) * kTile + kWarps * 2 * kRowBuf;
}

// One 64x64 output tile of image blockIdx.z: producer over the tile's
// halo-extended input rows, rows conv, cols conv, epilogue. Pixels outside
// the live window produce zeros (the convs' zero boundary).
template <class Producer, class Epilogue>
__device__ __forceinline__ void two_conv_tile(const Producer& prod, const Epilogue& epi,
                                              const Geometry& geo, const Taps& taps) {
  extern __shared__ float smem[];
  __shared__ float w1[kTaps], w2[kTaps];
  const int k1 = geo.k1, k2 = geo.k2;
  const int rows = kTile + 2 * k2;
  const int cols_in = kTile + 2 * k1;
  float* a_in = smem;                  // [rows][kTile], rows conv of field 0
  float* a_out = a_in + rows * kTile;  // field 1
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* r_in = a_out + rows * kTile + warp * 2 * kRowBuf;
  float* r_out = r_in + kRowBuf;
  if (threadIdx.x < kTaps) {
    w1[threadIdx.x] = taps.w1[threadIdx.x];
    w2[threadIdx.x] = taps.w2[threadIdx.x];
  }
  __syncthreads();

  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const size_t in_plane = (size_t)blockIdx.z * geo.h_in * geo.w;
  const size_t out_plane = (size_t)blockIdx.z * geo.h_out * geo.w;

  // stage 1: per row of the tile and its k2-row halo, the producer over
  // the row's 64 + 2 k1 pixels, then the rows conv of its 64 outputs
  for (int r = warp; r < rows; r += kWarps) {
    const int y = y0 - k2 + r + geo.row_off;  // input row
    const bool y_in = y >= geo.ylo && y < geo.yhi;
    for (int j = lane; j < cols_in; j += 32) {
      const int x = x0 - k1 + j;
      float v_in = 0.0f, v_out = 0.0f;
      if (y_in && x >= geo.xlo && x < geo.xhi) prod(in_plane + (size_t)y * geo.w + x, v_in, v_out);
      r_in[j] = v_in;
      r_out[j] = v_out;
    }
    __syncwarp();
    for (int q = lane; q < kTile; q += 32) {
      float s_in = 0.0f, s_out = 0.0f;
      for (int i = 0; i <= 2 * k1; ++i) {
        const float wv = w1[i];
        s_in = __fadd_rn(s_in, __fmul_rn(wv, r_in[q + i]));
        s_out = __fadd_rn(s_out, __fmul_rn(wv, r_out[q + i]));
      }
      a_in[r * kTile + q] = s_in;
      a_out[r * kTile + q] = s_out;
    }
    __syncwarp();  // the row buffer is refilled next
  }
  __syncthreads();

  // stage 2: one column and every (kThreads / kTile)-th row per thread:
  // the cols conv, then the epilogue
  const int q = threadIdx.x % kTile;
  const int x = x0 + q;
  if (x >= geo.w) return;
  const bool x_in = x >= geo.xlo && x < geo.xhi;
  for (int o = threadIdx.x / kTile; o < kTile && y0 + o < geo.h_out; o += kThreads / kTile) {
    float s_in = 0.0f, s_out = 0.0f;
    for (int i = 0; i <= 2 * k2; ++i) {
      const float wv = w2[i];
      s_in = __fadd_rn(s_in, __fmul_rn(wv, a_in[(o + i) * kTile + q]));
      s_out = __fadd_rn(s_out, __fmul_rn(wv, a_out[(o + i) * kTile + q]));
    }
    const int y = y0 + o + geo.row_off;
    epi(out_plane + (size_t)(y0 + o) * geo.w + x, s_in, s_out, x_in && y >= geo.ylo && y < geo.yhi);
  }
}

__global__ void __launch_bounds__(kThreads)
soft_mm_fwd_kernel(Occupancy prod, FwdTails epi, Geometry geo, Taps taps) {
  two_conv_tile(prod, epi, geo, taps);
}

__global__ void __launch_bounds__(kThreads)
soft_mm_bwd_kernel(TailsVjp prod, OccupancyVjp epi, Geometry geo, Taps taps) {
  two_conv_tile(prod, epi, geo, taps);
}

// Validates the launch and fills the geometry, taps, grid and shared size.
// The window is clamped to the input frame.
int prepare(int n, int h_in, int h_out, int w, int row_off, int ylo, int yhi, int xlo, int xhi,
            int k1, int k2, const float* taps_host, Geometry* geo, Taps* taps, dim3* grid,
            size_t* smem) {
  if (n < 1 || h_in < 1 || h_out < 1 || w < 1 || n > 65535 || k1 < 0 || k2 < 0 || k1 > kMaxK ||
      k2 > kMaxK || taps_host == nullptr)
    return (int)cudaErrorInvalidValue;
  *grid = dim3((unsigned)((w + kTile - 1) / kTile), (unsigned)((h_out + kTile - 1) / kTile),
               (unsigned)n);
  if (grid->y > 65535) return (int)cudaErrorInvalidValue;
  ylo = ylo < 0 ? 0 : ylo;
  yhi = yhi > h_in ? h_in : yhi;
  xlo = xlo < 0 ? 0 : xlo;
  xhi = xhi > w ? w : xhi;
  *geo = Geometry{h_in, h_out, w, k1, k2, row_off, ylo, yhi, xlo, xhi};
  for (int i = 0; i < kTaps; ++i) {
    taps->w1[i] = taps_host[i];
    taps->w2[i] = taps_host[kTaps + i];
  }
  *smem = sizeof(float) * (size_t)smem_floats(k2);
  return 0;
}

// Above 48 KB a block's dynamic shared memory must be allowed first (on
// the current device).
template <class Kernel>
int allow_smem(Kernel kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)(sizeof(float) * smem_floats(kMaxK)));
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
  dim3 grid;
  size_t smem;
  int rc = prepare(n, h_in, h_out, w, row_off, ylo, yhi, xlo, xhi, k1, k2, taps, &geo, &tp, &grid,
                   &smem);
  if (rc == 0) rc = allow_smem(soft_mm_fwd_kernel);
  if (rc != 0) return rc;
  if ((d2_in == nullptr) != (d2_out == nullptr)) return (int)cudaErrorInvalidValue;
  const Occupancy prod{(const float*)gray, tau, shift / t, test_above != 0};
  const FwdTails epi{Tails{(float*)field, (float*)d2_in, (float*)d2_out, shift, t, eps}};
  soft_mm_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(prod, epi, geo, tp);
  return (int)cudaGetLastError();
}

extern "C" int chaq_soft_mm_bwd(const void* ct, const void* d2_in, const void* d2_out,
                                const void* gray, void* dgray, int n, int h_in, int h_out, int w,
                                int row_off, int ylo, int yhi, int xlo, int xhi, int k1, int k2,
                                const float* taps, float tau, float t, float eps, float shift,
                                int test_above, void* stream) {
  Geometry geo;
  Taps tp;
  dim3 grid;
  size_t smem;
  int rc = prepare(n, h_in, h_out, w, row_off, ylo, yhi, xlo, xhi, k1, k2, taps, &geo, &tp, &grid,
                   &smem);
  if (rc == 0) rc = allow_smem(soft_mm_bwd_kernel);
  if (rc != 0) return rc;
  const TailsVjp prod{(const float*)ct, (const float*)d2_in, (const float*)d2_out, shift, t, eps};
  const OccupancyVjp epi{(const float*)gray, (float*)dgray, tau, shift / t, test_above != 0};
  soft_mm_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(prod, epi, geo, tp);
  return (int)cudaGetLastError();
}
