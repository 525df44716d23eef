// The composed soft path's column soft-min for Hopper (sm_90a), forward and
// backward: the banded soft-min along y of a pre-extended height field, the
// step that ops/softsdf.py runs three times for one soft field (pass 1 per
// field on the transposed heights, pass 2 once on both fields side by side).
//
// Layouts (float32, contiguous, the batch in gridDim.z): gext is (n, h + 2 band,
// w), with band rows of data above and below the h output rows (the caller's
// boundary sentinels, 1e30); S, ct are (n, h, w); dg is (n, h + 2 band, w).
//
// softmin_col_fwd replaces chaq_sdfgen_tpu/ops/pallas_soft.py:_softmin_fwd_kernel
//   (softmin_col_fwd). For output row q and tap d = -band .. band, v_d =
//   gext[q + band + d]; m = min_d (v_d + d^2), then
//   S[q] = m - T log sum_d exp(((m - v_d) - d^2) / T).
// softmin_col_bwd replaces _softmin_bwd_kernel (softmin_col_bwd): for each
//   extended row p, dg[p] = sum_d exp(((S[q] - d^2) - gext[p]) / T) ct[q],
//   q = p - band - d over the q in [0, h): the VJP with the softmax weights
//   recomputed from S.
//
// Skipped taps. A tap enters a sum only if its exponent z (times 1/T) is at
// least -27 (pallas_soft._CUT: a relative weight below e^-27); the TPU kernels
// cut whole 4-tap groups by a chunk bound, these cut per tap, so the kernels
// and their plain versions (ops/softmin.py) sum the same taps in the same
// order, d ascending, and agree bit for bit. The hard min walks outward from
// d = 0 and stops once the tile's column minimum + d^2 reaches m; each sum runs
// over |d| <= reach, the last d whose exponent could pass the cut given that
// minimum (forward) or the tile's column maximum of S (backward). Float
// rounding is monotone, so both stops are exact.
//
// Bound: bytes (8 B per output pixel forward, 16 backward) on dense content,
// where a pixel's cut leaves a few taps; operations (about 5 per live tap) far
// from any seed, where every tap of the band is live. Design: one thread per
// output pixel, threads along x, so that every tap is one coalesced row load of
// the block's 32 columns; a block takes a 32-column x 128-row tile (16 rows
// per thread) and first reduces its columns' window of gext (or of S) to the
// bound that stops the walks. No shared-memory staging of the taps, no tensor
// cores: float32 on CUDA cores.
//
// Exact numbers: every multiply and add is an _rn intrinsic, so nvcc contracts
// nothing into an FMA; expf and logf, no --use_fast_math. Offsets are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;                 // columns per block, one per lane
constexpr int kLanes = kThreads / kCols;  // row lanes per block
constexpr int kRows = 128;                // rows per block
constexpr int kPer = kRows / kLanes;      // rows per thread
constexpr float kCut = 27.0f;             // pallas_soft._CUT
constexpr float kInf = __builtin_huge_valf();

struct Col {
  int n, h, w, band;
  float t, inv_t;
};

// Min (or max) of each column's partial over the kLanes row lanes.
template <bool kMax>
__device__ __forceinline__ float column_reduce(float v, float (*part)[kCols]) {
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  part[ty][tx] = v;
  __syncthreads();
  v = part[0][tx];
  for (int i = 1; i < kLanes; ++i) v = kMax ? fmaxf(v, part[i][tx]) : fminf(v, part[i][tx]);
  return v;
}

// The banded soft-min at the tap v[0]: taps v[d * stride], |d| <= band, all in
// range; vmin is a lower bound of every tap.
__device__ float soft_min(const float* v, long long stride, int band, float vmin, float t,
                          float inv_t) {
  float m = v[0];
  for (int d = 1; d <= band; ++d) {
    const float dd = (float)(d * d);
    if (__fadd_rn(vmin, dd) >= m) break;
    m = fminf(m, __fadd_rn(fminf(v[-d * stride], v[d * stride]), dd));
  }
  const float gap = __fsub_rn(m, vmin);
  int reach = 0;
  while (reach < band &&
         __fmul_rn(__fsub_rn(gap, (float)((reach + 1) * (reach + 1))), inv_t) >= -kCut)
    ++reach;
  float s = 0.0f;
  for (int d = -reach; d <= reach; ++d) {
    const float z = __fmul_rn(__fsub_rn(__fsub_rn(m, v[d * stride]), (float)(d * d)), inv_t);
    if (z >= -kCut) s = __fadd_rn(s, expf(z));
  }
  return __fsub_rn(m, __fmul_rn(t, logf(s)));
}

__global__ void __launch_bounds__(kThreads) softmin_fwd_kernel(const float* gext, float* out, Col p) {
  __shared__ float part[kLanes][kCols];
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const int x = blockIdx.x * kCols + tx, y0 = blockIdx.y * kRows;
  const long long w = p.w;
  const int he = p.h + 2 * p.band;
  const float* g = gext + (long long)blockIdx.z * he * w + x;
  // the tile reads gext rows y0 .. y0 + kRows + 2 band - 1
  float lo = kInf;
  if (x < p.w) {
    const int r1 = min(y0 + kRows + 2 * p.band, he);
    for (int r = y0 + ty; r < r1; r += kLanes) lo = fminf(lo, g[r * w]);
  }
  lo = column_reduce<false>(lo, part);
  if (x >= p.w) return;
  float* o = out + (long long)blockIdx.z * p.h * w + x;
  for (int i = 0; i < kPer; ++i) {
    const int q = y0 + ty + i * kLanes;
    if (q >= p.h) break;
    o[q * w] = soft_min(g + (q + p.band) * w, w, p.band, lo, p.t, p.inv_t);
  }
}

__global__ void __launch_bounds__(kThreads) softmin_bwd_kernel(const float* gext, const float* s,
                                                               const float* ct, float* dg, Col p) {
  __shared__ float part[kLanes][kCols];
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const int x = blockIdx.x * kCols + tx, p0 = blockIdx.y * kRows;
  const long long w = p.w;
  const int he = p.h + 2 * p.band;
  const float* g = gext + (long long)blockIdx.z * he * w + x;
  const float* sv = s + (long long)blockIdx.z * p.h * w + x;
  const float* cv = ct + (long long)blockIdx.z * p.h * w + x;
  // the tile reads S rows p0 - 2 band .. p0 + kRows - 1
  float hi = -kInf;
  if (x < p.w) {
    const int q1 = min(p0 + kRows, p.h);
    for (int q = max(p0 - 2 * p.band, 0) + ty; q < q1; q += kLanes) hi = fmaxf(hi, sv[q * w]);
  }
  hi = column_reduce<true>(hi, part);
  if (x >= p.w) return;
  float* o = dg + (long long)blockIdx.z * he * w + x;
  for (int i = 0; i < kPer; ++i) {
    const int r = p0 + ty + i * kLanes;
    if (r >= he) break;
    const float target = g[r * w];
    int reach = 0;
    while (reach < p.band &&
           __fmul_rn(__fsub_rn(__fsub_rn(hi, (float)((reach + 1) * (reach + 1))), target), p.inv_t) >=
               -kCut)
      ++reach;
    // q = r - band - d must lie in [0, h)
    const int dlo = max(-reach, r - p.band - (p.h - 1)), dhi = min(reach, r - p.band);
    float acc = 0.0f;
    for (int d = dlo; d <= dhi; ++d) {
      const long long q = r - p.band - d;
      const float z = __fmul_rn(__fsub_rn(__fsub_rn(sv[q * w], (float)(d * d)), target), p.inv_t);
      if (z >= -kCut) acc = __fadd_rn(acc, __fmul_rn(expf(z), cv[q * w]));
    }
    o[r * w] = acc;
  }
}

int prepare(int n, int h, int w, int band, float t, float inv_t, Col* p) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || band < 0) return (int)cudaErrorInvalidValue;
  const long long he = (long long)h + 2LL * band;
  if (he > 0x7fffffffLL || (he + kRows - 1) / kRows > 65535) return (int)cudaErrorInvalidValue;
  *p = Col{n, h, w, band, t, inv_t};
  return 0;
}

dim3 grid(const Col& p, int rows) {
  return dim3((unsigned)((p.w + kCols - 1) / kCols), (unsigned)((rows + kRows - 1) / kRows), (unsigned)p.n);
}

}  // namespace

// Launchers: plain C entry points for ctypes. h is the number of output rows
// of the forward (the rows of S); t is float32(T), inv_t float32(1/T). Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

extern "C" int chaq_softmin_fwd(const void* gext, void* out, int n, int h, int w, int band, float t,
                                float inv_t, void* stream) {
  Col p;
  const int rc = prepare(n, h, w, band, t, inv_t, &p);
  if (rc != 0) return rc;
  softmin_fwd_kernel<<<grid(p, h), kThreads, 0, (cudaStream_t)stream>>>((const float*)gext, (float*)out, p);
  return (int)cudaGetLastError();
}

extern "C" int chaq_softmin_bwd(const void* gext, const void* s, const void* ct, void* dg, int n, int h,
                                int w, int band, float t, float inv_t, void* stream) {
  Col p;
  const int rc = prepare(n, h, w, band, t, inv_t, &p);
  if (rc != 0) return rc;
  softmin_bwd_kernel<<<grid(p, h + 2 * band), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)gext, (const float*)s, (const float*)ct, (float*)dg, p);
  return (int)cudaGetLastError();
}
