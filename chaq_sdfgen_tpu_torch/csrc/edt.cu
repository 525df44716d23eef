// Hard EXACT pipeline kernels for Hopper (sm_90a): the two passes of the
// banded separable exact EDT, byte-identical to the OpenMP reference.
//
// edt_rows<T> replaces chaq_sdfgen_tpu/ops/pallas_edt.py:
//   _row_pass_block_kernel (row_distances_u8) and
//   _row_pass_block_kernel_ext (row_distances_u8_ext, the u16 strips).
//   Per image row, the distance along x to the nearest TRUE pixel (code 1)
//   and to the nearest FALSE pixel (code 0), clipped at min(band+1, max(T)).
//   T is uint8, uint16 or int32: the int32 strips serve bands above 65534,
//   where the JAX package answers through XLA (pallas_edt.py:939-945).
//   Code 2 seeds neither field. Bound: memory; a row is read once (W bytes)
//   and written twice (2 W sizeof(T)), plus one re-read of the outputs from
//   L2. Design: one block per row walks it in tiles of blockDim pixels; a
//   block-wide max-scan of seed indices (left to right) and a min-scan
//   (right to left) give the nearest seed on each side for both polarities
//   at once. No transposes: a row is contiguous on the card.
//
// edt_band_bytes<T> replaces chaq_sdfgen_tpu/ops/pallas_edt.py:
//   _fused_kernel_looped_halo (fused_pass2_bytes_halo) and
//   _fused_kernel_looped (fused_pass2_bytes, the u16 strips, with row_off).
//   Per pixel and field: g(y') = min(d(y'), band+1)^2, with rows outside
//   the strip reading (band+1)^2; D = min over |dy| <= band of dy^2 +
//   g(y+dy) in float32; then the correctly rounded sqrt, the -1-biased
//   signed merge and the clamped remap to a truncated byte. The strip may
//   carry halo rows (a shard's neighbours' rows, parallel/sharded.py):
//   output row y reads strip row y + row_off, and only out_rows rows are
//   written. With row_off >= band halo rows each side the walk never
//   leaves the strip; a single device passes row_off 0 and out_rows H. Bound: taps, i.e. loads of
//   the column strips; on dense content a pixel stops after a few taps,
//   on sparse content it walks up to band taps. Design: one thread per
//   output pixel walks dy = 1, 2, ... and stops once dy^2 >= the running
//   minimum (g >= 0, so no later tap can lower it) -- the GPU form of the
//   TPU kernel's segment-min skip bound and trip-count cap, with no tables.
//   The strips are read through L1/L2 (both 4K u8 fields fit in the 50 MB
//   L2); neighbouring threads read neighbouring columns.
//
// edt_dist replaces chaq_sdfgen_tpu/ops/pallas_edt.py:_dist_kernel
//   (exact_distance_field): the exact full-range distance to the nearest
//   seed. Per pixel, D = min over all dy of dy^2 + min(d(y+dy), sat)^2 on
//   the u16 row-distance strip of edt_rows (clipped at the saturation tier
//   sat), in int32 (D reaches ~8e8, beyond float32's exact integers); rows
//   outside the image read sat, so they can only matter where D >= sat^2,
//   which reads 32768.0 (no seed); elsewhere the correctly rounded sqrt of
//   D rounded to float32 (__int2float_rn, as JAX's astype). Bound: bytes,
//   6 B/px (u16 in, float32 out); a linear-time lower envelope needs ~40
//   operations per pixel, well under them. The walk below spends more taps
//   than that wherever the nearest seed is far.
//   Design: edt_band_bytes' walk with the band equal to the image height:
//   one thread per pixel walks dy = 1, 2, ... and stops once dy^2 >= its
//   running minimum. The worst case, one far seed, walks O(H) taps per
//   pixel, as the TPU kernel does.
//
// Exact numbers: every float op that matters is an explicit _rn intrinsic,
// so nvcc cannot contract a multiply and an add into an FMA (which would
// break the Veltkamp split of the sqrt refinement), and the remap divides
// with IEEE rounding. Build without --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

#include "refined_sqrt.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kNone = -(1 << 30);  // "no seed on this side" for the max-scan
constexpr int kFar = 1 << 30;      // "no seed on this side" for the min-scan
constexpr unsigned kFull = 0xffffffffu;

struct MaxOp {
  static constexpr int kIdentity = kNone;
  __device__ __forceinline__ int operator()(int a, int b) const { return max(a, b); }
};

struct MinOp {
  static constexpr int kIdentity = kFar;
  __device__ __forceinline__ int operator()(int a, int b) const { return min(a, b); }
};

// Inclusive block-wide scan of an int pair in thread order, seeded with
// `carry` (the total of the tiles before); returns the scanned value and
// writes the new carry (carry op all values of this tile).
template <class Op>
__device__ __forceinline__ int2 block_scan(int2 v, int2* carry, int2* warp_tot, Op op) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(kFull, v.x, o);
    const int b = __shfl_up_sync(kFull, v.y, o);
    if (lane >= o) {
      v.x = op(v.x, a);
      v.y = op(v.y, b);
    }
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int2 t = lane < nwarps ? warp_tot[lane] : make_int2(Op::kIdentity, Op::kIdentity);
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(kFull, t.x, o);
      const int b = __shfl_up_sync(kFull, t.y, o);
      if (lane >= o) {
        t.x = op(t.x, a);
        t.y = op(t.y, b);
      }
    }
    if (lane < nwarps) warp_tot[lane] = t;
  }
  __syncthreads();
  int2 pre = *carry;
  if (warp > 0) {
    pre.x = op(pre.x, warp_tot[warp - 1].x);
    pre.y = op(pre.y, warp_tot[warp - 1].y);
  }
  v.x = op(v.x, pre.x);
  v.y = op(v.y, pre.y);
  carry->x = op(carry->x, warp_tot[nwarps - 1].x);
  carry->y = op(carry->y, warp_tot[nwarps - 1].y);
  __syncthreads();  // warp_tot is reused by the next tile
  return v;
}

// grid (H, 1, N); block kRowThreads. din/dout are written in the forward
// walk and re-read (by other threads of the block, after the scan's
// barriers) in the backward walk.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
edt_rows_kernel(const uint8_t* __restrict__ codes, T* din, T* dout, int h, int w, int clip) {
  __shared__ int2 warp_tot[32];
  const size_t row = (size_t)blockIdx.z * h + blockIdx.x;
  const uint8_t* src = codes + row * w;
  T* pin = din + row * w;
  T* pout = dout + row * w;

  // left to right: index of the nearest seed at or before x
  int2 carry = make_int2(kNone, kNone);
  for (int base = 0; base < w; base += blockDim.x) {
    const int x = base + threadIdx.x;
    int2 v = make_int2(kNone, kNone);
    if (x < w) {
      const uint8_t c = src[x];
      if (c == 1) v.x = x;
      if (c == 0) v.y = x;
    }
    v = block_scan(v, &carry, warp_tot, MaxOp());
    if (x < w) {
      pin[x] = (T)min(x - v.x, clip);
      pout[x] = (T)min(x - v.y, clip);
    }
  }

  // right to left: index of the nearest seed at or after x
  carry = make_int2(kFar, kFar);
  for (int end = w; end > 0; end -= blockDim.x) {
    const int x = end - 1 - (int)threadIdx.x;
    int2 v = make_int2(kFar, kFar);
    if (x >= 0) {
      const uint8_t c = src[x];
      if (c == 1) v.x = x;
      if (c == 0) v.y = x;
    }
    v = block_scan(v, &carry, warp_tot, MinOp());
    if (x >= 0) {
      pin[x] = (T)min((int)pin[x], v.x - x);
      pout[x] = (T)min((int)pout[x], v.y - x);
    }
  }
}

// D = min over |dy| <= band of dy^2 + g(y+dy) for the column that `col`
// points into (row stride w).
// Beyond max(y, h - 1 - y) both taps lie outside the strip: they read big
// >= best and cannot lower it, so the walk stops there too.
template <typename T>
__device__ __forceinline__ float band_min_at(const T* __restrict__ col, int h, int w, int y,
                                             int band) {
  const int clip = band + 1;
  const float fclip = (float)clip;
  const float big = __fmul_rn(fclip, fclip);
  auto g = [&](int yy) -> float {
    if (yy < 0 || yy >= h) return big;
    const float d = (float)min((int)col[(size_t)yy * w], clip);
    return __fmul_rn(d, d);
  };
  float best = g(y);
  const int reach = min(band, max(y, h - 1 - y));
  for (int dy = 1; dy <= reach; ++dy) {
    const float fdy = (float)dy;
    const float dy2 = __fmul_rn(fdy, fdy);
    if (dy2 >= best) break;
    best = fminf(best, __fadd_rn(fminf(g(y - dy), g(y + dy)), dy2));
  }
  return best;
}

constexpr int kBandTx = 64;
constexpr int kBandTy = 4;

// grid (ceil(W/64), ceil(out_rows/4), N); block (64, 4): one thread per
// output pixel. The strips are (N, h, W), the output (N, out_rows, W).
template <typename T>
__global__ void __launch_bounds__(kBandTx * kBandTy)
edt_band_bytes_kernel(const T* __restrict__ din, const T* __restrict__ dout,
                      uint8_t* __restrict__ out, int h, int w, int row_off, int out_rows,
                      int band, float s_min, float s_max, int apply_sqrt) {
  const int x = blockIdx.x * kBandTx + threadIdx.x;
  const int y = blockIdx.y * kBandTy + threadIdx.y;
  if (x >= w || y >= out_rows) return;
  const size_t plane = (size_t)blockIdx.z * h * w;
  float d_in = band_min_at(din + plane + x, h, w, y + row_off, band);
  float d_out = band_min_at(dout + plane + x, h, w, y + row_off, band);
  if (apply_sqrt) {
    d_in = refined_sqrt_f32(d_in);
    d_out = refined_sqrt_f32(d_out);
  }
  // signed merge (openmp/sdfgen.c:98-106) + clamped remap (75-96)
  const float biased = d_in > 0.0f ? __fadd_rn(d_in, -1.0f) : d_in;
  const float vals = __fsub_rn(d_out, biased);
  const float v = fmaxf(fminf(vals, s_max), s_min);
  const float remap = __fadd_rn(
      __fdiv_rn(__fmul_rn(__fsub_rn(v, s_min), 255.0f), __fsub_rn(s_max, s_min)), 0.0f);
  out[(size_t)blockIdx.z * out_rows * w + (size_t)y * w + x] = (uint8_t)(int)remap;
}

// grid (ceil(W/64), ceil(H/4), N); block (64, 4): one thread per pixel.
__global__ void __launch_bounds__(kBandTx * kBandTy)
edt_dist_kernel(const uint16_t* __restrict__ d, float* __restrict__ out, int h, int w, int sat) {
  const int x = blockIdx.x * kBandTx + threadIdx.x;
  const int y = blockIdx.y * kBandTy + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = (size_t)blockIdx.z * h * w;
  const uint16_t* col = d + plane + x;
  auto g = [&](int yy) -> int {
    const int v = min((int)col[(size_t)yy * w], sat);
    return v * v;
  };
  int best = g(y);
  const int reach = max(y, h - 1 - y);  // beyond it both taps lie outside the image
  for (int dy = 1; dy <= reach; ++dy) {
    const int dy2 = dy * dy;
    if (dy2 >= best) break;
    if (y - dy >= 0) best = min(best, g(y - dy) + dy2);
    if (y + dy < h) best = min(best, g(y + dy) + dy2);
  }
  out[plane + (size_t)y * w + x] =
      best >= sat * sat ? 32768.0f : refined_sqrt_f32(__int2float_rn(best));
}

__global__ void refined_sqrt_kernel(const float* __restrict__ in, float* __restrict__ out,
                                    long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = refined_sqrt_f32(in[i]);
}

}  // namespace

// Launchers: plain C entry points for ctypes. Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

extern "C" int chaq_edt_rows(const void* codes, void* din, void* dout, int n, int h, int w,
                             int clip, int elem_bytes, void* stream) {
  if (n < 1 || h < 1 || w < 1 || n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)h, 1, (unsigned)n);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1) {
    edt_rows_kernel<uint8_t><<<grid, kRowThreads, 0, s>>>(
        (const uint8_t*)codes, (uint8_t*)din, (uint8_t*)dout, h, w, clip);
  } else if (elem_bytes == 2) {
    edt_rows_kernel<uint16_t><<<grid, kRowThreads, 0, s>>>(
        (const uint8_t*)codes, (uint16_t*)din, (uint16_t*)dout, h, w, clip);
  } else if (elem_bytes == 4) {
    edt_rows_kernel<int32_t><<<grid, kRowThreads, 0, s>>>(
        (const uint8_t*)codes, (int32_t*)din, (int32_t*)dout, h, w, clip);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// h: the strips' rows; output row y reads strip row y + row_off, for
// out_rows rows (row_off 0 and out_rows h on one device).
extern "C" int chaq_edt_band_bytes(const void* din, const void* dout, void* out, int n, int h,
                                   int w, int row_off, int out_rows, int band, float s_min,
                                   float s_max, int apply_sqrt, int elem_bytes, void* stream) {
  if (n < 1 || h < 1 || w < 1 || n > 65535 || band < 0 || band > (1 << 30) - 1 ||
      row_off < 0 || out_rows < 1 || row_off + out_rows > h) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kBandTx, kBandTy);
  const dim3 grid((unsigned)((w + kBandTx - 1) / kBandTx),
                  (unsigned)((out_rows + kBandTy - 1) / kBandTy), (unsigned)n);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1) {
    edt_band_bytes_kernel<uint8_t><<<grid, block, 0, s>>>(
        (const uint8_t*)din, (const uint8_t*)dout, (uint8_t*)out, h, w, row_off, out_rows, band,
        s_min, s_max, apply_sqrt);
  } else if (elem_bytes == 2) {
    edt_band_bytes_kernel<uint16_t><<<grid, block, 0, s>>>(
        (const uint16_t*)din, (const uint16_t*)dout, (uint8_t*)out, h, w, row_off, out_rows,
        band, s_min, s_max, apply_sqrt);
  } else if (elem_bytes == 4) {
    edt_band_bytes_kernel<int32_t><<<grid, block, 0, s>>>(
        (const int32_t*)din, (const int32_t*)dout, (uint8_t*)out, h, w, row_off, out_rows,
        band, s_min, s_max, apply_sqrt);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int chaq_edt_dist(const void* d, void* out, int n, int h, int w, int sat,
                             void* stream) {
  // sat^2 + (h-1)^2 must fit int32 (the tiers of cuda_edt.dist_sat)
  const long long reach = h - 1;
  if (n < 1 || h < 1 || w < 1 || n > 65535 || sat < 1 ||
      (long long)sat * sat + reach * reach >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kBandTx, kBandTy);
  const dim3 grid((unsigned)((w + kBandTx - 1) / kBandTx),
                  (unsigned)((h + kBandTy - 1) / kBandTy), (unsigned)n);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  edt_dist_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const uint16_t*)d, (float*)out, h,
                                                            w, sat);
  return (int)cudaGetLastError();
}

// Test entry: the pass-2 sqrt tail alone, for the exhaustive check over
// the 2^24 integer radicands.
extern "C" int chaq_refined_sqrt_f32(const void* in, void* out, long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  refined_sqrt_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, n);
  return (int)cudaGetLastError();
}
