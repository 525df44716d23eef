// BRUTE pipeline kernels for Hopper (sm_90a): the OpenCL binary's truncated
// per-pixel search (opencl/sdf.cl:79-224), byte-identical to it, as a row
// pass and a column scan.
//
// brute_rows<T> replaces chaq_sdfgen_tpu/ops/pallas_brute.py:_passa_kernel
//   (row_seed_distances_ext). Per image row, side and polarity, the distance
//   to the nearest seed (L1 at or left of x, R1 at or right of x) and to the
//   second-nearest seed on that side (L2, R2), each clipped at
//   sent = spread + 1: eight planes of T. Bound: bytes; the row is read once
//   (1 B/px) and the planes written once (8 sizeof(T) B/px). Design: one
//   block per row walks it in tiles of blockDim pixels; one block-wide scan
//   per direction keeps, for both polarities at once, the two largest seed
//   indices so far (left to right) or the two smallest (right to left). The
//   TPU kernel carries the gap to the previous seed in the low bits of a
//   packed max-scan (L2 = L1 + gap); the two nearest indices give the same
//   L2 without the packing. No transposes (a row is contiguous on the card)
//   and no halo rows: brute_scan_bytes reads rows outside the image itself.
//
// brute_scan_bytes<T> replaces pallas_brute.py:_brute_kernel_entry ->
//   _brute_kernel_impl (brute_sdf_bytes_pallas). Per pixel, over the seeds
//   of the polarity opposite to its own value, D = min over |dy| <= spread
//   of dx^2 + dy^2, where dx is the nearer of the two sides' nearest seeds,
//   each side's second-nearest standing in where its nearest sits exactly
//   at |dx| == |dy| (the OpenCL search never probes exact diagonals,
//   opencl/sdf.cl:131-183); found = D <= spread^2; then the correctly
//   rounded sqrt, the sign rule decider = invert ^ value, the +-INF
//   fallback (2 spread + 4) and the clamped remap with IEEE division
//   (opencl/sdf.cl:206-223). Integer arithmetic up to the sqrt. Bound:
//   bytes, 1 + 8 sizeof(T) + 1 B/px; a lower envelope per side with the
//   diagonal rows as a scatter-min needs ~75 operations per pixel, under
//   them. The walk below costs taps: a pixel near a seed of the other
//   polarity stops after a few, one far from any walks up to spread rows
//   each way.
//   Design: one thread per output pixel walks |dy| = 1, 2, ... and stops
//   once dy^2 >= its running minimum (dx^2 >= 0, so no later tap can lower
//   it) -- the GPU form of the TPU kernel's segment-min skip bound. Rows
//   outside the image are no taps: they read sent there, whose d^2 exceeds
//   spread^2, so they cannot change the result. Neighbouring threads read
//   neighbouring columns of each plane.
//
// brute_scan_bytes_halo<T> replaces pallas_brute.py:_brute_kernel_halo_entry
//   (brute_sdf_bytes_pallas_halo, a shard of parallel/sharded.py). The same
//   per-pixel walk (the device function brute_pixel, shared with
//   brute_scan_bytes, as the TPU entry is a thin wrapper around the same
//   _brute_kernel_impl, pallas_brute.py:570-574) on planes that carry the
//   neighbouring shards' rows: (2, 4, N, H_loc + 2 hr, W), the shard's own
//   rows from row_off = hr on. The sign comes from the shard's own codes
//   (N, H_loc, W), and only its H_loc rows are written. With hr >= spread
//   the walk never leaves the planes. Bound: bytes, as brute_scan_bytes.
//
// Exact numbers: the float tail is explicit _rn intrinsics in the plain
// version's order (ops/brute.py, ops/merge.py). Build without
// --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

#include "refined_sqrt.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kNone = -(1 << 30);  // "no seed on this side" for the max-scan
constexpr int kFar = 1 << 30;      // "no seed on this side" for the min-scan
constexpr unsigned kFull = 0xffffffffu;

// The two nearest seed indices seen so far, per polarity: (x, y) for the
// TRUE seeds, (z, w) for the FALSE ones; x beats y and z beats w. kMax:
// nearest means largest (a left-to-right walk), else smallest.
template <bool kMax>
struct Top2 {
  static constexpr int kIdentity = kMax ? kNone : kFar;

  static __device__ __forceinline__ int best(int a, int b) { return kMax ? max(a, b) : min(a, b); }
  static __device__ __forceinline__ int worst(int a, int b) { return kMax ? min(a, b) : max(a, b); }

  // the two best of {p.a, p.b, q.a, q.b}
  static __device__ __forceinline__ void merge(int pa, int pb, int qa, int qb, int* a, int* b) {
    *a = best(pa, qa);
    *b = best(worst(pa, qa), best(pb, qb));
  }

  static __device__ __forceinline__ int4 merge(int4 p, int4 q) {
    int4 r;
    merge(p.x, p.y, q.x, q.y, &r.x, &r.y);
    merge(p.z, p.w, q.z, q.w, &r.z, &r.w);
    return r;
  }
};

__device__ __forceinline__ int4 shfl_up4(int4 v, int o) {
  return make_int4(__shfl_up_sync(kFull, v.x, o), __shfl_up_sync(kFull, v.y, o),
                   __shfl_up_sync(kFull, v.z, o), __shfl_up_sync(kFull, v.w, o));
}

// Inclusive block-wide top-2 scan in thread order, seeded with `carry` (the
// tiles before); returns the scanned value and updates the carry.
template <bool kMax>
__device__ __forceinline__ int4 block_scan_top2(int4 v, int4* carry, int4* warp_tot) {
  using Op = Top2<kMax>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int4 u = shfl_up4(v, o);
    if (lane >= o) v = Op::merge(u, v);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int id = Op::kIdentity;
    int4 t = lane < nwarps ? warp_tot[lane] : make_int4(id, id, id, id);
    for (int o = 1; o < 32; o <<= 1) {
      const int4 u = shfl_up4(t, o);
      if (lane >= o) t = Op::merge(u, t);
    }
    if (lane < nwarps) warp_tot[lane] = t;
  }
  __syncthreads();
  int4 pre = *carry;
  if (warp > 0) pre = Op::merge(pre, warp_tot[warp - 1]);
  v = Op::merge(pre, v);
  *carry = Op::merge(*carry, warp_tot[nwarps - 1]);
  __syncthreads();  // warp_tot is reused by the next tile
  return v;
}

// grid (H, 1, N); block kRowThreads. out: planes (polarity, side) of
// (N, H, W): 0-3 are L1, L2, R1, R2 of the TRUE seeds (code 1), 4-7 of the
// FALSE seeds (code 0).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
brute_rows_kernel(const uint8_t* __restrict__ codes, T* __restrict__ out, int n, int h, int w,
                  int sent) {
  __shared__ int4 warp_tot[32];
  const size_t row = (size_t)blockIdx.z * h + blockIdx.x;
  const size_t plane = (size_t)n * h * w;
  const uint8_t* src = codes + row * w;
  T* dst = out + row * w;

  // left to right: the two nearest seeds at or before x
  int4 carry = make_int4(kNone, kNone, kNone, kNone);
  for (int base = 0; base < w; base += blockDim.x) {
    const int x = base + threadIdx.x;
    int4 v = make_int4(kNone, kNone, kNone, kNone);
    if (x < w) {
      const uint8_t c = src[x];
      if (c == 1) v.x = x;
      if (c == 0) v.z = x;
    }
    v = block_scan_top2<true>(v, &carry, warp_tot);
    if (x < w) {
      dst[x] = (T)min(x - v.x, sent);
      dst[plane + x] = (T)min(x - v.y, sent);
      dst[4 * plane + x] = (T)min(x - v.z, sent);
      dst[5 * plane + x] = (T)min(x - v.w, sent);
    }
  }

  // right to left: the two nearest seeds at or after x
  carry = make_int4(kFar, kFar, kFar, kFar);
  for (int end = w; end > 0; end -= blockDim.x) {
    const int x = end - 1 - (int)threadIdx.x;
    int4 v = make_int4(kFar, kFar, kFar, kFar);
    if (x >= 0) {
      const uint8_t c = src[x];
      if (c == 1) v.x = x;
      if (c == 0) v.z = x;
    }
    v = block_scan_top2<false>(v, &carry, warp_tot);
    if (x >= 0) {
      dst[2 * plane + x] = (T)min(v.x - x, sent);
      dst[3 * plane + x] = (T)min(v.y - x, sent);
      dst[6 * plane + x] = (T)min(v.z - x, sent);
      dst[7 * plane + x] = (T)min(v.w - x, sent);
    }
  }
}

constexpr int kScanTx = 64;
constexpr int kScanTy = 4;

// One output pixel of the scan. val: the pixel's value (it searches the
// seeds of the other polarity, sdf.cl:201); l1: its column of that
// polarity's L1 plane, the L2, R1 and R2 planes `plane` elements apart;
// the planes hold rows [0, hs) and the pixel sits at row ys.
template <typename T>
__device__ __forceinline__ uint8_t brute_pixel(bool val, const T* __restrict__ l1, size_t plane,
                                               int w, int ys, int hs, int spread, float s_min,
                                               float s_max, int invert) {
  const T* l2 = l1 + plane;
  const T* r1 = l1 + 2 * plane;
  const T* r2 = l1 + 3 * plane;
  auto tap = [&](int yy, int a) -> int {
    const size_t o = (size_t)yy * w;
    const int dl1 = l1[o];
    const int dr1 = r1[o];
    // the diagonal |dx| == |dy| is never a candidate: take the next seed
    const int dl = dl1 != a ? dl1 : (int)l2[o];
    const int dr = dr1 != a ? dr1 : (int)r2[o];
    const int dx = min(dl, dr);
    return dx * dx + a * a;
  };
  int best = tap(ys, 0);
  const int reach = min(spread, max(ys, hs - 1 - ys));
  for (int a = 1; a <= reach; ++a) {
    if (a * a >= best) break;
    if (ys - a >= 0) best = min(best, tap(ys - a, a));
    if (ys + a < hs) best = min(best, tap(ys + a, a));
  }

  // OpenCL tail (sdf.cl:206-223)
  const bool found = best <= spread * spread;
  const float d = refined_sqrt_f32(__int2float_rn(best));
  const bool decider = (invert != 0) != val;
  const float big = (float)(2 * spread + 4);
  const float dist = found ? (decider ? d : -__fadd_rn(d, -1.0f)) : (decider ? big : -big);
  const float v = fmaxf(fminf(dist, s_max), s_min);
  const float remap = __fadd_rn(
      __fdiv_rn(__fmul_rn(__fsub_rn(v, s_min), 255.0f), __fsub_rn(s_max, s_min)), 0.0f);
  return (uint8_t)(int)remap;
}

// grid (ceil(W/64), ceil(H/4), N); block (64, 4): one thread per pixel.
template <typename T>
__global__ void __launch_bounds__(kScanTx * kScanTy)
brute_scan_bytes_kernel(const uint8_t* __restrict__ codes, const T* __restrict__ strips,
                        uint8_t* __restrict__ out, int n, int h, int w, int spread,
                        float s_min, float s_max, int invert) {
  const int x = blockIdx.x * kScanTx + threadIdx.x;
  const int y = blockIdx.y * kScanTy + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = (size_t)n * h * w;
  const size_t img = (size_t)blockIdx.z * h * w;
  const size_t pix = img + (size_t)y * w + x;
  const bool val = codes[pix] != 0;
  out[pix] = brute_pixel(val, strips + (val ? 4 : 0) * plane + img + x, plane, w, y, h, spread,
                         s_min, s_max, invert);
}

// grid (ceil(W/64), ceil(H_loc/4), N); block (64, 4): one thread per output
// pixel. codes and out are (N, h, W); the planes (2, 4, N, hs, W), the
// shard's row y at plane row y + row_off.
template <typename T>
__global__ void __launch_bounds__(kScanTx * kScanTy)
brute_scan_bytes_halo_kernel(const uint8_t* __restrict__ codes, const T* __restrict__ strips,
                             uint8_t* __restrict__ out, int n, int h, int hs, int w,
                             int row_off, int spread, float s_min, float s_max, int invert) {
  const int x = blockIdx.x * kScanTx + threadIdx.x;
  const int y = blockIdx.y * kScanTy + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = (size_t)n * hs * w;
  const size_t pix = (size_t)blockIdx.z * h * w + (size_t)y * w + x;
  const bool val = codes[pix] != 0;
  const T* l1 = strips + (val ? 4 : 0) * plane + (size_t)blockIdx.z * hs * w + x;
  out[pix] = brute_pixel(val, l1, plane, w, y + row_off, hs, spread, s_min, s_max, invert);
}

}  // namespace

// Launchers: plain C entry points for ctypes. Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

extern "C" int chaq_brute_rows(const void* codes, void* out, int n, int h, int w, int sent,
                               int elem_bytes, void* stream) {
  if (n < 1 || h < 1 || w < 1 || n > 65535 || sent < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)h, 1, (unsigned)n);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1 && sent <= 255) {
    brute_rows_kernel<uint8_t><<<grid, kRowThreads, 0, s>>>((const uint8_t*)codes,
                                                            (uint8_t*)out, n, h, w, sent);
  } else if (elem_bytes == 2 && sent <= 65535) {
    brute_rows_kernel<uint16_t><<<grid, kRowThreads, 0, s>>>((const uint8_t*)codes,
                                                             (uint16_t*)out, n, h, w, sent);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int chaq_brute_scan_bytes(const void* codes, const void* strips, void* out, int n,
                                     int h, int w, int spread, float s_min, float s_max,
                                     int invert, int elem_bytes, void* stream) {
  // 2 (spread + 1)^2 must fit int32
  if (n < 1 || h < 1 || w < 1 || n > 65535 || spread < 1 || spread > 32766) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kScanTx, kScanTy);
  const dim3 grid((unsigned)((w + kScanTx - 1) / kScanTx),
                  (unsigned)((h + kScanTy - 1) / kScanTy), (unsigned)n);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1 && spread + 1 <= 255) {
    brute_scan_bytes_kernel<uint8_t><<<grid, block, 0, s>>>(
        (const uint8_t*)codes, (const uint8_t*)strips, (uint8_t*)out, n, h, w, spread, s_min,
        s_max, invert);
  } else if (elem_bytes == 2) {
    brute_scan_bytes_kernel<uint16_t><<<grid, block, 0, s>>>(
        (const uint8_t*)codes, (const uint16_t*)strips, (uint8_t*)out, n, h, w, spread, s_min,
        s_max, invert);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// codes, out: (n, h, w); strips: (2, 4, n, hs, w) with the shard's rows
// from row_off on.
extern "C" int chaq_brute_scan_bytes_halo(const void* codes, const void* strips, void* out,
                                          int n, int h, int hs, int w, int row_off, int spread,
                                          float s_min, float s_max, int invert, int elem_bytes,
                                          void* stream) {
  if (n < 1 || h < 1 || w < 1 || n > 65535 || spread < 1 || spread > 32766 || row_off < 0 ||
      row_off + h > hs) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kScanTx, kScanTy);
  const dim3 grid((unsigned)((w + kScanTx - 1) / kScanTx),
                  (unsigned)((h + kScanTy - 1) / kScanTy), (unsigned)n);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1 && spread + 1 <= 255) {
    brute_scan_bytes_halo_kernel<uint8_t><<<grid, block, 0, s>>>(
        (const uint8_t*)codes, (const uint8_t*)strips, (uint8_t*)out, n, h, hs, w, row_off,
        spread, s_min, s_max, invert);
  } else if (elem_bytes == 2) {
    brute_scan_bytes_halo_kernel<uint16_t><<<grid, block, 0, s>>>(
        (const uint8_t*)codes, (const uint16_t*)strips, (uint8_t*)out, n, h, hs, w, row_off,
        spread, s_min, s_max, invert);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
