// BRUTE pipeline kernels for Hopper (sm_90a): the OpenCL binary's truncated
// per-pixel search (opencl/sdf.cl:79-224), byte-identical to it, as a row
// pass and a column scan.
//
// brute_rows<T> replaces chaq_sdfgen_tpu/ops/pallas_brute.py:_passa_kernel
//   (row_seed_distances_ext). Per image row, side and polarity, the distance
//   to the nearest seed (L1 at or left of x, R1 at or right of x) and to the
//   second-nearest seed on that side (L2, R2), each clipped at
//   sent = spread + 1: eight planes of T. Bound: bytes, 1 + 8 sizeof(T) B/px:
//   the row read once, the planes written once. Design: the warp walk of
//   row_words.cuh (K = 2): a warp a row (or a segment of one), 16 pixels a lane
//   and step from 16-byte loads kept as seed bitmasks; the two last seeds
//   before and the two first after each lane's chunk, per polarity, from
//   ballots, shuffles and clz/ffs, merged by the top-2 rule (the nearest of
//   both firsts, then the nearer of the other first and both seconds); each
//   plane's values computed in registers, two pixels a step, and stored
//   once, 16 bytes a store. The TPU kernel carries the gap to the previous
//   seed in the low bits of a packed max-scan (L2 = L1 + gap); the two
//   nearest indices give the same L2 without the packing. No transposes (a
//   row is contiguous on the card) and no halo rows: brute_scan_bytes reads
//   rows outside the image itself.
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
//   them. A walk costs taps: a pixel near a seed of the other polarity stops
//   after a few, one far from any walks up to spread rows each way.
//
// brute_scan_bytes_halo<T> replaces pallas_brute.py:_brute_kernel_halo_entry
//   (brute_sdf_bytes_pallas_halo, a shard of parallel/sharded.py): the same
//   per-pixel minimum and tail (as the TPU entry is a thin wrapper around
//   _brute_kernel_impl, pallas_brute.py:570-574) on planes that carry the
//   neighbouring shards' rows, a frame (2, 4, N, hs, W) with the shard's
//   own rows from row_off on. The sign comes from the shard's own codes
//   (N, H_loc, W), and only its H_loc rows are written. With row_off 0 and
//   hs = H_loc it is the one-device scan. Bound: bytes, as brute_scan_bytes.
//
// Both run one kernel, brute_scan_staged (PERF.md rows 15-16). The walks
// it chooses between:
//   * per pixel (brute_scan_pixel_kernel): |dy| = 1, 2, ... from device
//     memory, stopping once dy^2 >= the running minimum (dx^2 >= 0: no later
//     tap can lower it). Rows outside the frame are no taps (they read sent,
//     whose d^2 exceeds spread^2). Fast where walks are short (dense
//     content), but far from any seed of the other polarity every row
//     distance is clipped at spread + 1 and the walk runs all spread rows
//     each way, two dependent byte loads a tap.
//   * by segments (segment_walk), on a window of the frame staged in shared
//     memory: a block of 32 columns (one per lane) and 128 output rows (16
//     warps) stages rows [y0 - spread, y0 + 128 + spread) within [0, hs)
//     widened to whole 16-row segments of the frame, through 16-byte
//     cp.async copies where the rows allow, and keeps the least of the four
//     plane values per segment, column and polarity: every tap in a segment
//     is at least a^2 + m^2 (a the distance of its nearest row, m that least
//     value; dx >= min(L1, L2, R1, R2), on any planes). A pixel walks the
//     segments outward, one above and one below a step, skips one where a^2
//     + m^2 >= best and ends a side once a^2 >= best: far from strokes it is
//     done after its own row and a test per segment.
// The minimum is an integer, so the order of the taps does not matter and a
// skipped tap cannot lower it: every path is byte for byte the per-pixel
// walk. What the block does is chosen from its own codes, before it stages
// anything. A sparse or uniform block (under 1/8 or over 7/8 of its pixels
// set), where pixels lie far from the other polarity, stages its window at
// once, only the planes of the polarities its pixels search, and walks by
// segments. A dense block stages its core first, the rows within kCap of
// its output rows (about half its window), walks |dy| <= kCap per pixel
// there, writes the pixels that are done and, if all are, ends: on dense
// content no block stages more (either walk alone loses on one content or
// the other). What is left stages the rest of the window and goes on by
// segments from |dy| = kCap + 1. A capped walk from device memory instead
// lost to the per-pixel kernel on noise: byte loads of 8 pixels a lane,
// serialised by the diagonal rule's dependent loads, or too many of them
// when issued together (PERF.md).
// Where the largest window (min(hs, 128 + 2 spread + 30) rows of 256
// elements, up to 181 KB for uint8 at spread 253) exceeds a block's dynamic
// shared memory (the opt-in 227 KB less the kernel's static part, 232384 B
// on the H100), as uint16 frames of 440 rows or more do, the launcher takes
// the per-pixel walk.

// Exact numbers: the float tail is explicit _rn intrinsics in the plain
// version's order (ops/brute.py, ops/merge.py). Build without
// --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

#include "refined_sqrt.cuh"
#include "row_words.cuh"
#include "staged.cuh"

namespace {

namespace rw = row_words;
constexpr unsigned kFull = 0xffffffffu;

// One side of a chunk for one polarity: the distances of its 16 pixels to
// the nearest and second-nearest seed at or left of them (kLeft: L1, L2) or
// at or right (R1, R2), walked from the two nearest seeds beyond the chunk on
// that side (n1 the nearer), clipped at sent, two pixels a step
// (row_words.cuh's pairs; sent <= kPairMax): the nearest distance grows by
// one a pixel and is 0 at a seed, the second takes the nearest's grown value
// at a seed. Left to right the low half starts at pixel -1 and the high half
// at pixel 7 (from the chunk's first 8 pixels, or pixel -1's plus 8); right to
// left at pixel 8 and pixel 16.
template <bool kLeft>
__device__ __forceinline__ void side_pairs(uint32_t mp, const uint32_t* sel, int x0, int n1, int n2, int sent,
                                           uint32_t* d1, uint32_t* d2) {
  const int c1 = min(kLeft ? x0 - 1 - n1 : n1 - x0 - 16, sent), c2 = min(kLeft ? x0 - 1 - n2 : n2 - x0 - 16, sent);
  const uint32_t b = kLeft ? mp & 0xffu : mp >> 8;  // the 8 pixels that the other half starts after
  const int h1 = kLeft ? 31 - __clz(b) : __ffs(b) - 1;
  const uint32_t rest = kLeft ? b & ~(1u << (h1 & 31)) : b & (b - 1);
  const int h2 = kLeft ? 31 - __clz(rest) : __ffs(rest) - 1;
  const int s1 = b ? (kLeft ? 7 - h1 : h1) : c1 + 8;
  const int s2 = rest ? (kLeft ? 7 - h2 : h2) : b ? c1 + 8 : c2 + 8;
  uint32_t a1 = kLeft ? rw::pair(c1, s1) : rw::pair(s1, c1), a2 = kLeft ? rw::pair(c2, s2) : rw::pair(s2, c2);
  const uint32_t ss = rw::pair(sent, sent);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = kLeft ? k : 7 - k;
    const uint32_t p1 = a1 + 0x00010001u, p2 = a2 + 0x00010001u;
    a2 = (p2 & ~sel[i]) | (p1 & sel[i]);
    a1 = p1 & ~sel[i];
    d1[i] = __vminu2(a1, ss);
    d2[i] = __vminu2(a2, ss);
  }
}

// The epilogue of brute_rows (row_words.cuh's walk, K = 2): per polarity and
// side, a chunk's 16 pixels walked in registers from the two nearest seeds
// beyond it (left to right for L1, L2; right to left for R1, R2), two pixels a
// step; each plane's 16 values written once.
template <typename T>
struct RowsEpilogue {
  T* out;
  size_t plane;
  int w, sent, vec;

  __device__ __forceinline__ void operator()(long long j, long long e0, uint32_t m, const rw::Near& lo,
                                             const rw::Near& hi) const {
    const int x0 = (int)(j * rw::kChunk - e0);
    uint32_t sel[8], d1[8], d2[8];
#pragma unroll
    for (int pol = 0; pol < 2; ++pol) {
      const uint32_t mp = m >> (16 * pol) & 0xffffu;
      T* dst = out + 4 * pol * plane;
      rw::step_masks(mp, sel);
      side_pairs<true>(mp, sel, x0, pol ? lo.f[0] : lo.t[0], pol ? lo.f[1] : lo.t[1], sent, d1, d2);
      rw::put_pairs(dst, j, d1, e0, w, vec);
      rw::put_pairs(dst + plane, j, d2, e0, w, vec);
      side_pairs<false>(mp, sel, x0, pol ? hi.f[0] : hi.t[0], pol ? hi.f[1] : hi.t[1], sent, d1, d2);
      rw::put_pairs(dst + 2 * plane, j, d1, e0, w, vec);
      rw::put_pairs(dst + 3 * plane, j, d2, e0, w, vec);
    }
  }
};

// A warp a row segment (row_words.cuh). out: planes (polarity, side) of (N, H,
// W): 0-3 are L1, L2, R1, R2 of the TRUE seeds (code 1), 4-7 of the FALSE seeds
// (code 0). vec: the codes and every plane start 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(rw::kThreads)
brute_rows_kernel(const uint8_t* __restrict__ codes, T* __restrict__ out, long long nrows, int w, int sent,
                  int steps, int segs, int vec) {
  RowsEpilogue<T> emit{out, (size_t)nrows * w, w, sent, vec};
  rw::walk<2>(codes, nrows, w, sent, steps, segs, vec, emit);
}

// brute_rows on the (nrows, w) codes: segments and grid from row_words.cuh.
template <typename T>
int rows_launch(const void* codes, void* out, long long nrows, int w, int sent, cudaStream_t s) {
  static int resident[64] = {};
  int steps = 0, segs = 0;
  unsigned grid = 0;
  rw::segments(nrows, w, &steps, &segs);
  const int e = rw::grid_of(brute_rows_kernel<T>, nrows, segs, &grid, resident);
  if (e != 0) return e;
  const int vec = ((size_t)codes | (size_t)out | (size_t)nrows * w * sizeof(T)) % 16 == 0;
  brute_rows_kernel<T><<<grid, rw::kThreads, 0, s>>>((const uint8_t*)codes, (T*)out, nrows, w, sent, steps, segs,
                                                      vec);
  return (int)cudaGetLastError();
}

constexpr int kScanTx = 64;
constexpr int kScanTy = 4;

// The OpenCL tail (sdf.cl:206-223) of a pixel whose search found the squared
// distance best.
__device__ __forceinline__ uint8_t opencl_tail(int best, bool val, int spread, float s_min, float s_max,
                                               int invert) {
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

// One tap: dx^2 + a^2 at the row whose L1 value is l1[0], the L2, R1 and R2
// values `plane` elements apart. The diagonal |dx| == |dy| = a is never a
// candidate (the OpenCL search never probes it, sdf.cl:131-183), so a side
// whose nearest seed sits there takes its second.
template <typename T>
__device__ __forceinline__ int plane_tap(const T* __restrict__ l1, size_t plane, int a) {
  const int dl1 = l1[0], dr1 = l1[2 * plane];
  const int dl = dl1 != a ? dl1 : (int)l1[plane];
  const int dr = dr1 != a ? dr1 : (int)l1[3 * plane];
  const int dx = min(dl, dr);
  return dx * dx + a * a;
}

// grid (ceil(W/64), ceil(H_loc/4), N); block (64, 4): one thread per output
// pixel. codes and out are (N, h, W); the planes (2, 4, N, hs, W), the
// shard's row y at plane row y + row_off (one device: row_off 0, hs = h).
// The pixel walks |dy| = 1, 2, ... from device memory and stops once dy^2 >=
// its running minimum.
template <typename T>
__global__ void __launch_bounds__(kScanTx * kScanTy)
brute_scan_pixel_kernel(const uint8_t* __restrict__ codes, const T* __restrict__ strips,
                        uint8_t* __restrict__ out, int n, int h, int hs, int w, int row_off,
                        int spread, float s_min, float s_max, int invert) {
  const int x = blockIdx.x * kScanTx + threadIdx.x;
  const int y = blockIdx.y * kScanTy + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = (size_t)n * hs * w;
  const size_t pix = (size_t)blockIdx.z * h * w + (size_t)y * w + x;
  const bool val = codes[pix] != 0;
  // the pixel searches the seeds of the other polarity (sdf.cl:201)
  const T* l1 = strips + (val ? 4 : 0) * plane + (size_t)blockIdx.z * hs * w + x;
  const int ys = y + row_off;
  int best = plane_tap(l1 + (size_t)ys * w, plane, 0);
  const int reach = min(spread, max(ys, hs - 1 - ys));
  for (int a = 1; a <= reach; ++a) {
    if (a * a >= best) break;
    if (ys - a >= 0) best = min(best, plane_tap(l1 + (size_t)(ys - a) * w, plane, a));
    if (ys + a < hs) best = min(best, plane_tap(l1 + (size_t)(ys + a) * w, plane, a));
  }
  out[pix] = opencl_tail(best, val, spread, s_min, s_max, invert);
}

// ------------------------------------------------------ the staged kernels

constexpr int kHaloLanes = 32;   // columns per block, one per lane
constexpr int kHaloWarps = 16;
constexpr int kHaloThreads = kHaloWarps * kHaloLanes;
constexpr int kHaloRows = 128;   // output rows per block
constexpr int kPerLane = kHaloRows / kHaloWarps;  // output rows per lane: y0 + warp + 16 i
constexpr int kHaloSeg = 16;     // window rows per segment minimum
constexpr int kRowElems = 8 * kHaloLanes;  // a window row: the eight planes' 32 columns
constexpr int kCap = 8;          // brute_scan_staged: rows each way of a dense block's capped walk
static_assert(kPerLane <= 32, "a lane's pixels fit one word of bits");

__device__ __forceinline__ uint32_t vmin_packed(uint32_t a, uint32_t b, int elem_bytes) {
  return elem_bytes == 1 ? __vminu4(a, b) : __vminu2(a, b);
}

// A block's window of the frame: rows [wlo, wlo + nrows), its output rows
// [y0, y1) widened by the spread within [0, hs) and to whole 16-row segments
// of the frame.
struct Window {
  int wlo, nrows, nseg;
};

__device__ __forceinline__ Window block_window(int y0, int y1, int row_off, int spread, int hs) {
  Window wd;
  wd.wlo = max(0, y0 + row_off - spread) / kHaloSeg * kHaloSeg;
  const int whi = min(hs, (y1 + row_off + spread + kHaloSeg - 1) / kHaloSeg * kHaloSeg);
  wd.nrows = whi - wd.wlo;
  wd.nseg = (wd.nrows + kHaloSeg - 1) / kHaloSeg;
  return wd;
}

// Stage window rows [r0, r1) of the block's window, planes [k0, k1) of the
// eight (4 p .. 4 p + 3: polarity p) of its 32 columns, into win (window row
// r, plane k at win + (r * 8 + k) * 32), and wait for them; ends with
// __syncthreads. base: the image's planes from column x0. vec: 16-byte
// copies (rows of W sizeof(T) bytes a multiple of 16, the planes 16-byte
// aligned); else element by element. Columns past W are never read.
template <typename T>
__device__ __forceinline__ void stage_rows(T* win, const T* __restrict__ base, size_t plane, int w, int x0, int wlo,
                                           int r0, int r1, int k0, int k1, int vec) {
  const int nk = k1 - k0;
  if (vec) {
    constexpr int kVec = 16 / sizeof(T), kPerPlane = kHaloLanes / kVec;  // copies per plane row
    for (int e = threadIdx.x; e < (r1 - r0) * nk * kPerPlane; e += kHaloThreads) {
      const int r = r0 + e / (nk * kPerPlane), k = k0 + (e / kPerPlane) % nk, c = (e % kPerPlane) * kVec;
      if (x0 + c < w) cp_async16(win + (r * 8 + k) * kHaloLanes + c, base + k * plane + (size_t)(wlo + r) * w + c);
    }
    cp_commit();
    cp_wait_all();
  } else {
    for (int e = threadIdx.x; e < (r1 - r0) * nk * kHaloLanes; e += kHaloThreads) {
      const int r = r0 + e / (nk * kHaloLanes), k = k0 + (e / kHaloLanes) % nk, c = e % kHaloLanes;
      if (x0 + c < w) win[(r * 8 + k) * kHaloLanes + c] = base[k * plane + (size_t)(wlo + r) * w + c];
    }
  }
  __syncthreads();
}

// The least of the four planes per segment of the staged window, column and
// polarity p in [p0, p1) into segm (segment s, polarity p at segm + (s * 2 +
// p) * 32); ends with __syncthreads. A thread takes 32 bits of columns of
// one segment and polarity, the least over its rows and four planes.
template <typename T>
__device__ __forceinline__ void segment_minima(const T* win, int* segm, const Window& wd, int p0, int p1) {
  constexpr int kPer = 4 / sizeof(T), kWords = kHaloLanes / kPer;  // columns per word, words per plane row
  const uint32_t* win32 = (const uint32_t*)win;
  const int np = p1 - p0;
  for (int e = threadIdx.x; e < wd.nseg * np * kWords; e += kHaloThreads) {
    const int s = e / (np * kWords), p = p0 + (e / kWords) % np, q = e % kWords;
    const int r_end = min((s + 1) * kHaloSeg, wd.nrows);
    uint32_t m = 0xffffffffu;
    for (int r = s * kHaloSeg; r < r_end; ++r) {
      const uint32_t* row = win32 + (r * 8 + 4 * p) * kWords + q;
#pragma unroll
      for (int k = 0; k < 4; ++k) m = vmin_packed(m, row[k * kWords], (int)sizeof(T));
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      segm[(s * 2 + p) * kHaloLanes + q * kPer + i] = (int)((m >> (8 * sizeof(T) * i)) & ((1u << (8 * sizeof(T))) - 1));
  }
  __syncthreads();
}

// The segment walk of the pixel at window row c, from its running minimum
// best: rows [lo, ub] above it and [db, hi] below, nearest first. col: its
// column of its polarity's L1 plane in the window (window row r, plane k at
// col[(r * 8 + k) * 32]); sm: that column's and polarity's segment minima
// (segment s at sm[s * 64]). Segments go outward, one above and one below a
// step. Every tap of a segment is at least a^2 + m^2 (a its nearest row's
// distance, m its least plane value: dx >= min(L1, L2, R1, R2)); a segment
// where that cannot lower best is skipped, and a side ends where a^2 alone
// cannot.
template <typename T>
__device__ __forceinline__ int segment_walk(const T* col, const int* sm, int c, int lo, int ub, int db, int hi,
                                            int best) {
  auto tap = [&](int r, int a) { return plane_tap(col + r * kRowElems, kHaloLanes, a); };
  int su = ub >= lo ? ub / kHaloSeg : 0, sd = db / kHaloSeg;
  bool up = ub >= lo, dn = db <= hi;
  while (up || dn) {
    if (up) {
      const int top = max(su * kHaloSeg, lo), bot = min(su * kHaloSeg + kHaloSeg - 1, ub);
      const int a0 = c - bot, m = sm[su * 2 * kHaloLanes];
      if (a0 * a0 >= best) {
        up = false;
      } else if (a0 * a0 + m * m < best) {
        for (int r = bot; r >= top; --r) {
          const int a = c - r;
          if (a * a >= best) {
            up = false;
            break;
          }
          best = min(best, tap(r, a));
        }
      }
      up = up && su * kHaloSeg > lo;
      --su;
    }
    if (dn) {
      const int top = max(sd * kHaloSeg, db), bot = min(sd * kHaloSeg + kHaloSeg - 1, hi);
      const int a0 = top - c, m = sm[sd * 2 * kHaloLanes];
      if (a0 * a0 >= best) {
        dn = false;
      } else if (a0 * a0 + m * m < best) {
        for (int r = top; r <= bot; ++r) {
          const int a = r - c;
          if (a * a >= best) {
            dn = false;
            break;
          }
          best = min(best, tap(r, a));
        }
      }
      dn = dn && sd * kHaloSeg + kHaloSeg - 1 < hi;
      ++sd;
    }
  }
  return best;
}

// v[i] for an i known only at run time, without moving v out of registers.
template <int N>
__device__ __forceinline__ int pick(const int (&v)[N], int i) {
  int r = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) r = i == k ? v[k] : r;
  return r;
}

// v[i] = x for an i known only at run time, v staying in registers.
template <int N>
__device__ __forceinline__ void put(int (&v)[N], int i, int x) {
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = i == k ? x : v[k];
}

// grid (ceil(W/32), ceil(H_loc/128), N); block 512: 32 columns (one per lane)
// and 128 output rows (warp w takes rows w, w + 16, ...) of one image, the
// shard's row y at frame row y + row_off. The block counts its set pixels
// and takes one of two paths (the header above): a sparse or uniform block
// stages its window at once and walks by segments from each pixel's own
// row; a dense block stages its core, walks |dy| <= kCap per pixel, and
// stages the rest only for the pixels left, which go on by segments.
template <typename T>
__global__ void __launch_bounds__(kHaloThreads)
brute_scan_staged(const uint8_t* __restrict__ codes, const T* __restrict__ strips,
                  uint8_t* __restrict__ out, int n, int h, int hs, int w, int row_off,
                  int spread, float s_min, float s_max, int invert, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tx = threadIdx.x % kHaloLanes, wp = threadIdx.x / kHaloLanes;
  const int x0 = blockIdx.x * kHaloLanes, x = x0 + tx;
  const int y0 = blockIdx.y * kHaloRows, y1 = min(y0 + kHaloRows, h);
  const size_t plane = (size_t)n * hs * w;
  const T* base = strips + (size_t)blockIdx.z * hs * w + x0;
  const Window wd = block_window(y0, y1, row_off, spread, hs);
  T* win = (T*)smem_raw;
  int* segm = (int*)(win + (size_t)wd.nrows * kRowElems);
  auto pixel = [&](int y) { return ((size_t)blockIdx.z * h + y) * w + x; };

  // this lane's pixel values (bit i: row y0 + wp + 16 i), loaded together
  uint32_t vals = 0;
  if (x < w) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int y = y0 + wp + kHaloWarps * i;
      if (y < y1 && codes[pixel(y)] != 0) vals |= 1u << i;
    }
  }
  __shared__ int warp_ones[kHaloWarps];
  const int lane_ones = __reduce_add_sync(kFull, __popc(vals));
  if (tx == 0) warp_ones[wp] = lane_ones;
  __syncthreads();
  int ones = 0;
#pragma unroll
  for (int k = 0; k < kHaloWarps; ++k) ones += warp_ones[k];
  const int npix = (y1 - y0) * min(kHaloLanes, w - x0);

  if (8 * ones < npix || 8 * ones > 7 * npix) {
    // a pixel of value v searches polarity v's planes (sdf.cl:201)
    const int p0 = ones == npix ? 1 : 0, p1 = ones == 0 ? 1 : 2;
    stage_rows(win, base, plane, w, x0, wd.wlo, 0, wd.nrows, 4 * p0, 4 * p1, vec);
    segment_minima(win, segm, wd, p0, p1);
    if (x >= w) return;
    for (int i = 0, y = y0 + wp; y < y1; ++i, y += kHaloWarps) {
      const bool val = (vals >> i) & 1u;
      const T* col = win + (val ? 4 : 0) * kHaloLanes + tx;
      const int c = y + row_off - wd.wlo;  // the pixel's window row
      int best = plane_tap(col + c * kRowElems, kHaloLanes, 0);
      // no row at a >= 1 lowers best <= 1
      if (best > 1)
        best = segment_walk(col, segm + (val ? kHaloLanes : 0) + tx, c, max(c - spread, 0), c - 1, c + 1,
                            min(c + spread, wd.nrows - 1), best);
      out[pixel(y)] = opencl_tail(best, val, spread, s_min, s_max, invert);
    }
    return;
  }

  // the core, window rows [k0, k1): the walk below reads |dy| <= min(kCap, spread)
  const int k0 = max(y0 + row_off - kCap - wd.wlo, 0), k1 = min(y1 + row_off + kCap - wd.wlo, wd.nrows);
  stage_rows(win, base, plane, w, x0, wd.wlo, k0, k1, 0, 8, vec);
  uint32_t open = 0;  // bit i: the pixel goes on past |dy| = kCap
  int best[kPerLane] = {};
  if (x < w) {
#pragma unroll 1
    for (int i = 0, y = y0 + wp; y < y1; ++i, y += kHaloWarps) {
      const bool val = (vals >> i) & 1u;
      const T* col = win + (val ? 4 : 0) * kHaloLanes + tx;
      const int c = y + row_off, cw = c - wd.wlo;  // frame and window rows
      const int lim = min(spread, max(c, hs - 1 - c));
      int b = plane_tap(col + cw * kRowElems, kHaloLanes, 0), a = 1;
      for (; a <= kCap && a <= lim; ++a) {
        if (a * a >= b) break;
        if (c - a >= 0) b = min(b, plane_tap(col + (cw - a) * kRowElems, kHaloLanes, a));
        if (c + a < hs) b = min(b, plane_tap(col + (cw + a) * kRowElems, kHaloLanes, a));
      }
      if (a * a >= b || a > lim) {  // done: no row at |dy| >= a lowers b, or none is left
        out[pixel(y)] = opencl_tail(b, val, spread, s_min, s_max, invert);
      } else {
        open |= 1u << i;
        put(best, i, b);
      }
    }
  }
  if (!__syncthreads_or(open != 0)) return;

  stage_rows(win, base, plane, w, x0, wd.wlo, 0, k0, 0, 8, vec);
  stage_rows(win, base, plane, w, x0, wd.wlo, k1, wd.nrows, 0, 8, vec);
  segment_minima(win, segm, wd, 0, 2);
#pragma unroll 1
  for (int i = 0; i < kPerLane; ++i) {
    if (!((open >> i) & 1u)) continue;
    const bool val = (vals >> i) & 1u;
    const int y = y0 + wp + kHaloWarps * i, cw = y + row_off - wd.wlo;
    const int b = segment_walk(win + (val ? 4 : 0) * kHaloLanes + tx, segm + (val ? kHaloLanes : 0) + tx, cw,
                               max(cw - spread, 0), cw - kCap - 1, cw + kCap + 1, min(cw + spread, wd.nrows - 1),
                               pick(best, i));
    out[pixel(y)] = opencl_tail(b, val, spread, s_min, s_max, invert);
  }
}

// The staged kernels' shared memory for windows of up to `rows` rows.
template <typename T>
size_t staged_smem(int rows) {
  return (size_t)rows * kRowElems * sizeof(T) + (size_t)((rows + kHaloSeg - 1) / kHaloSeg) * 2 * kHaloLanes * sizeof(int);
}

// A scan of frames (N, hs, W) into (N, h, W): brute_scan_staged where its
// largest window fits a block's shared memory, else the per-pixel walk from
// device memory.
template <typename T>
int scan(const uint8_t* codes, const T* strips, uint8_t* out, int n, int h, int hs, int w, int row_off,
         int spread, float s_min, float s_max, int invert, cudaStream_t s) {
  const int rows = kHaloRows + 2 * spread + 2 * (kHaloSeg - 1);  // a window's most rows
  const size_t smem = staged_smem<T>(hs < rows ? hs : rows);
  static size_t limit_cache[64] = {};  // per device: the dynamic shared memory a block may take
  size_t limit = 0;
  int e = dyn_smem_limit(brute_scan_staged<T>, limit_cache, &limit);
  if (e != 0) return e;
  if (smem <= limit) {
    static size_t allowed[64] = {};  // per device: the dynamic shared memory the kernel may take
    e = allow_smem(brute_scan_staged<T>, smem, allowed);
    if (e != 0) return e;
    const int vec = (w * (int)sizeof(T)) % 16 == 0 && (size_t)strips % 16 == 0;
    const dim3 grid((unsigned)((w + kHaloLanes - 1) / kHaloLanes),
                    (unsigned)((h + kHaloRows - 1) / kHaloRows), (unsigned)n);
    brute_scan_staged<T><<<grid, kHaloThreads, smem, s>>>(codes, strips, out, n, h, hs, w, row_off, spread, s_min,
                                                          s_max, invert, vec);
  } else {
    const dim3 block(kScanTx, kScanTy);
    const dim3 grid((unsigned)((w + kScanTx - 1) / kScanTx),
                    (unsigned)((h + kScanTy - 1) / kScanTy), (unsigned)n);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    brute_scan_pixel_kernel<T><<<grid, block, 0, s>>>(codes, strips, out, n, h, hs, w, row_off, spread, s_min,
                                                       s_max, invert);
  }
  return (int)cudaGetLastError();
}

// The scan for elem_bytes: uint8 planes while spread + 1 fits, else uint16.
int scan_any(int elem_bytes, const void* codes, const void* strips, void* out, int n, int h, int hs, int w,
             int row_off, int spread, float s_min, float s_max, int invert, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1 && spread + 1 <= 255) {
    return scan<uint8_t>((const uint8_t*)codes, (const uint8_t*)strips, (uint8_t*)out, n, h, hs, w, row_off,
                         spread, s_min, s_max, invert, s);
  }
  if (elem_bytes == 2) {
    return scan<uint16_t>((const uint8_t*)codes, (const uint16_t*)strips, (uint8_t*)out, n, h, hs, w, row_off,
                          spread, s_min, s_max, invert, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launchers: plain C entry points for ctypes. Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

extern "C" int chaq_brute_rows(const void* codes, void* out, int n, int h, int w, int sent,
                               int elem_bytes, void* stream) {
  if (n < 1 || h < 1 || w < 1 || n > 65535 || sent < 1) return (int)cudaErrorInvalidValue;
  const long long nrows = (long long)n * h;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1 && sent <= 255) return rows_launch<uint8_t>(codes, out, nrows, w, sent, s);
  if (elem_bytes == 2 && sent <= rw::kPairMax) return rows_launch<uint16_t>(codes, out, nrows, w, sent, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int chaq_brute_scan_bytes(const void* codes, const void* strips, void* out, int n,
                                     int h, int w, int spread, float s_min, float s_max,
                                     int invert, int elem_bytes, void* stream) {
  // 2 (spread + 1)^2 must fit int32
  if (n < 1 || h < 1 || w < 1 || n > 65535 || spread < 1 || spread > 32766) {
    return (int)cudaErrorInvalidValue;
  }
  return scan_any(elem_bytes, codes, strips, out, n, h, h, w, 0, spread, s_min, s_max, invert, stream);
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
  return scan_any(elem_bytes, codes, strips, out, n, h, hs, w, row_off, spread, s_min, s_max, invert, stream);
}
