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
//   Code 2 seeds neither field. Bound: bytes, 1 + 2 sizeof(T) B/px: the codes
//   read once, both strips written once. Design: the warp walk of
//   row_words.cuh (K = 1): a warp a row (or a segment of one), 16 pixels a lane
//   and step from 16-byte loads kept as seed bitmasks, the last seed before and
//   the first after each lane's chunk from ballots, shuffles and clz/ffs; each
//   pixel's min(x - L, R - x, clip) computed in registers, two pixels a step,
//   and both strips stored once, 16 bytes a store. No transposes: a row is
//   contiguous on the card.
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
//   leaves the strip; a single device passes row_off 0 and out_rows H.
//   Bound: bytes, 2 sizeof(T) + 1 B/px; a linear-time lower envelope needs
//   ~55 operations per pixel, under them. A walk costs taps: a pixel near a
//   seed of a field stops after a few, one far from any would read the
//   whole band.
//   Design: edt_band_staged (PERF.md rows 2 and 4), the design of
//   brute.cu's brute_scan_staged without the diagonal rule. A block owns 32
//   columns (one per lane) and 128 output rows (16 warps, a lane every
//   16th row) and stages, of both strips, the window rows [y0 +
//   row_off - band, y0 + row_off + 128 + band) within [0, h), widened to
//   whole 16-row segments of the strip, through 16-byte cp.async copies
//   where the rows allow. It first stages the core, the rows within kCap of
//   its output rows, and counts its near pixels (both fields' own row
//   values at most kCap). A dense block (at least 7/8 near, as on noise)
//   walks |dy| <= kCap per pixel from the core, all its lane's rows and
//   fields as independent chains, writes the pixels that are done and, if
//   all are, ends without staging more (the same walk from device memory
//   lost on noise, as brute_scan_staged's did). Any other block, and a
//   dense one with pixels left, stages the rest of the window and keeps
//   per column, field and segment the least clipped value m: every tap in
//   a segment is at least a^2 + m^2 (a the |dy| of its nearest row). Each
//   open field of a pixel (the one further from its seeds first) walks the
//   segments outward from |dy| 1 (or kCap + 1), one above and one below a step,
//   skips a segment where a^2 + m^2 >= best, reads a live one's rows
//   nearest first in chunks of kChunk independent taps until a chunk's
//   first a^2 >= best, and ends a side there or past the band: far from
//   strokes a pixel is done after its own rows and about 2 band / 16
//   segment tests. The bound is formed with the taps' own _rn operations in
//   their order (fl(fl(m m) + fl(a a))); rounding is monotone, so a skipped
//   segment or row cannot lower best even where d^2 passes 2^24, and since
//   every tap taken is one of the plain version's, the bytes are its.
//   Past a block's shared memory the launcher takes the per-pixel walk
//   (edt_band_pixel: one thread per pixel walks dy = 1, 2, ... from device
//   memory until dy^2 >= its minimum). The window holds min(h, 128 + 2 band
//   + 30) rows of 64 sizeof(T) bytes plus 256 B a 16-row segment of minima,
//   and a block may take the opt-in 227 KB less the kernel's 64 B of static
//   shared memory (232384 B on the H100; band_path asks the device): uint8
//   strips always stage (band <= 253), uint16 strips up to band 727 or of
//   at most 1613 rows, int32 strips (band >= 65535) only of at most 853
//   rows. chaq_edt_band_staged answers for a shape (cuda_edt.pass2_staged).
//
// edt_dist replaces chaq_sdfgen_tpu/ops/pallas_edt.py:_dist_kernel
//   (exact_distance_field): the exact full-range distance to the nearest
//   seed. Per pixel, D = min over all dy of dy^2 + min(d(y+dy), sat)^2 on
//   the u16 row-distance strip of edt_rows (clipped at the saturation tier
//   sat), in int32 (D reaches ~8e8, beyond float32's exact integers); rows
//   outside the image are no taps; D >= sat^2 reads 32768.0 (no seed);
//   elsewhere the correctly rounded sqrt of D rounded to float32
//   (__int2float_rn, as JAX's astype). Bound: bytes, 6 B/px (u16 in,
//   float32 out); a linear-time lower envelope needs ~40 operations per
//   pixel, well under them.
//   Design: two launches, on tiles of 32 columns x 128 rows (edt_band_staged's
//   walk with the band equal to the image). edt_dist_core stages each
//   tile's core (its rows and kCap each side); a dense tile (7/8 of its own
//   values at most kCap, as on noise or the glyph's "out" strip) walks
//   |dy| <= kCap per pixel and writes the pixels that are done. Every tile
//   writes the least min(d, sat) of each of its 16-row segments into a (N,
//   ceil(H/16), W) uint16 table (the TPU kernel's seg_ref, kept per column:
//   its rows are in the core, so the table costs no read of its own) and a
//   flag per tile: done, sparse, or dense with pixels left. edt_dist_staged
//   returns at once on a tile done; another stages a window of kDistHalo
//   rows each side (a dense one its core first, to walk |dy| <= kCap again)
//   and its columns' whole table (16 KB at 4096 rows), and each pixel left
//   tests segments outward (a^2 + m^2 >= best skips one, a^2 >= best ends a
//   side) and reads a live segment's rows in chunks from the window or,
//   beyond it, from device memory. The arithmetic is the exact integer
//   minimum, so the order of taps does not matter; the sqrt of a minimum
//   below 2^24 - 1 is the IEEE one (see dist_tail). The table and the window
//   always fit: the launchers' limit sat^2 + (h-1)^2 < 2^31 keeps h <=
//   46341, 201 KB.
//
// Exact numbers: every float op that matters is an explicit _rn intrinsic,
// so nvcc cannot contract a multiply and an add into an FMA (which would
// break the Veltkamp split of the sqrt refinement), and the remap divides
// with IEEE rounding. Build without --use_fast_math.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "refined_sqrt.cuh"
#include "row_words.cuh"
#include "staged.cuh"

namespace {

namespace rw = row_words;
constexpr unsigned kFull = 0xffffffffu;

// The epilogue of edt_rows (row_words.cuh's walk, K = 1), per polarity: a
// chunk's 16 pixels walked left to right from the last seed before the chunk,
// then right to left from the first after it, in registers; each pixel's
// min(x - L, R - x, clip) written once. Up to a clip of kPairMax the walk
// takes two pixels a step (row_words.cuh's pairs): a distance grows by one a
// pixel and is 0 at a seed, d = (d + 0x10001) & ~sel, from the distance at
// pixel -1 (low half) and at pixel 7 (high half; from the chunk's first 8
// pixels, or pixel -1's plus 8) left to right, from pixel 8 and pixel 16
// right to left, then the two halves' minimum and the clip. Past it (int32
// strips, uint16 clips above 65519) a pixel a step.
template <typename T>
struct RowsEpilogue {
  T* din;
  T* dout;
  int w, clip, vec;

  __device__ __forceinline__ void operator()(long long j, long long e0, uint32_t m, const rw::Near& lo,
                                             const rw::Near& hi) const {
    const int x0 = (int)(j * rw::kChunk - e0);
    if (sizeof(T) == 4 || clip > rw::kPairMax) {
#pragma unroll
      for (int pol = 0; pol < 2; ++pol) {
        const uint32_t mp = m >> (16 * pol) & 0xffffu;
        int d[rw::kChunk];
        int n = pol ? lo.f[0] : lo.t[0];
#pragma unroll
        for (int i = 0; i < rw::kChunk; ++i) {
          if (mp >> i & 1u) n = x0 + i;
          d[i] = x0 + i - n;
        }
        n = pol ? hi.f[0] : hi.t[0];
#pragma unroll
        for (int i = rw::kChunk - 1; i >= 0; --i) {
          if (mp >> i & 1u) n = x0 + i;
          d[i] = min(min(d[i], n - x0 - i), clip);
        }
        rw::put_chunk(pol ? dout : din, j, d, e0, w, vec);
      }
      return;
    }
    if constexpr (sizeof(T) < 4) {
      const uint32_t cc = rw::pair(clip, clip);
#pragma unroll
      for (int pol = 0; pol < 2; ++pol) {
        const uint32_t mp = m >> (16 * pol) & 0xffffu;
        uint32_t sel[8], f[8];
        rw::step_masks(mp, sel);
        const int cl = min(x0 - 1 - (pol ? lo.f[0] : lo.t[0]), clip);
        const uint32_t b = mp & 0xffu;
        uint32_t d = rw::pair(cl, b ? __clz(b) - 24 : cl + 8);  // 7 - the last seed of pixels 0-7
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = d = (d + 0x00010001u) & ~sel[i];
        const int cr = min((pol ? hi.f[0] : hi.t[0]) - x0 - 16, clip);
        const uint32_t b2 = mp >> 8;
        d = rw::pair(b2 ? __ffs(b2) - 1 : cr + 8, cr);  // the first seed of pixels 8-15, less 8
#pragma unroll
        for (int i = 7; i >= 0; --i) {
          d = (d + 0x00010001u) & ~sel[i];
          f[i] = __vminu2(__vminu2(f[i], d), cc);
        }
        rw::put_pairs(pol ? dout : din, j, f, e0, w, vec);
      }
    }
  }
};

// A warp a row segment (row_words.cuh); vec: the codes and both strips start
// 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(rw::kThreads)
edt_rows_kernel(const uint8_t* __restrict__ codes, T* __restrict__ din, T* __restrict__ dout, long long nrows,
                int w, int clip, int steps, int segs, int vec) {
  RowsEpilogue<T> emit{din, dout, w, clip, vec};
  rw::walk<1>(codes, nrows, w, clip, steps, segs, vec, emit);
}

// edt_rows on the (nrows, w) codes: segments and grid from row_words.cuh.
template <typename T>
int rows_launch(const void* codes, void* din, void* dout, long long nrows, int w, int clip, cudaStream_t s) {
  static int resident[64] = {};
  int steps = 0, segs = 0;
  unsigned grid = 0;
  rw::segments(nrows, w, &steps, &segs);
  const int e = rw::grid_of(edt_rows_kernel<T>, nrows, segs, &grid, resident);
  if (e != 0) return e;
  const int vec = ((size_t)codes | (size_t)din | (size_t)dout) % 16 == 0;
  edt_rows_kernel<T><<<grid, rw::kThreads, 0, s>>>((const uint8_t*)codes, (T*)din, (T*)dout, nrows, w, clip, steps,
                                                    segs, vec);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- pass 2 (band)

// fl(min(v, clip)^2), the plain version's g: the float of the clipped value,
// squared with one rounding.
template <typename T>
__device__ __forceinline__ float sq_clip(T v, int clip) {
  const float d = (float)min((int)v, clip);
  return __fmul_rn(d, d);
}

// fl(a^2) of a tap's |dy|.
__device__ __forceinline__ float sq_dy(int a) {
  const float f = (float)a;
  return __fmul_rn(f, f);
}

// The signed merge (openmp/sdfgen.c:98-106) and the clamped remap (75-96)
// of a pixel's two fields, after the correctly rounded sqrt unless the
// image is a single row.
__device__ __forceinline__ uint8_t band_tail(float d_in, float d_out, int apply_sqrt, float s_min,
                                             float s_max) {
  if (apply_sqrt) {
    d_in = refined_sqrt_f32(d_in);
    d_out = refined_sqrt_f32(d_out);
  }
  const float biased = d_in > 0.0f ? __fadd_rn(d_in, -1.0f) : d_in;
  const float vals = __fsub_rn(d_out, biased);
  const float v = fmaxf(fminf(vals, s_max), s_min);
  const float remap = __fadd_rn(
      __fdiv_rn(__fmul_rn(__fsub_rn(v, s_min), 255.0f), __fsub_rn(s_max, s_min)), 0.0f);
  return (uint8_t)(int)remap;
}

// D = min over |dy| <= band of dy^2 + g(y+dy) for the column that `col`
// points into (row stride w), read from device memory. Beyond max(y, h - 1
// - y) both taps lie outside the strip: they read big >= best and cannot
// lower it, so the walk stops there too.
template <typename T>
__device__ __forceinline__ float band_min_at(const T* __restrict__ col, int h, int w, int y,
                                             int band) {
  const int clip = band + 1;
  const float big = sq_dy(clip);
  auto g = [&](int yy) -> float { return yy < 0 || yy >= h ? big : sq_clip(col[(size_t)yy * w], clip); };
  float best = g(y);
  const int reach = min(band, max(y, h - 1 - y));
  for (int dy = 1; dy <= reach; ++dy) {
    const float dy2 = sq_dy(dy);
    if (dy2 >= best) break;
    best = fminf(best, __fadd_rn(fminf(g(y - dy), g(y + dy)), dy2));
  }
  return best;
}

constexpr int kBandTx = 64;
constexpr int kBandTy = 4;

// grid (ceil(W/64), ceil(out_rows/4), N); block (64, 4): one thread per
// output pixel walks from device memory (the shapes past a block's shared
// memory, see the header). The strips are (N, h, W), the output (N,
// out_rows, W).
template <typename T>
__global__ void __launch_bounds__(kBandTx * kBandTy)
edt_band_pixel(const T* __restrict__ din, const T* __restrict__ dout, uint8_t* __restrict__ out,
               int h, int w, int row_off, int out_rows, int band, float s_min, float s_max,
               int apply_sqrt) {
  const int x = blockIdx.x * kBandTx + threadIdx.x;
  const int y = blockIdx.y * kBandTy + threadIdx.y;
  if (x >= w || y >= out_rows) return;
  const size_t plane = (size_t)blockIdx.z * h * w;
  const float d_in = band_min_at(din + plane + x, h, w, y + row_off, band);
  const float d_out = band_min_at(dout + plane + x, h, w, y + row_off, band);
  out[(size_t)blockIdx.z * out_rows * w + (size_t)y * w + x] =
      band_tail(d_in, d_out, apply_sqrt, s_min, s_max);
}

// ------------------------------------------------------ the staged kernels

constexpr int kLanes = 32;   // columns per block, one per lane
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * kLanes;
constexpr int kRows = 128;   // output rows per block
constexpr int kPerLane = kRows / kWarps;  // output rows per lane: y0 + warp + 16 i
constexpr int kSeg = 16;     // strip rows per segment minimum
constexpr int kCap = 8;      // rows each way of a dense block's capped walk
constexpr int kChunk = 4;    // rows of a segment taken together (independent taps)
constexpr int kDistHalo = 64;  // edt_dist_staged: window rows each side of its output rows
static_assert(2 * kPerLane <= 32, "both fields of a lane's pixels fit one word of bits");

// Start copies of `nrows` rows of the block's 32 columns: row r from src +
// r * src_stride to dst + r * dst_stride (elements); `cols` columns exist
// (W - x0). vec: 16-byte cp.async (rows of a multiple of 16 bytes, 16-byte
// aligned); else element by element. copies_done waits for them.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dst_stride, const T* __restrict__ src, int src_stride,
                                          int nrows, int cols, int vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T), kChunks = kLanes / kVec;
    for (int e = threadIdx.x; e < nrows * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * kVec;
      if (c < cols) cp_async16(dst + r * dst_stride + c, src + (size_t)r * src_stride + c);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * kLanes; e += kThreads) {
      const int r = e / kLanes, c = e % kLanes;
      if (c < cols) dst[r * dst_stride + c] = src[(size_t)r * src_stride + c];
    }
  }
}

__device__ __forceinline__ void copies_done(int vec) {
  if (vec) {
    cp_commit();
    cp_wait_all();
  }
  __syncthreads();
}

// The sum of `mine` over the block's threads; ends with __syncthreads.
__device__ __forceinline__ int block_count(int mine, int* warp_n) {
  const int n = __reduce_add_sync(kFull, mine);
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = n;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) total += warp_n[k];
  return total;
}

// v[i] for an i known only at run time, without moving v out of registers.
template <typename V, int N>
__device__ __forceinline__ V pick(const V (&v)[N], int i) {
  V r = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) r = i == k ? v[k] : r;
  return r;
}

// The running minimum of the keys of 32 bits of a field row: the values
// themselves for the unsigned strips (4 or 2 a word); |v| for int32, so
// that fl(min(key, clip)^2) bounds g(v) = fl(v^2) from below also for a
// negative v.
template <typename T>
__device__ __forceinline__ uint32_t key_min(uint32_t m, uint32_t word) {
  if constexpr (sizeof(T) == 1) {
    return __vminu4(m, word);
  } else if constexpr (sizeof(T) == 2) {
    return __vminu2(m, word);
  } else {
    const int v = (int)word;
    return min(m, v < 0 ? 0u - (uint32_t)v : (uint32_t)v);
  }
}

// A block's window of the strips: rows [wlo, wlo + nrows), its output rows
// [y0, y1) widened by the band within [0, h) and to whole 16-row segments
// of the strip.
struct Window {
  int wlo, nrows, nseg;
};

__device__ __forceinline__ Window band_window(int y0, int y1, int row_off, int band, int h) {
  const int reach = min(band, h);
  Window wd;
  wd.wlo = max(0, y0 + row_off - reach) / kSeg * kSeg;
  const int whi = min(h, (y1 + row_off + reach + kSeg - 1) / kSeg * kSeg);
  wd.nrows = whi - wd.wlo;
  wd.nseg = (wd.nrows + kSeg - 1) / kSeg;
  return wd;
}

// fl(min(m, clip)^2) of the least key m per segment of the staged window,
// column and field into segm (segment s, field f at segm + (s * 2 + f) *
// 32); ends with __syncthreads. A thread takes 32 bits of columns of one
// segment and field.
template <typename T>
__device__ __forceinline__ void band_minima(const T* win, float* segm, const Window& wd, int clip) {
  constexpr int kPer = 4 / sizeof(T), kWords = kLanes / kPer;  // columns per word, words per field row
  const uint32_t* win32 = (const uint32_t*)win;
  for (int e = threadIdx.x; e < wd.nseg * 2 * kWords; e += kThreads) {
    const int s = e / (2 * kWords), f = (e / kWords) % 2, q = e % kWords;
    const int r_end = min((s + 1) * kSeg, wd.nrows);
    uint32_t m = 0xffffffffu;
    for (int r = s * kSeg; r < r_end; ++r) m = key_min<T>(m, win32[(r * 2 + f) * kWords + q]);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      uint32_t v = m;
      if constexpr (sizeof(T) < 4) v = (m >> (8 * sizeof(T) * i)) & ((1u << (8 * sizeof(T))) - 1u);
      const float d = (float)(int)min(v, (uint32_t)clip);
      segm[(s * 2 + f) * kLanes + q * kPer + i] = __fmul_rn(d, d);
    }
  }
  __syncthreads();
}

// best lowered by the n rows of one segment at |dy| a0, a0 + 1, ... (row k
// at p[k * step]), nearest first, in chunks of kChunk independent taps;
// false once a chunk's first a^2 >= best (the side ends there). A tap past
// that point is at least a^2 >= best and cannot lower it.
template <typename T>
__device__ __forceinline__ bool band_rows(const T* p, int step, int n, int a0, int clip, float* best) {
  for (int k = 0; k < n; k += kChunk) {
    if (sq_dy(a0 + k) >= *best) return false;
    float m = *best;
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (k + j < n) m = fminf(m, __fadd_rn(sq_clip(p[(k + j) * step], clip), sq_dy(a0 + k + j)));
    *best = m;
  }
  return true;
}

// The segment walk of one field of the pixel at window row c, from its
// running minimum best: rows [lo, ub] above it and [db, hi] below, nearest
// first. col: the field's column in the window (row r at col[r * 64]); sm:
// its segment minima (segment s at sm[s * 64]). Segments go outward, one
// above and one below a step; one whose bound fl(gmin + fl(a^2)) cannot
// lower best is skipped, and a side ends where fl(a^2) alone cannot.
template <typename T>
__device__ __forceinline__ float band_walk(const T* col, const float* sm, int clip, int c, int lo, int ub,
                                           int db, int hi, float best) {
  int su = ub >= lo ? ub / kSeg : 0, sd = db / kSeg;
  bool up = ub >= lo, dn = db <= hi;
  while (up || dn) {
    if (up) {
      const int top = max(su * kSeg, lo), bot = min(su * kSeg + kSeg - 1, ub);
      const float a2 = sq_dy(c - bot);
      if (a2 >= best)
        up = false;
      else if (__fadd_rn(sm[su * 2 * kLanes], a2) < best)
        up = band_rows(col + bot * 2 * kLanes, -2 * kLanes, bot - top + 1, c - bot, clip, &best);
      up = up && su * kSeg > lo;
      --su;
    }
    if (dn) {
      const int top = max(sd * kSeg, db), bot = min(sd * kSeg + kSeg - 1, hi);
      const float a2 = sq_dy(top - c);
      if (a2 >= best)
        dn = false;
      else if (__fadd_rn(sm[sd * 2 * kLanes], a2) < best)
        dn = band_rows(col + top * 2 * kLanes, 2 * kLanes, bot - top + 1, top - c, clip, &best);
      dn = dn && sd * kSeg + kSeg - 1 < hi;
      ++sd;
    }
  }
  return best;
}

// grid (ceil(W/32), ceil(out_rows/128), N); block 512: 32 columns (one per
// lane) and 128 output rows (warp w takes rows w, w + 16, ...) of one image,
// output row y at strip row y + row_off. The window holds both strips,
// window row r, field f (0: din, 1: dout) at win + (r * 2 + f) * 32.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 1 ? 3 : 2)
edt_band_staged(const T* __restrict__ din, const T* __restrict__ dout, uint8_t* __restrict__ out, int h,
                int w, int row_off, int out_rows, int band, float s_min, float s_max, int apply_sqrt,
                int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_n[kWarps];
  const int tx = threadIdx.x % kLanes, wp = threadIdx.x / kLanes;
  const int x0 = blockIdx.x * kLanes, x = x0 + tx, cols = w - x0;
  const int y0 = blockIdx.y * kRows, y1 = min(y0 + kRows, out_rows);
  const size_t plane = (size_t)blockIdx.z * h * w;
  const Window wd = band_window(y0, y1, row_off, band, h);
  const int clip = band + 1;
  T* win = (T*)smem_raw;
  float* segm = (float*)(win + (size_t)wd.nrows * 2 * kLanes);
  const T* src_in = din + plane + (size_t)wd.wlo * w + x0;
  const T* src_out = dout + plane + (size_t)wd.wlo * w + x0;
  auto stage = [&](int r0, int r1) {
    if (r1 <= r0) return;
    copy_rows(win + r0 * 2 * kLanes, 2 * kLanes, src_in + (size_t)r0 * w, w, r1 - r0, cols, vec);
    copy_rows(win + r0 * 2 * kLanes + kLanes, 2 * kLanes, src_out + (size_t)r0 * w, w, r1 - r0, cols, vec);
  };
  auto pixel = [&](int i) { return ((size_t)blockIdx.z * out_rows + y0 + wp + kWarps * i) * w + x; };
  const T* col = win + tx;  // din's column; dout's at col + 32
  // g of window row r, field f
  auto g = [&](int r, int f) { return sq_clip(col[r * 2 * kLanes + f * kLanes], clip); };
  // the lane's rows: i < rows, window row cw0 + 16 i (strip row c0 + 16 i)
  const int rows = x < w ? (y1 - y0 - wp + kWarps - 1) / kWarps : 0;
  const int c0 = y0 + wp + row_off, cw0 = c0 - wd.wlo;

  // the core, window rows [k0, k1): the capped walk reads |dy| <= min(kCap, band)
  const int cap = min(kCap, band);
  const int k0 = max(y0 + row_off - cap, 0) - wd.wlo, k1 = min(y1 + row_off + cap, h) - wd.wlo;
  stage(k0, k1);
  copies_done(vec);
  // best[2 i + f]: row i's field f; its own row first
  float best[2 * kPerLane];
  int near = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    best[2 * i] = best[2 * i + 1] = 0.0f;
    if (i < rows) {
      best[2 * i] = g(cw0 + kWarps * i, 0);
      best[2 * i + 1] = g(cw0 + kWarps * i, 1);
      near += fmaxf(best[2 * i], best[2 * i + 1]) <= sq_dy(kCap);
    }
  }
  const int npix = (y1 - y0) * min(kLanes, cols);
  const bool dense = 8 * block_count(near, warp_n) >= 7 * npix;

  // bit 2 i + f: row i's field f goes on by segments
  uint32_t open = 0;
  for (int i = 0; i < rows; ++i) open |= 3u << (2 * i);
  if (dense) {
    // |dy| = 1 .. cap for all the lane's rows and fields at once (independent
    // chains); a field runs while a^2 < its minimum and a is within its reach
    uint32_t run = open;
    for (int a = 1; a <= cap && run != 0; ++a) {
      const float a2 = sq_dy(a);
#pragma unroll
      for (int j = 0; j < 2 * kPerLane; ++j) {
        const int i = j / 2, f = j % 2, c = c0 + kWarps * i, cw = cw0 + kWarps * i;
        if (!((run >> j) & 1u)) continue;
        if (a > min(band, max(c, h - 1 - c)) || a2 >= best[j]) {
          run &= ~(1u << j);
          continue;
        }
        if (c - a >= 0) best[j] = fminf(best[j], __fadd_rn(g(cw - a, f), a2));
        if (c + a < h) best[j] = fminf(best[j], __fadd_rn(g(cw + a, f), a2));
      }
    }
    // a field is done once no row past cap can lower it
    const float next = sq_dy(cap + 1);
#pragma unroll
    for (int j = 0; j < 2 * kPerLane; ++j) {
      const int c = c0 + kWarps * (j / 2);
      if (min(band, max(c, h - 1 - c)) <= cap || next >= best[j]) open &= ~(1u << j);
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      if (i < rows && !((open >> (2 * i)) & 3u))
        out[pixel(i)] = band_tail(best[2 * i], best[2 * i + 1], apply_sqrt, s_min, s_max);
  }
  if (!__syncthreads_or(open != 0)) return;

  const int start = dense ? cap + 1 : 1;  // the segment walk's first |dy|
  stage(0, k0);
  stage(k1, wd.nrows);
  copies_done(vec);
  band_minima(win, segm, wd, clip);
#pragma unroll 1
  for (int i = 0; i < rows; ++i) {
    const uint32_t fields = (open >> (2 * i)) & 3u;
    if (fields == 0) continue;
    const int cw = cw0 + kWarps * i;
    const int lo = max(cw - band, 0), hi = min(cw + band, wd.nrows - 1);
    float b_in = pick(best, 2 * i), b_out = pick(best, 2 * i + 1);
    // the field further from its seeds first (the other is mostly done)
    const int f0 = b_out > b_in;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int f = f0 ^ k;
      if ((fields >> f) & 1u) {
        const float b = band_walk(col + f * kLanes, segm + f * kLanes + tx, clip, cw, lo, cw - start, cw + start,
                                  hi, f ? b_out : b_in);
        b_in = f ? b_in : b;
        b_out = f ? b : b_out;
      }
    }
    out[pixel(i)] = band_tail(b_in, b_out, apply_sqrt, s_min, s_max);
  }
}

// The staged kernel's shared memory for windows of up to `rows` rows.
template <typename T>
size_t band_smem(long long rows) {
  return (size_t)(rows * sizeof(T) + (rows + kSeg - 1) / kSeg * sizeof(float)) * 2 * kLanes;
}

// Whether pass 2 on strips of h rows at this band takes edt_band_staged on
// the current device (its largest window, min(h, 128 + 2 band + 30) rows,
// fits a block's dynamic shared memory), with that window's bytes.
template <typename T>
int band_path(int h, int band, bool* staged, size_t* smem) {
  static size_t limit_cache[64] = {};
  size_t limit = 0;
  const int e = dyn_smem_limit(edt_band_staged<T>, limit_cache, &limit);
  if (e != 0) return e;
  *smem = band_smem<T>(min((long long)h, kRows + 2LL * min(band, h) + 2 * (kSeg - 1)));
  *staged = *smem <= limit;
  return 0;
}

// Pass 2 of strips (N, h, W) into (N, out_rows, W): edt_band_staged where
// band_path says so, else edt_band_pixel.
template <typename T>
int band_bytes(const T* din, const T* dout, uint8_t* out, int n, int h, int w, int row_off, int out_rows,
               int band, float s_min, float s_max, int apply_sqrt, cudaStream_t s) {
  bool staged = false;
  size_t smem = 0;
  int e = band_path<T>(h, band, &staged, &smem);
  if (e != 0) return e;
  if (staged) {
    static size_t allowed[64] = {};
    e = allow_smem(edt_band_staged<T>, smem, allowed);
    if (e != 0) return e;
    const int vec = (w * (int)sizeof(T)) % 16 == 0 && (size_t)din % 16 == 0 && (size_t)dout % 16 == 0;
    const dim3 grid((unsigned)((w + kLanes - 1) / kLanes), (unsigned)((out_rows + kRows - 1) / kRows),
                    (unsigned)n);
    edt_band_staged<T><<<grid, kThreads, smem, s>>>(din, dout, out, h, w, row_off, out_rows, band, s_min, s_max,
                                                    apply_sqrt, vec);
  } else {
    const dim3 block(kBandTx, kBandTy);
    const dim3 grid((unsigned)((w + kBandTx - 1) / kBandTx), (unsigned)((out_rows + kBandTy - 1) / kBandTy),
                    (unsigned)n);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    edt_band_pixel<T><<<grid, block, 0, s>>>(din, dout, out, h, w, row_off, out_rows, band, s_min, s_max,
                                            apply_sqrt);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- edt_dist

constexpr int kCoreRows = kRows + 2 * kCap;  // a tile's core: its rows and kCap each side

// The tile of edt_dist's two kernels that a block of their grid (ceil(W/32),
// ceil(h/128), N) takes: 32 columns (one per lane) x 128 rows of one image
// (warp w takes rows w, w + 16, ...).
struct DistTile {
  int x0, x, cols, y0, y1, rows, c0, k0, k1;
  size_t plane;
  unsigned index;  // the tile's flag
  __device__ DistTile(int h, int w) {
    const int tx = (int)threadIdx.x % kLanes, wp = (int)threadIdx.x / kLanes;
    x0 = blockIdx.x * kLanes;
    x = x0 + tx;
    cols = w - x0;
    y0 = blockIdx.y * kRows;
    y1 = min(y0 + kRows, h);
    rows = x < w ? (y1 - y0 - wp + kWarps - 1) / kWarps : 0;  // the lane's rows: image row c0 + 16 i
    c0 = y0 + wp;
    k0 = max(y0 - kCap, 0);  // the core: rows [k0, k1)
    k1 = min(y1 + kCap, h);
    plane = (size_t)blockIdx.z * h * w;
    index = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  }
};

// NO_SEED (32768) where best >= sat^2; else refined_sqrt_f32 of best as
// float32. Below 2^24 - 1 that is the IEEE sqrt of the exact integer (equal
// on every one: chip_smoke.py phase 4), taken without the refinement's
// division; at 2^24 - 1 the refined root rounds up, and from there on best
// rounds to float32 first: the refined sqrt takes those.
__device__ __forceinline__ float dist_tail(int best, int sat) {
  if (best >= sat * sat) return 32768.0f;
  const float n = __int2float_rn(best);
  return best < (1 << 24) - 1 ? __fsqrt_rn(n) : refined_sqrt_f32(n);
}

// Each of the lane's rows' own g (0 past its rows), from the staged rows
// (image row r at win + (r - lo) * 32); returns how many are at most kCap.
__device__ __forceinline__ int dist_own(const DistTile& t, const uint16_t* win, int lo, int sat,
                                        int (&best)[kPerLane]) {
  const uint16_t* wcol = win + threadIdx.x % kLanes;
  int near = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int v = i < t.rows ? min((int)wcol[(t.c0 + kWarps * i - lo) * kLanes], sat) : 0;
    best[i] = v * v;
    near += i < t.rows && best[i] <= kCap * kCap;
  }
  return near;
}

// A dense tile's walk, |dy| = 1 .. kCap per pixel from its staged core (the
// lane's rows as independent chains); writes the pixels that no row past
// kCap can lower and returns the lane's rows left (bit i: row i).
__device__ __forceinline__ uint32_t dist_capped(const DistTile& t, const uint16_t* win, int lo, int h, int w,
                                                int sat, float* __restrict__ out, int (&best)[kPerLane]) {
  const uint16_t* wcol = win + threadIdx.x % kLanes;
  auto g = [&](int r) {
    const int v = min((int)wcol[(r - lo) * kLanes], sat);
    return v * v;
  };
  uint32_t open = (1u << t.rows) - 1, run = open;
  for (int a = 1; a <= kCap && run != 0; ++a) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = t.c0 + kWarps * i;
      if (!((run >> i) & 1u)) continue;
      if (a > max(c, h - 1 - c) || a * a >= best[i]) {
        run &= ~(1u << i);
        continue;
      }
      if (c - a >= 0) best[i] = min(best[i], g(c - a) + a * a);
      if (c + a < h) best[i] = min(best[i], g(c + a) + a * a);
    }
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = t.c0 + kWarps * i;
    if (((open >> i) & 1u) && (max(c, h - 1 - c) <= kCap || (kCap + 1) * (kCap + 1) >= best[i])) {
      open &= ~(1u << i);
      out[t.plane + (size_t)c * w + t.x] = dist_tail(best[i], sat);
    }
  }
  return open;
}

// The core of a tile: rows [k0, k1) of its columns into win (image row r at
// win + (r - lo) * 32), copies started.
__device__ __forceinline__ void stage_core(const DistTile& t, const uint16_t* __restrict__ d, uint16_t* win, int lo,
                                           int w, int vec) {
  copy_rows(win + (t.k0 - lo) * kLanes, kLanes, d + t.plane + (size_t)t.k0 * w + t.x0, w, t.k1 - t.k0, t.cols,
            vec);
}

// What edt_dist_core leaves a tile (left[tile]): done, or for edt_dist_staged
// a tile that is not dense (its walk starts at |dy| 1) or a dense one with
// pixels left (it walks |dy| <= kCap again, then on from kCap + 1).
enum : uint8_t { kTileDone = 0, kTileSparse = 1, kTileDenseLeft = 2 };

// grid (ceil(W/32), ceil(h/128), N); block 512, a tile each: the first of
// exact_dist's launches. Each tile stages its core, is dense where 7/8 of
// its pixels' own values are at most kCap (then it walks |dy| <= kCap and
// writes the pixels that are done), writes the least min(d, sat) of each
// of its 16-row segments (its own rows, all in the core) into tab (N,
// ceil(h/16), W), and sets left[tile].
__global__ void __launch_bounds__(kThreads, 4)
edt_dist_core(const uint16_t* __restrict__ d, uint16_t* __restrict__ tab, uint8_t* __restrict__ left,
              float* __restrict__ out, int h, int w, int nseg, int sat, int vec) {
  __shared__ __align__(16) uint16_t core[kCoreRows * kLanes];
  __shared__ int warp_n[kWarps];
  const DistTile t(h, w);
  stage_core(t, d, core, t.k0, w, vec);
  copies_done(vec);
  int best[kPerLane];
  const int near = dist_own(t, core, t.k0, sat, best);
  const bool dense = 8 * block_count(near, warp_n) >= 7 * (t.y1 - t.y0) * min(kLanes, t.cols);
  const uint32_t open = dense ? dist_capped(t, core, t.k0, h, w, sat, out, best) : 1u;
  for (int e = threadIdx.x; e < (t.y1 - t.y0 + kSeg - 1) / kSeg * kLanes; e += kThreads) {
    const int s = e / kLanes, c = e % kLanes;
    if (c >= t.cols) continue;
    const int r0 = t.y0 + s * kSeg, r1 = min(r0 + kSeg, h);
    int m = sat;
    for (int r = r0; r < r1; ++r) m = min(m, (int)core[(r - t.k0) * kLanes + c]);
    tab[((size_t)blockIdx.z * nseg + t.y0 / kSeg + s) * w + t.x0 + c] = (uint16_t)m;
  }
  const int any = __syncthreads_or(open != 0);
  if (threadIdx.x == 0) left[t.index] = !dense ? kTileSparse : any ? kTileDenseLeft : kTileDone;
}

// best lowered by the count rows of one segment at |dy| a0, a0 + 1, ...
// (row k at p[k * stride]), nearest first, in chunks of kChunk independent
// taps; false once a chunk's first a^2 >= best (the side ends there).
template <typename P>
__device__ __forceinline__ bool dist_rows(P p, int stride, int count, int a0, int sat, int* best) {
  for (int k = 0; k < count; k += kChunk) {
    if ((a0 + k) * (a0 + k) >= *best) return false;
    int m = *best;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (k + j < count) {
        const int a = a0 + k + j, v = min((int)p[(k + j) * stride], sat);
        m = min(m, v * v + a * a);
      }
    }
    *best = m;
  }
  return true;
}

// The segment walk of the pixel at row c of a column of the image, from
// its running minimum best: rows [0, ub] above it and [db, h) below,
// nearest first, by 16-row segments of the image (segment s's least value
// at tcol[s * 32]); a segment whose bound a^2 + m^2 cannot lower best is
// skipped, a side ends where a^2 alone cannot. A segment's rows come from
// the window (wcol, row r at wcol[(r - wlo) * 32]) where it lies in [wlo,
// whi), else from device memory (gcol, row r at gcol[r * w]).
__device__ __forceinline__ int dist_walk(const uint16_t* wcol, const uint16_t* __restrict__ gcol, int w, int wlo,
                                         int whi, const uint16_t* tcol, int sat, int h, int c, int ub, int db,
                                         int best) {
  // rows [top, bot] of segment s, nearest first (up: from bot, step -1)
  auto rows = [&](int s, int top, int bot, bool up, int a0) {
    const int n = bot - top + 1, from = up ? bot : top;
    if (s * kSeg >= wlo && s * kSeg < whi)
      return dist_rows(wcol + (from - wlo) * kLanes, up ? -kLanes : kLanes, n, a0, sat, &best);
    return dist_rows(gcol + (ptrdiff_t)from * w, up ? -w : w, n, a0, sat, &best);
  };
  int su = ub >= 0 ? ub / kSeg : 0, sd = db / kSeg;
  bool up = ub >= 0, dn = db < h;
  while (up || dn) {
    if (up) {
      const int top = su * kSeg, bot = min(top + kSeg - 1, ub), a0 = c - bot;
      const int m = tcol[su * kLanes];
      if (a0 * a0 >= best)
        up = false;
      else if (a0 * a0 + m * m < best)
        up = rows(su, top, bot, true, a0);
      up = up && su > 0;
      --su;
    }
    if (dn) {
      const int top = max(sd * kSeg, db), bot = min(sd * kSeg + kSeg - 1, h - 1), a0 = top - c;
      const int m = tcol[sd * kLanes];
      if (a0 * a0 >= best)
        dn = false;
      else if (a0 * a0 + m * m < best)
        dn = rows(sd, top, bot, false, a0);
      dn = dn && bot < h - 1;
      ++sd;
    }
  }
  return best;
}

// grid (ceil(W/32), ceil(h/128), N); block 512: the second launch. A tile
// edt_dist_core finished returns at once. Shared memory: the window, rows
// [wlo, whi) of the tile's columns (row r at win + (r - wlo) * 32), then its
// columns' table (segment s at tsm + s * 32). A sparse tile stages both at
// once and walks every pixel by segments from |dy| 1; a dense tile with
// pixels left stages its core, walks |dy| <= kCap again (rewriting its done
// pixels with the same values), then stages the rest and walks the pixels
// left from kCap + 1.
__global__ void __launch_bounds__(kThreads, 4)
edt_dist_staged(const uint16_t* __restrict__ d, const uint16_t* __restrict__ tab, const uint8_t* __restrict__ left,
                float* __restrict__ out, int h, int w, int nseg, int sat, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DistTile t(h, w);
  const uint8_t path = left[t.index];
  if (path == kTileDone) return;
  const int wlo = max(0, t.y0 - kDistHalo), whi = min(h, t.y1 + kDistHalo);
  uint16_t* win = (uint16_t*)smem_raw;
  uint16_t* tsm = win + (size_t)(whi - wlo) * kLanes;
  int best[kPerLane];
  stage_core(t, d, win, wlo, w, vec);
  uint32_t open = (1u << t.rows) - 1;
  if (path == kTileDenseLeft) {
    copies_done(vec);
    dist_own(t, win, wlo, sat, best);
    open = dist_capped(t, win, wlo, h, w, sat, out, best);
    if (!__syncthreads_or(open != 0)) return;
  }
  const uint16_t* src = d + t.plane + t.x0;
  copy_rows(win, kLanes, src + (size_t)wlo * w, w, t.k0 - wlo, t.cols, vec);
  copy_rows(win + (t.k1 - wlo) * kLanes, kLanes, src + (size_t)t.k1 * w, w, whi - t.k1, t.cols, vec);
  copy_rows(tsm, kLanes, tab + (size_t)blockIdx.z * nseg * w + t.x0, w, nseg, t.cols, vec);
  copies_done(vec);
  if (path == kTileSparse) dist_own(t, win, wlo, sat, best);
  const int start = path == kTileDenseLeft ? kCap + 1 : 1;  // the segment walk's first |dy|
  const int tx = threadIdx.x % kLanes;
  const uint16_t* gcol = d + t.plane + t.x;
#pragma unroll 1
  for (int i = 0; i < t.rows; ++i) {
    if (!((open >> i) & 1u)) continue;
    const int c = t.c0 + kWarps * i;
    out[t.plane + (size_t)c * w + t.x] = dist_tail(
        dist_walk(win + tx, gcol, w, wlo, whi, tsm + tx, sat, h, c, c - start, c + start, pick(best, i)), sat);
  }
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
  const long long nrows = (long long)n * h;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1) return rows_launch<uint8_t>(codes, din, dout, nrows, w, clip, s);
  if (elem_bytes == 2) return rows_launch<uint16_t>(codes, din, dout, nrows, w, clip, s);
  if (elem_bytes == 4) return rows_launch<int32_t>(codes, din, dout, nrows, w, clip, s);
  return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1) {
    return band_bytes((const uint8_t*)din, (const uint8_t*)dout, (uint8_t*)out, n, h, w, row_off, out_rows,
                      band, s_min, s_max, apply_sqrt, s);
  }
  if (elem_bytes == 2) {
    return band_bytes((const uint16_t*)din, (const uint16_t*)dout, (uint8_t*)out, n, h, w, row_off, out_rows,
                      band, s_min, s_max, apply_sqrt, s);
  }
  if (elem_bytes == 4) {
    return band_bytes((const int32_t*)din, (const int32_t*)dout, (uint8_t*)out, n, h, w, row_off, out_rows,
                      band, s_min, s_max, apply_sqrt, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Whether pass 2 (chaq_edt_band_bytes) on strips of h rows at this band and
// element size takes edt_band_staged on the current device: *staged 1, or
// 0 for edt_band_pixel.
extern "C" int chaq_edt_band_staged(int h, int band, int elem_bytes, int* staged) {
  if (h < 1 || band < 0 || band > (1 << 30) - 1) return (int)cudaErrorInvalidValue;
  bool fits = false;
  size_t smem = 0;
  int e = (int)cudaErrorInvalidValue;
  if (elem_bytes == 1) e = band_path<uint8_t>(h, band, &fits, &smem);
  if (elem_bytes == 2) e = band_path<uint16_t>(h, band, &fits, &smem);
  if (elem_bytes == 4) e = band_path<int32_t>(h, band, &fits, &smem);
  *staged = fits;
  return e;
}

// sat^2 + (h-1)^2 must fit int32 (the tiers of cuda_edt.dist_sat)
static bool dist_args_ok(int n, int h, int w, int sat) {
  const long long reach = h - 1;
  return n >= 1 && h >= 1 && w >= 1 && n <= 65535 && sat >= 1 && sat <= 65535 &&
         (long long)sat * sat + reach * reach < (1LL << 31);
}

static dim3 dist_grid(int n, int h, int w) {
  return dim3((unsigned)((w + kLanes - 1) / kLanes), (unsigned)((h + kRows - 1) / kRows), (unsigned)n);
}

// The first of exact_dist's launches: tab (n, ceil(h/16), w) uint16, the
// least min(d, sat) of each 16-row segment; left (n, ceil(h/128),
// ceil(w/32)) uint8, what each tile left (0 done, 1 sparse, 2 dense with
// pixels left); out (n, h, w) float32, written on the tiles done.
extern "C" int chaq_edt_dist_core(const void* d, void* tab, void* left, void* out, int n, int h, int w, int sat,
                                  void* stream) {
  if (!dist_args_ok(n, h, w, sat)) return (int)cudaErrorInvalidValue;
  const int vec = (w * 2) % 16 == 0 && (size_t)d % 16 == 0;
  edt_dist_core<<<dist_grid(n, h, w), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)d, (uint16_t*)tab, (uint8_t*)left, (float*)out, h, w, (h + kSeg - 1) / kSeg, sat, vec);
  return (int)cudaGetLastError();
}

// The second: the tiles chaq_edt_dist_core left, from its tab and left. The
// window and the table always fit: dist_args_ok keeps h <= 46341, 201 KB.
extern "C" int chaq_edt_dist(const void* d, const void* tab, const void* left, void* out, int n, int h, int w,
                             int sat, void* stream) {
  if (!dist_args_ok(n, h, w, sat)) return (int)cudaErrorInvalidValue;
  const int nseg = (h + kSeg - 1) / kSeg;
  const size_t smem = ((size_t)min(h, kRows + 2 * kDistHalo) + nseg) * kLanes * sizeof(uint16_t);
  static size_t limit_cache[64] = {}, allowed[64] = {};
  size_t limit = 0;
  int e = dyn_smem_limit(edt_dist_staged, limit_cache, &limit);
  if (e == 0 && smem > limit) e = (int)cudaErrorInvalidValue;
  if (e == 0) e = allow_smem(edt_dist_staged, smem, allowed);
  if (e != 0) return e;
  const int vec = (w * 2) % 16 == 0 && (size_t)d % 16 == 0 && (size_t)tab % 16 == 0;
  edt_dist_staged<<<dist_grid(n, h, w), kThreads, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)d, (const uint16_t*)tab, (const uint8_t*)left, (float*)out, h, w, nseg, sat, vec);
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
