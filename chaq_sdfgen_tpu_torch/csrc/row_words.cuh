// The row passes' walk (edt.cu's edt_rows, brute.cu's brute_rows): per image row,
// the K nearest seeds of each polarity on each side of every pixel, the seeds being
// the TRUE pixels (code 1) and the FALSE ones (code 0); code 2 seeds neither.
//
// A warp takes a segment of a row: up to kSteps steps of 32 chunks, a chunk the 16
// pixels of one 16-byte word of the codes (chunks sit on the flat (rows, w) array's
// 16-element grid, so a row whose offset is not 16-aligned starts and ends with a
// partial chunk, read and written a pixel at a time; the rest move as 16-byte words).
// A step gives lane l its step's l-th chunk, so each load and store of the warp is
// 512 contiguous bytes of codes. The warp
//   1. has its segment's chunks staged in shared memory by 16-byte cp.async copies
//      (issued during the walk of its previous segment: the grid holds as many
//      blocks as the card keeps resident, and a warp takes every (blocks x
//      kWarps)-th segment), keeps each chunk as a 32-bit mask, TRUE seeds in bits
//      0-15 and FALSE in 16-31 (shared memory, a word a lane and step), and keeps
//      the K last seeds of each polarity before each step: a step's K last seeds
//      come from a ballot of the lanes that hold one and the masks of the (at most
//      K) highest such lanes, by shuffles and clz;
//   2. walks the steps right to left with the K first seeds after the step in
//      registers; each lane takes its chunk's nearest seeds outside it, before (the
//      highest lanes below it with one, then the step's carry) and after (the
//      lowest above, then the carry), the same ballot-and-shuffle way, and hands
//      its chunk, its mask and both sides to the pass's epilogue, which walks the
//      16 pixels in registers, two a step (pairs, below), and writes every output
//      once, 16 bytes a store.
// A segment that does not start (end) its row first takes the K nearest seeds
// before (after) it from the codes around it, 32 chunks at a time, until it holds
// K of each polarity or the rest lie at least clip away (a distance clips there
// anyway) or the row ends. Rows are cut into segments only where whole rows would
// give a launch fewer than kTargetWarps warps (a (4,) shard of a 4096² image, 1024
// rows, takes two segments a row); a 4096-wide row is one segment of 8 steps.
//
// Bound: bytes. The codes are read once from device memory (a segment's look
// around its ends reads its neighbours' codes again, from L2); the epilogue's
// outputs are written once, in 16-byte stores.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "staged.cuh"

namespace row_words {

constexpr int kChunk = 16;          // pixels a chunk: one 16-byte word of codes
constexpr int kLanes = 32;
constexpr int kSteps = 8;           // steps a segment at most: 8 x 32 chunks, 4096 pixels
constexpr int kWarps = 8;           // a block's warps, each on a segment of its own
constexpr int kThreads = kWarps * kLanes;
constexpr long long kTargetWarps = 2048;  // rows are cut into segments below this many warps
constexpr int kNone = -(1 << 30);   // "no seed before"
constexpr int kFar = 1 << 30;       // "no seed after"
constexpr unsigned kAll = 0xffffffffu;

// The K nearest seeds on one side, per polarity: t (TRUE) and f (FALSE), [0] the
// nearer; kNone before or kFar after where there are fewer.
struct Near {
  int t[2], f[2];
};

__device__ __forceinline__ Near no_seeds(bool before) {
  const int v = before ? kNone : kFar;
  return Near{{v, v}, {v, v}};
}

// Bits 0-3: which of a word's 4 codes are 1; bits 4-7: which are 0. The zero
// tests are exact per byte (no carry crosses a byte), and no two terms of the
// multiply land on one bit, so it gathers the 8 flags without carries.
__device__ __forceinline__ uint32_t code_flags(uint32_t v) {
  const uint32_t u = v ^ 0x01010101u;
  const uint32_t one = ~(((u & 0x7f7f7f7fu) + 0x7f7f7f7fu) | u) & 0x80808080u;
  const uint32_t zero = ~(((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) & 0x80808080u;
  return (((one >> 7) | (zero >> 3)) * 0x00204081u) >> 21 & 0xffu;
}

// The mask of a chunk of 16 codes held as a word. Where every code is 0 or 1
// (a bool mask's bytes) the FALSE seeds are the TRUE ones' complement.
__device__ __forceinline__ uint32_t word_mask(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t m = 0;
  if (((v.x | v.y | v.z | v.w) & 0xfefefefeu) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) m |= (w[k] * 0x00204081u >> 21 & 0xfu) << (4 * k);
    return m | (~m & 0xffffu) << 16;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t f = code_flags(w[k]);
    m |= (f & 0xfu) << (4 * k) | (f >> 4) << (16 + 4 * k);
  }
  return m;
}

// Where a row [e0, e0 + w) of the flat array holds all 16 pixels of chunk j.
__device__ __forceinline__ bool full_chunk(long long j, long long e0, int w) {
  return j * kChunk >= e0 && j * kChunk + kChunk <= e0 + w;
}

// The mask of chunk j, a code at a time; pixels outside the row seed neither.
__device__ __forceinline__ uint32_t scalar_mask(const uint8_t* __restrict__ codes, long long j, long long e0,
                                                int w) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const long long e = j * kChunk + i;
    if (e >= e0 && e < e0 + w) {
      const uint8_t c = codes[e];
      m |= (uint32_t)(c == 1) << i | (uint32_t)(c == 0) << (16 + i);
    }
  }
  return m;
}

__device__ __forceinline__ uint32_t chunk_mask(const uint8_t* __restrict__ codes, long long j, long long e0, int w,
                                               bool vec) {
  if (vec && full_chunk(j, e0, w)) return word_mask(__ldg(reinterpret_cast<const uint4*>(codes) + j));
  return scalar_mask(codes, j, e0, w);
}

// The K nearest seeds of polarity pol (0 TRUE, 1 FALSE) in the chunks of the lanes
// in `lanes`, lane l's chunk starting at pixel x0 + 16 l, its mask m; bal: the lanes
// whose chunk holds a seed of that polarity. kBefore: the last ones (the highest
// lanes), else the first. Every lane of the warp takes part.
template <bool kBefore, int K>
__device__ __forceinline__ void nearest(uint32_t m, uint32_t bal, uint32_t lanes, int pol, int x0, int* p) {
  const uint32_t c = bal & lanes;
  const int none = kBefore ? kNone : kFar;
  const int h1 = kBefore ? 31 - __clz(c) : __ffs(c) - 1;
  const uint32_t m1 = __shfl_sync(kAll, m, h1 & 31) >> (16 * pol) & 0xffffu;
  const int b1 = kBefore ? 31 - __clz(m1) : __ffs(m1) - 1;
  p[0] = c ? x0 + kChunk * h1 + b1 : none;
  if (K == 2) {
    const uint32_t c2 = kBefore ? c & ~(1u << (h1 & 31)) : c & (c - 1);
    const int h2 = kBefore ? 31 - __clz(c2) : __ffs(c2) - 1;
    const uint32_t m2 = __shfl_sync(kAll, m, h2 & 31) >> (16 * pol) & 0xffffu;
    const uint32_t r1 = kBefore ? m1 & ~(1u << (b1 & 31)) : m1 & (m1 - 1);  // the chunk's other seeds
    const int b2 = kBefore ? 31 - __clz(r1) : __ffs(r1) - 1;
    const int b3 = kBefore ? 31 - __clz(m2) : __ffs(m2) - 1;
    p[1] = c && r1 ? x0 + kChunk * h1 + b2 : c2 ? x0 + kChunk * h2 + b3 : none;
  }
}

// a = the K nearest of a and b (for K = 2: the nearest of both firsts, then the
// nearer of the other first and both seconds).
template <bool kBefore, int K>
__device__ __forceinline__ void merge(int* a, const int* b) {
  if (K == 1) {
    a[0] = kBefore ? max(a[0], b[0]) : min(a[0], b[0]);
  } else {
    const int n1 = kBefore ? max(a[0], b[0]) : min(a[0], b[0]);
    const int w1 = kBefore ? min(a[0], b[0]) : max(a[0], b[0]);
    const int n2 = kBefore ? max(a[1], b[1]) : min(a[1], b[1]);
    a[0] = n1;
    a[1] = kBefore ? max(w1, n2) : min(w1, n2);
  }
}

// Both polarities of a step (lane l's chunk at x0 + 16 l, mask m) into c.
template <bool kBefore, int K>
__device__ __forceinline__ void take(Near& c, uint32_t m, uint32_t bt, uint32_t bf, uint32_t lanes, int x0) {
  int t[2], f[2];
  nearest<kBefore, K>(m, bt, lanes, 0, x0, t);
  nearest<kBefore, K>(m, bf, lanes, 1, x0, f);
  merge<kBefore, K>(c.t, t);
  merge<kBefore, K>(c.f, f);
}

template <int K>
__device__ __forceinline__ bool holds_all(const Near& c, bool before) {
  const int none = before ? kNone : kFar;
  return c.t[K - 1] != none && c.f[K - 1] != none;
}

// The K nearest seeds before chunk js (kBefore) or after chunk je of a row whose
// chunks are [jr0, jr1], 32 chunks a round, until c holds K of each polarity, the
// rest lie at least clip from the segment's end pixel xb (they would clip there),
// or the row ends. Chunks wholly clip or more away are not read.
template <bool kBefore, int K>
__device__ __forceinline__ void look_around(Near& c, const uint8_t* __restrict__ codes, long long e0, int w,
                                            long long jr0, long long jr1, long long jedge, int xb, int clip,
                                            bool vec) {
  const int lane = threadIdx.x & 31;
  for (long long base = kBefore ? jedge - kLanes : jedge + 1;; base += kBefore ? -kLanes : kLanes) {
    const long long j = base + lane;
    const int x = (int)(j * kChunk - e0);  // the chunk's first pixel
    const bool reach = kBefore ? x + kChunk > xb - clip : x < xb + clip;
    const uint32_t m = j >= jr0 && j <= jr1 && reach ? chunk_mask(codes, j, e0, w, vec) : 0u;
    const uint32_t bt = __ballot_sync(kAll, m & 0xffffu), bf = __ballot_sync(kAll, m >> 16);
    const int x0 = (int)(base * kChunk - e0);
    take<kBefore, K>(c, m, bt, bf, kAll, x0);
    const bool ends = kBefore ? base <= jr0 || x0 <= xb - clip : base + kLanes > jr1 || x0 + kLanes * kChunk >= xb + clip;
    if (ends || holds_all<K>(c, kBefore)) return;
  }
}

// Steps a segment and segments a row for a launch of `nrows` rows of w pixels.
inline void segments(long long nrows, int w, int* steps, int* segs) {
  // the most chunks a row spans: w / 16 where every row is 16-aligned
  const long long chunks = w % kChunk == 0 ? w / kChunk : (w + kChunk - 2) / kChunk + 1;
  const long long per_step = kLanes;
  int s = (int)((chunks + per_step - 1) / per_step);
  if (s > kSteps) s = kSteps;
  auto count = [&](int st) { return (chunks + per_step * st - 1) / (per_step * st); };
  while (s > 1 && nrows * count(s) < kTargetWarps) s = (s + 1) / 2;
  *steps = s;
  *segs = (int)count(s);
}

// The grid of a row pass: a warp a segment, or as many blocks as the card
// holds at once (the warps then take every (blocks x kWarps)-th segment).
template <class Kernel>
int grid_of(Kernel kernel, long long nrows, int segs, unsigned* grid, int* cache) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev < 64 && cache[dev] != 0) {
    per_sm = cache[dev];
  } else {
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    per_sm *= sms;
    if (dev < 64) cache[dev] = per_sm;
  }
  const long long need = (nrows * segs + kWarps - 1) / kWarps;
  *grid = (unsigned)(need < per_sm ? need : per_sm);
  return 0;
}

// One warp's segment g of a launch: its row's first element e0, the row's
// chunks [jr0, jr1] and the segment's own [js, je], nsteps steps; false where
// the row ends before the segment starts.
struct Seg {
  long long e0, jr0, jr1, js, je;
  int nsteps;
};

__device__ __forceinline__ bool segment_of(long long g, int w, int steps, int segs, Seg& s) {
  const long long row = g / segs;
  s.e0 = row * w;
  s.jr0 = s.e0 / kChunk;
  s.jr1 = (s.e0 + w - 1) / kChunk;
  s.js = s.jr0 + (g - row * segs) * steps * kLanes;
  s.je = min(s.js + (long long)steps * kLanes - 1, s.jr1);
  s.nsteps = (int)((s.je - s.js) / kLanes) + 1;
  return s.js <= s.jr1;
}

// The segment's full chunks into the warp's stage, one 16-byte cp.async each.
__device__ __forceinline__ void stage_codes(uint4 (*stage)[kLanes], const uint8_t* __restrict__ codes, const Seg& s,
                                            int w) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < s.nsteps; ++k) {
    const long long j = s.js + k * kLanes + lane;
    if (j <= s.je && full_chunk(j, s.e0, w)) cp_async16(&stage[k][lane], codes + j * kChunk);
  }
  cp_commit();
}

// The walk of the warps' segments of a row pass over the (nrows, w) codes:
// for each chunk j of a segment, emit(j, e0, m, before, after) with e0 its
// row's first element (chunk j's first pixel sits at column 16 j - e0,
// negative for a row's partial first chunk), m its mask and the K nearest
// seeds before and after it (outside it); clip bounds the look around the
// segment's ends. vec: the codes start 16-byte aligned (the full chunks are
// then staged by cp.async, the next segment's during this one's walk).
template <int K, class Emit>
__device__ __forceinline__ void walk(const uint8_t* __restrict__ codes, long long nrows, int w, int clip, int steps,
                                     int segs, int vec, Emit& emit) {
  __shared__ uint4 stage[kWarps][kSteps][kLanes];
  __shared__ uint32_t masks[kWarps][kSteps][kLanes];
  __shared__ Near carry[kWarps][kSteps];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long total = nrows * segs, stride = (long long)gridDim.x * kWarps;
  long long g = (long long)blockIdx.x * kWarps + wid;
  if (g >= total) return;
  Seg cur, nxt;
  bool live = segment_of(g, w, steps, segs, cur);
  if (live && vec) stage_codes(stage[wid], codes, cur, w);
  for (; g < total; g += stride, cur = nxt) {
    const bool next = g + stride < total && segment_of(g + stride, w, steps, segs, nxt);
    const long long e0 = cur.e0, js = cur.js, je = cur.je;
    const int nsteps = cur.nsteps;
    if (live) {
      // 1. every chunk's mask, the full ones from the stage, and the K last
      // seeds before each step
      const int xs = (int)max(js * kChunk - e0, 0LL);
      Near c = no_seeds(true);
      if (js > cur.jr0) look_around<true, K>(c, codes, e0, w, cur.jr0, cur.jr1, js, xs, clip, vec);
      if (vec) cp_wait_all();
#pragma unroll 4
      for (int s = 0; s < nsteps; ++s) {
        const long long j = js + s * kLanes + lane;
        uint32_t m = 0;
        if (j <= je) m = vec && full_chunk(j, e0, w) ? word_mask(stage[wid][s][lane]) : scalar_mask(codes, j, e0, w);
        masks[wid][s][lane] = m;
        if (lane == 0) carry[wid][s] = c;
        const uint32_t bt = __ballot_sync(kAll, m & 0xffffu), bf = __ballot_sync(kAll, m >> 16);
        take<true, K>(c, m, bt, bf, kAll, (int)((js + s * kLanes) * kChunk - e0));
      }
      __syncwarp();
    }
    if (next && vec) stage_codes(stage[wid], codes, nxt, w);  // in flight during this segment's walk
    if (live) {
      // 2. right to left, each chunk with both sides
      const int xe = (int)min(je * kChunk + kChunk - 1 - e0, (long long)w - 1);
      Near after = no_seeds(false);
      if (je < cur.jr1) look_around<false, K>(after, codes, e0, w, cur.jr0, cur.jr1, je, xe, clip, vec);
      const uint32_t below = (1u << lane) - 1u, above = ~((2u << lane) - 1u);
#pragma unroll 2
      for (int s = nsteps - 1; s >= 0; --s) {
        const uint32_t m = masks[wid][s][lane];
        const uint32_t bt = __ballot_sync(kAll, m & 0xffffu), bf = __ballot_sync(kAll, m >> 16);
        const int x0 = (int)((js + s * kLanes) * kChunk - e0);
        Near lo = carry[wid][s], hi = after;
        take<true, K>(lo, m, bt, bf, below, x0);
        take<false, K>(hi, m, bt, bf, above, x0);
        take<false, K>(after, m, bt, bf, kAll, x0);
        const long long j = js + s * kLanes + lane;
        if (j <= je) emit(j, e0, m, lo, hi);
      }
      __syncwarp();  // carry and masks are rewritten for the next segment
    }
    live = next;
  }
}

// Pairs: the epilogues' walks take a chunk's 16 pixels two at a time, a
// 32-bit word a step holding pixel i (low half) and pixel i + 8 (high half),
// i = 0..7, where a clip up to kPairMax leaves a walk's growth (at most 16
// past a clipped start) inside the halves.
constexpr int kPairMax = 65535 - kChunk;

__device__ __forceinline__ uint32_t pair(int lo, int hi) { return (uint32_t)lo | (uint32_t)hi << 16; }

// The 8 steps' seed masks of a 16-pixel mask mp: sel[i] all ones in the low
// half where pixel i is a seed, in the high half where pixel i + 8 is.
__device__ __forceinline__ void step_masks(uint32_t mp, uint32_t* sel) {
  const uint32_t s = (mp & 0xffu) | (mp & 0xff00u) << 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) sel[i] = (s >> i & 0x00010001u) * 0xffffu;
}

// Chunk j's 16 values as pairs f into dst (8- or 16-bit elements), as
// put_chunk stores them.
template <typename T>
__device__ __forceinline__ void put_pairs(T* __restrict__ dst, long long j, const uint32_t* f, long long e0, int w,
                                          bool vec) {
  static_assert(sizeof(T) <= 2, "pairs hold 16-bit values");
  if (vec && full_chunk(j, e0, w)) {
    uint4* out = reinterpret_cast<uint4*>(dst + j * kChunk);
    if constexpr (sizeof(T) == 1) {
      // bytes (i, i + 1, i + 8, i + 9), then pixels 0-3, 4-7, 8-11, 12-15
      const uint32_t a = __byte_perm(f[0], f[1], 0x6240), b = __byte_perm(f[2], f[3], 0x6240);
      const uint32_t c = __byte_perm(f[4], f[5], 0x6240), d = __byte_perm(f[6], f[7], 0x6240);
      out[0] = make_uint4(__byte_perm(a, b, 0x5410), __byte_perm(c, d, 0x5410), __byte_perm(a, b, 0x7632),
                          __byte_perm(c, d, 0x7632));
    } else {
      out[0] = make_uint4(__byte_perm(f[0], f[1], 0x5410), __byte_perm(f[2], f[3], 0x5410),
                          __byte_perm(f[4], f[5], 0x5410), __byte_perm(f[6], f[7], 0x5410));
      out[1] = make_uint4(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632),
                          __byte_perm(f[4], f[5], 0x7632), __byte_perm(f[6], f[7], 0x7632));
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const long long e = j * kChunk + i;
    if (e >= e0 && e < e0 + w) dst[e] = (T)(i < 8 ? f[i] & 0xffffu : f[i - 8] >> 16);
  }
}

// Chunk j's 16 values v into dst (a plane of the flat (rows, w) array): as
// 16-byte words where the row holds the whole chunk, else the row's pixels one
// by one.
template <typename T>
__device__ __forceinline__ void put_chunk(T* __restrict__ dst, long long j, const int* v, long long e0, int w,
                                          bool vec) {
  if (vec && full_chunk(j, e0, w)) {
    uint4* out = reinterpret_cast<uint4*>(dst + j * kChunk);
    if constexpr (sizeof(T) == 1) {
      uint32_t q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        q[k] = __byte_perm(__byte_perm(v[4 * k], v[4 * k + 1], 0x0040), __byte_perm(v[4 * k + 2], v[4 * k + 3], 0x0040),
                           0x5410);
      out[0] = make_uint4(q[0], q[1], q[2], q[3]);
    } else if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int* u = v + 8 * k;
        out[k] = make_uint4(__byte_perm(u[0], u[1], 0x5410), __byte_perm(u[2], u[3], 0x5410),
                            __byte_perm(u[4], u[5], 0x5410), __byte_perm(u[6], u[7], 0x5410));
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k] = make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const long long e = j * kChunk + i;
    if (e >= e0 && e < e0 + w) dst[e] = (T)v[i];
  }
}

}  // namespace row_words
