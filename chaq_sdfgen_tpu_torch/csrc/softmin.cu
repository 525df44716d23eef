// The composed soft path's banded soft-min for Hopper (sm_90a), forward and
// backward, along either axis of a height field: pass 1 of ops/softsdf.py runs
// it along x on both fields' heights at once and writes each field into its half
// of S1 (..., H, 2W); pass 2 runs it along y on S1.
//
// softmin_col_fwd replaces chaq_sdfgen_tpu/ops/pallas_soft.py:_softmin_fwd_kernel
//   (softmin_col_fwd). For output position q and tap d = -band .. band, v_d =
//   g'[q + band + d] along the soft-min axis, g' the field extended by band
//   positions on each side; m = min_d (v_d + d^2), then
//   S[q] = m - T log sum_d exp(((m - v_d) - d^2) / T).
// softmin_col_bwd replaces _softmin_bwd_kernel (softmin_col_bwd): for each
//   extended position p, dg[p] = sum_d exp(((S[q] - d^2) - g'[p]) / T) ct[q],
//   q = p - band - d over the q in [0, h): the VJP with the softmax weights
//   recomputed from S.
//
// Forms. axis 0 slides the taps along y (rows), axis 1 along x (columns). The
// extension is explicit (g holds the band extra positions on each side: the
// sharded tier's halo rows) or implicit (g is the unextended field and the
// kernels read positions outside it as the sentinel 1e30; the backward then
// writes only the field's own positions, which is what F.pad's VJP keeps). The
// forward writes field f at column o_col + f * (field width) of an output of
// row pitch o_pitch; the backward reads S and ct there. One or two fields
// (pointers g0, g1; gridDim.z = images x fields). Layouts: float32, rows
// contiguous; images one after another.
//
// Skipped taps. A tap enters a sum only if its exponent z (times 1/T) is at
// least -27 (pallas_soft._CUT: a relative weight below e^-27); the kernels and
// their plain versions (ops/softmin.py) sum the same taps in the same order, d
// ascending, and agree bit for bit. The hard min walks outward from d = 0 and
// stops once a lower bound of the taps + d^2 reaches m; each sum runs over |d|
// <= reach, the last d whose exponent could pass the cut given that bound (a
// minimum of g' forward, a maximum of S backward). Float rounding is monotone,
// so both stops are exact.
//
// What bounds them on the H100: bytes on dense content (8 B per output pixel
// forward, 16 backward, against 3.35 TB/s), where the cut leaves ~8 taps a
// pixel; operations (about 5 per live tap forward, 6 backward, against 67
// TFLOP/s float32) where it leaves many. In practice neither: each pixel is a
// serial loop (the walk, then the sum with an accurate expf per live tap) whose
// length varies from lane to lane, so the kernels are bound by instruction
// issue and latency, several times their bound (PERF.md, rows 12-13). The
// design keeps device memory to one read of each input per strip and one write
// of each output, serves every tap from shared memory, and cuts the loops:
//   * staged strips. Inputs arrive through cp.async into rings in shared
//     memory; the next chunk's positions load while this chunk computes. Along
//     y (softmin_cols) a block owns 32 columns, one per lane, and walks a strip
//     of rows 128 at a time (16 warps x 8 rows); its ring of 16-row segments,
//     32 floats a row, holds the chunk's window and the next chunk's rows.
//     Along x (softmin_rows) each warp owns one row and walks it 128 positions
//     at a time, the lanes along the row: its ring is one row of 32-position
//     segments, a power of two of them, and the lanes share their taps. There
//     every lane runs the warp's widest tap range in step, so that each tap is
//     32 consecutive words (lanes stepping through their own ranges would hit
//     the same banks). Loads, targets and outputs run along the row: pass 1 runs
//     on the untransposed heights.
//   * segment bounds. Each segment's minimum of g' (forward) or maximum of S
//     (backward) is kept per lane (y) or per warp (x). A warp's walks and
//     reaches take the bound over the segments its taps cover (8 + 2 band
//     positions along y, 32 + 2 band along x), not over a whole tile's window;
//     the reach is a float32 estimate (sqrtf) corrected to the loop's integer.
//     Past a reach of 16, a segment (y) or a block of 32 taps (x) whose bound
//     leaves every tap below the cut is skipped.
//   * implicit sentinels, two fields in one launch and output offsets, so the
//     composed step has no pad, transpose, contiguous copy or cat around its
//     kernels.
// Backward along y reads ct at the live taps, straight from device memory
// (through L1; coalesced where the lanes' taps line up), which keeps one ring
// per block and two blocks per SM; along x a warp stages ct beside S (8 KB a warp at band
// 130). The staged instances take every band up to 720 along y (a block's ring
// of floor((2 band + 127) / 16) + 9 segments within its 227 KB) and 1920 along x
// (at most 128 segments a ring). Past that the launcher takes the global-load
// instance: the previous design, one thread per output pixel, taps loaded from
// device memory (through L1/L2), one bound per 32 x 128 tile. All instances
// share the per-pixel arithmetic.
//
// Exact numbers: every multiply and add is an _rn intrinsic, so nvcc contracts
// nothing into an FMA; expf and logf, no --use_fast_math. Offsets are 64-bit.

#include <cuda_runtime.h>

#include "staged.cuh"

namespace {

constexpr int kLanes = 32;                // lanes per block, one per thread of a warp
constexpr int kStride = kLanes;           // along y: ring row stride in floats (lane l in bank l)
constexpr int kWarps = 16;                // along y: warps per block
constexpr int kThreads = kWarps * kLanes;
constexpr int kSeg = 16;                  // positions per segment
constexpr int kPer = 8;                   // along y: positions per warp and chunk
constexpr int kChunk = kWarps * kPer;     // positions per chunk
constexpr int kShort = 16;                // a reach up to this runs every tap, no segment tests
constexpr int kRowWarps = 4;              // staged rows: warps (rows) per block
constexpr int kRowThreads = kRowWarps * kLanes;
constexpr int kRowPer = 4;                // staged rows: positions per lane and chunk
constexpr int kRowChunk = kRowPer * kLanes;
constexpr int kRowMaxQ = 128;             // staged rows: at most 128 segments of 32 a ring
constexpr int kGThreads = 256;            // global-load instance: threads per block
constexpr int kGRowLanes = kGThreads / kLanes;
constexpr int kTile = 128;                // global-load instance: positions per block
constexpr int kMaxSmem = 232448;          // a block's shared memory on sm_90
constexpr int kMaxBand = 16384;           // d * d stays an exact int
constexpr float kCut = 27.0f;             // pallas_soft._CUT
constexpr float kInf = __builtin_huge_valf();
constexpr float kPad = 1e30f;             // the sentinel height

struct Geo {
  int n, nf, npos, nlanes, band, axis, implicit;
  int g_pitch;         // floats per row of g (and dg)
  long long g_image;   // floats per image of g
  int o_pitch, o_col;  // out (forward) or S and ct (backward)
  long long o_image;
  int field_cols;      // columns from one field to the next in out / S / ct
  int nout;            // output positions per lane
  int sh, src_len;     // ring position u reads source index u - sh, valid in [0, src_len)
  int q_off;           // backward: tap d of output o reads S and ct at q = o + q_off - d
  int q_segs, strip;   // staged instance: ring segments, positions per strip
  float t, inv_t;
};

struct Ptrs {
  const float* g[2];
  const float* s;
  const float* ct;
  float* out[2];  // forward: out[0]; backward: dg per field
};

__device__ __forceinline__ long long at(int axis, int lane, long long pos, int pitch, int col) {
  return axis == 0 ? pos * pitch + col + lane : (long long)lane * pitch + col + pos;
}

// The exponents, as the plain versions form them.
__device__ __forceinline__ float fwd_z(float m, float v, int d, float inv_t) {
  return __fmul_rn(__fsub_rn(__fsub_rn(m, v), (float)(d * d)), inv_t);
}
__device__ __forceinline__ float bwd_z(float s, int d, float target, float inv_t) {
  return __fmul_rn(__fsub_rn(__fsub_rn(s, (float)(d * d)), target), inv_t);
}

// The hard min m of v(d) + d^2 over |d| <= band, walking outward from d = 0
// until vmin + d^2 reaches m (vmin bounds every tap from below).
template <class V>
__device__ __forceinline__ float hard_min(V v, int band, float vmin) {
  float m = v(0);
  for (int d = 1; d <= band; ++d) {
    const float dd = (float)(d * d);
    if (__fadd_rn(vmin, dd) >= m) break;
    m = fminf(m, __fadd_rn(fminf(v(-d), v(d)), dd));
  }
  return m;
}

// Forward reach: the last |d| whose exponent could pass the cut, every tap
// being at least vmin.
__device__ __forceinline__ int fwd_reach(float m, float vmin, int band, float t, float inv_t) {
  const float gap = __fsub_rn(m, vmin);
  return reach_of([=](int r) { return __fmul_rn(__fsub_rn(gap, (float)(r * r)), inv_t) >= -kCut; },
                  sqrtf(fmaxf(__fadd_rn(gap, kCut * t), 0.0f)), band);
}

// Backward reach: hi bounds S from above.
__device__ __forceinline__ int bwd_reach(float hi, float target, int band, float t, float inv_t) {
  return reach_of([=](int r) { return bwd_z(hi, r, target, inv_t) >= -kCut; },
                  sqrtf(fmaxf(__fadd_rn(__fsub_rn(hi, target), kCut * t), 0.0f)), band);
}

// ---------------------------------------------------------- staged cols (y)

// Along y a block owns 32 columns (lanes) and walks a strip of rows, 128
// output rows a chunk. Ring position u (source index u - sh) lives in ring
// slot u mod P, P = 16 q_segs, a row of 32 floats; segment j holds
// u in [16 j, 16 j + 16) and never straddles the ring's end. Forward, the tap
// at offset d of output o sits at ring position o + band + d; backward, S at
// tap d sits at o + band - d, and ct is read at the live taps. Warp
// w computes rows o0 + kPer w .. + kPer - 1 of each chunk, one column per lane.
template <bool kBwd>
__global__ void __launch_bounds__(kThreads, 2) softmin_cols(Ptrs ptrs, Geo p) {
  extern __shared__ float smem[];
  const int Q = p.q_segs, P = Q * kSeg, axis = 0;
  float* ring = smem;                // P x kStride: g' forward, S backward
  float* segb = ring + P * kStride;  // Q x kLanes: each segment's min / max
  const int tx = threadIdx.x % kLanes, w = threadIdx.x / kLanes;

  const int lane0 = blockIdx.x * kLanes, lane = lane0 + tx;
  const int img = blockIdx.z / p.nf, f = blockIdx.z % p.nf;
  const int band = p.band, nlanes = p.nlanes;
  const float t = p.t, inv_t = p.inv_t;
  const float* g = (f ? ptrs.g[1] : ptrs.g[0]) + p.g_image * img;
  const float* src = kBwd ? ptrs.s + p.o_image * img : g;
  const float* src_ct = kBwd ? ptrs.ct + p.o_image * img : nullptr;
  const int spitch = kBwd ? p.o_pitch : p.g_pitch, scol = kBwd ? p.o_col + f * p.field_cols : 0;
  float* out = kBwd ? (f ? ptrs.out[1] : ptrs.out[0]) + p.g_image * img : ptrs.out[0] + p.o_image * img;
  const int opitch = kBwd ? p.g_pitch : p.o_pitch, ocol = kBwd ? 0 : p.o_col + f * p.field_cols;
  const float fill = kBwd ? -kInf : kPad;

  const int o_start = blockIdx.y * p.strip;
  const int o_end = min(o_start + p.strip, p.nout);
  const int span = 2 * band + kChunk - 1;  // a chunk's taps: ring positions [o0, o0 + span]

  // segment j into segment slot js: 16 rows of 32 columns, coalesced
  const int sh = p.sh, src_len = p.src_len;
  auto load = [=](int j, int js) {
#pragma unroll
    for (int e = threadIdx.x; e < kSeg * kLanes; e += kThreads) {
      const int ld_lane = e % kLanes, ld_pos = e / kLanes;
      const long long q = (long long)j * kSeg + ld_pos - sh;
      const int gl = lane0 + ld_lane, k = (js * kSeg + ld_pos) * kStride + ld_lane;
      if (gl < nlanes && q >= 0 && q < src_len) cp_async4(ring + k, src + at(axis, gl, q, spitch, scol));
      else ring[k] = fill;
    }
  };

  // segment j sits in segment slot j mod Q: the chunk's first segment jb in
  // slot jbs, segment jb + k (k < Q) in wrapq(jbs + k)
  auto wrapq = [=](int x) { return x >= Q ? x - Q : x; };
  int issued = o_start / kSeg - 1, bounded = issued;
  int jbs = (o_start / kSeg) % Q, ljs = jbs;  // ljs: the slot of the next segment to load
  while (issued < (o_start + span) / kSeg) load(++issued, ljs), ljs = wrapq(ljs + 1);
  cp_commit();
  const float* rl = ring + tx;
  const float* rl_end = rl + P * kStride;
  const float* sl = segb + tx;
  for (int o0 = o_start; o0 < o_end; o0 += kChunk, jbs = wrapq(jbs + kChunk / kSeg)) {
    const int need = (o0 + span) / kSeg, jb = o0 / kSeg;
    cp_wait_all();
    __syncthreads();  // this chunk's segments are in; the last chunk's taps are read
    // the next chunk's segments load while this chunk computes
    const int pre = o0 + kChunk < o_end ? (o0 + kChunk + span) / kSeg : need;
    while (issued < pre) load(++issued, ljs), ljs = wrapq(ljs + 1);
    cp_commit();
    for (int j = bounded + 1 + w; j <= need; j += kWarps) {
      const int js = wrapq(jbs + j - jb);
      const float* col = rl + js * kSeg * kStride;
      float b = col[0];
#pragma unroll
      for (int i = 1; i < kSeg; ++i) b = kBwd ? fmaxf(b, col[i * kStride]) : fminf(b, col[i * kStride]);
      segb[js * kLanes + tx] = b;
    }
    bounded = need;
    __syncthreads();
    const int ow = o0 + kPer * w;  // this warp's first position
    if (ow >= o_end) continue;
    const int nw = min(kPer, o_end - ow);
    if (lane < nlanes) {
      float bnd = kBwd ? -kInf : kInf;  // over the segments this warp's taps cover
      for (int j = ow / kSeg, js = wrapq(jbs + j - jb); j <= (ow + kPer - 1 + 2 * band) / kSeg;
           ++j, js = wrapq(js + 1)) {
        const float b = sl[js * kLanes];
        bnd = kBwd ? fmaxf(bnd, b) : fminf(bnd, b);
      }
      // ring slot of output o: that of position o + band, jbs * kSeg + (o - o0) + band, wrapped once
      const int cb = jbs * kSeg + band - o0;
      for (int i = 0; i < nw; ++i) {
        const int o = ow + i;
        const int c = cb + o >= P ? cb + o - P : cb + o;
        const float* ctr = rl + c * kStride;
        float r;
        if (!kBwd) {
          // the walk, two pointers outward from d = 0, each wrapped at the ring's ends
          float m = *ctr;
          const float *lo = ctr, *hi = ctr;
          for (int d = 1; d <= band; ++d) {
            lo -= kStride;
            hi += kStride;
            lo = lo < rl ? lo + P * kStride : lo;
            hi = hi >= rl_end ? hi - P * kStride : hi;
            const float dd = (float)(d * d);
            if (__fadd_rn(bnd, dd) >= m) break;
            m = fminf(m, __fadd_rn(fminf(*lo, *hi), dd));
          }
          const int reach = fwd_reach(m, bnd, band, t, inv_t);
          float s = 0.0f;
          if (reach <= kShort && c >= reach && c + reach < P) {
            // a short reach that does not wrap: every tap in order
            const float* tap = ctr - reach * kStride;
            for (int d = -reach; d <= reach; ++d, tap += kStride) {
              const float z = fwd_z(m, *tap, d, inv_t);
              if (z >= -kCut) s = __fadd_rn(s, expf(z));
            }
          } else {
            // d ascending, one segment at a time (its taps are consecutive ring
            // slots); a segment whose bound leaves every one of its taps below
            // the cut is skipped
            for (int d = -reach; d <= reach;) {
              const int u = o + band + d, j = u / kSeg, dend = min(reach, (j + 1) * kSeg - 1 - o - band);
              const int dm = d > 0 ? d : (dend < 0 ? -dend : 0);
              const int js = wrapq(jbs + j - jb);
              if (fwd_z(m, sl[js * kLanes], dm, inv_t) >= -kCut) {
                const float* tap = rl + (js * kSeg + u % kSeg) * kStride;
                for (; d <= dend; ++d, tap += kStride) {
                  const float z = fwd_z(m, *tap, d, inv_t);
                  if (z >= -kCut) s = __fadd_rn(s, expf(z));
                }
              } else {
                d = dend + 1;
              }
            }
          }
          r = __fsub_rn(m, __fmul_rn(t, logf(s)));
        } else {
          const float target = g[at(0, lane, o, p.g_pitch, 0)];
          const int reach = bwd_reach(bnd, target, band, t, inv_t);
          const int qc = o + p.q_off;  // q = qc - d must lie in [0, npos)
          const int dlo = max(-reach, qc - (p.npos - 1)), dhi = min(reach, qc);
          // ct at tap d: read at q = qc - d (coalesced)
          float acc = 0.0f;
          auto taps = [&](int d, int dend, const float* tap) {
            const float* ctap = src_ct + at(0, lane, qc - d, p.o_pitch, scol);
            for (; d <= dend; ++d, tap -= kStride, ctap -= p.o_pitch) {
              const float z = bwd_z(*tap, d, target, inv_t);
              if (z >= -kCut) acc = __fadd_rn(acc, __fmul_rn(expf(z), *ctap));
            }
          };
          if (dhi - dlo <= 2 * kShort && c - dhi >= 0 && c - dlo < P) {
            taps(dlo, dhi, ctr - dlo * kStride);
          } else {
            for (int d = dlo; d <= dhi;) {
              // S at tap d sits at ring position u = o + band - d: segment j spans d up to dend
              const int u = o + band - d, j = u / kSeg, dend = min(dhi, o + band - j * kSeg);
              const int dm = d > 0 ? d : (dend < 0 ? -dend : 0);
              const int js = wrapq(jbs + j - jb);
              if (bwd_z(sl[js * kLanes], dm, target, inv_t) >= -kCut) taps(d, dend, rl + (js * kSeg + u % kSeg) * kStride);
              d = dend + 1;
            }
          }
          r = acc;
        }
        out[at(0, lane, o, opitch, ocol)] = r;
      }
    }
  }
}

// ---------------------------------------------------------- staged rows (x)

// Along x each warp owns one row (of one image and field) and walks a strip of
// it, 32 kRowPer output positions a chunk: lane l takes positions o0 + l + 32 k,
// k < kRowPer. The lanes lie along the tap axis, so they share their taps, and
// a warp's window is one row of 32 kRowPer + 2 band positions. Its ring (and
// backward its ct ring) holds q_segs segments of 32 positions, q_segs a power
// of two: position u in slot u & (32 q_segs - 1). Loads, taps, targets and
// outputs are all consecutive along the row. The next chunk's segments load
// while this chunk computes.
template <bool kBwd>
__global__ void __launch_bounds__(kRowThreads) softmin_rows(Ptrs ptrs, Geo p) {
  extern __shared__ float smem[];
  const int Q = p.q_segs, P = Q * kLanes, mask = P - 1;
  const int tx = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  float* ring = smem + w * P * (kBwd ? 2 : 1);  // this warp's ring
  float* ring_ct = ring + P;                    // backward: ct
  float* segb = smem + kRowWarps * P * (kBwd ? 2 : 1) + w * Q;  // this warp's segment bounds

  const int row = blockIdx.x * kRowWarps + w;
  if (row >= p.nlanes) return;
  const int img = blockIdx.z / p.nf, f = blockIdx.z % p.nf;
  const int band = p.band;
  const float t = p.t, inv_t = p.inv_t;
  const float* g = (f ? ptrs.g[1] : ptrs.g[0]) + p.g_image * img + (long long)row * p.g_pitch;
  const float* src = kBwd ? ptrs.s + p.o_image * img + (long long)row * p.o_pitch + p.o_col + f * p.field_cols : g;
  const float* src_ct = kBwd ? src - ptrs.s + ptrs.ct : nullptr;
  float* out = kBwd ? (f ? ptrs.out[1] : ptrs.out[0]) + p.g_image * img + (long long)row * p.g_pitch
                    : ptrs.out[0] + p.o_image * img + (long long)row * p.o_pitch + p.o_col + f * p.field_cols;
  const float fill = kBwd ? -kInf : kPad;

  const int o_start = blockIdx.y * p.strip;
  const int o_end = min(o_start + p.strip, p.nout);
  const int sh = p.sh, src_len = p.src_len;
  auto load = [=](int j) {
    const int q = j * kLanes + tx - sh, k = (j * kLanes + tx) & mask;
    if (q >= 0 && q < src_len) {
      cp_async4(ring + k, src + q);
      if (kBwd) cp_async4(ring_ct + k, src_ct + q);
    } else {
      ring[k] = fill;
      if (kBwd) ring_ct[k] = 0.0f;
    }
  };
  auto warp_bound = [](float b) {
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2) {
      const float o = __shfl_xor_sync(0xffffffffu, b, off);
      b = kBwd ? fmaxf(b, o) : fminf(b, o);
    }
    return b;
  };
  // the last segment that the taps of the chunk from o0 read
  auto need_of = [=](int o0) { return (o0 + kRowChunk - 1 + 2 * band) / kLanes; };

  int issued = o_start / kLanes - 1, bounded = issued;
  const int last = need_of((o_end - 1) / kRowChunk * kRowChunk);
  while (issued < need_of(o_start)) load(++issued);
  cp_commit();
  for (int o0 = o_start; o0 < o_end; o0 += kRowChunk) {
    const int need = need_of(o0);
    cp_wait_all();
    __syncwarp();  // the chunk's segments are in; the last chunk's taps are read
    while (issued < min(need_of(o0 + kRowChunk), last)) load(++issued);
    cp_commit();
    for (int j = bounded + 1; j <= need; ++j) {
      const float b = warp_bound(ring[(j * kLanes + tx) & mask]);
      if (tx == 0) segb[j & (Q - 1)] = b;
    }
    bounded = need;
    __syncwarp();
    for (int k = 0; k < kRowPer; ++k) {
      const int ok = o0 + k * kLanes;  // this step's 32 positions
      if (ok >= o_end) break;
      // the bound over the segments their taps cover
      float bnd = kBwd ? -kInf : kInf;
      for (int j = ok / kLanes + tx; j <= (ok + kLanes - 1 + 2 * band) / kLanes; j += kLanes)
        bnd = kBwd ? fmaxf(bnd, segb[j & (Q - 1)]) : fminf(bnd, segb[j & (Q - 1)]);
      bnd = warp_bound(bnd);
      // every lane runs the warp's widest tap range, d ascending, so that at each
      // step the lanes read 32 consecutive slots; a tap past a lane's own reach
      // fails the cut. Past a short reach, a block of 32 taps in which no lane's
      // segment bounds leave a tap above the cut is skipped.
      const int o = ok + tx;
      const bool valid = o < o_end;
      const int c = o + band;  // ring position of tap 0
      auto v = [=](int d) { return ring[(c + d) & mask]; };
      // the least exponent bound over the lane's taps in [a, b] (two segments at most)
      auto block_live = [=](int a, int b, float m_or_target) {
        if (a > b) return false;
        const int dm = a > 0 ? a : (b < 0 ? -b : 0);
        const int j1 = ((kBwd ? c - b : c + a) / kLanes) & (Q - 1), j2 = ((kBwd ? c - a : c + b) / kLanes) & (Q - 1);
        const float sb = kBwd ? fmaxf(segb[j1], segb[j2]) : fminf(segb[j1], segb[j2]);
        return kBwd ? bwd_z(sb, dm, m_or_target, inv_t) >= -kCut : fwd_z(m_or_target, sb, dm, inv_t) >= -kCut;
      };
      float r;
      if (!kBwd) {
        const float m = hard_min(v, band, bnd);
        const int reach = valid ? fwd_reach(m, bnd, band, t, inv_t) : 0;
        const int R = __reduce_max_sync(0xffffffffu, reach);
        float s = 0.0f;
        for (int d0 = -R; d0 <= R; d0 += kLanes) {
          const int d1 = min(d0 + kLanes - 1, R);
          if (R > kShort && !__any_sync(0xffffffffu, block_live(max(d0, -reach), min(d1, reach), m))) continue;
          for (int d = d0; d <= d1; ++d) {
            const float z = fwd_z(m, v(d), d, inv_t);
            if (z >= -kCut) s = __fadd_rn(s, expf(z));
          }
        }
        r = __fsub_rn(m, __fmul_rn(t, logf(s)));
      } else {
        const float target = valid ? g[o] : 0.0f;
        const int reach = bwd_reach(bnd, target, band, t, inv_t);
        const int qc = o + p.q_off;  // q = qc - d must lie in [0, npos); S outside it reads -inf
        const int dlo = valid ? max(-reach, qc - (p.npos - 1)) : 0, dhi = valid ? min(reach, qc) : -1;
        const int Dlo = __reduce_min_sync(0xffffffffu, dlo), Dhi = __reduce_max_sync(0xffffffffu, dhi);
        float acc = 0.0f;
        for (int d0 = Dlo; d0 <= Dhi; d0 += kLanes) {
          const int d1 = min(d0 + kLanes - 1, Dhi);
          if (Dhi - Dlo > 2 * kShort && !__any_sync(0xffffffffu, block_live(max(d0, dlo), min(d1, dhi), target)))
            continue;
          for (int d = d0; d <= d1; ++d) {
            // S and ct at tap d sit at ring position c - d
            const int kk = (c - d) & mask;
            const float z = bwd_z(ring[kk], d, target, inv_t);
            if (z >= -kCut) acc = __fadd_rn(acc, __fmul_rn(expf(z), ring_ct[kk]));
          }
        }
        r = acc;
      }
      if (valid)       out[o] = r;
    }
  }
}

// ------------------------------------------------------- global-load instance

template <bool kBwd>
__global__ void __launch_bounds__(kGThreads) softmin_global(Ptrs ptrs, Geo p) {
  __shared__ float part[kGRowLanes][kLanes];
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const int lane = blockIdx.x * kLanes + tx, o0 = blockIdx.y * kTile;
  const int img = blockIdx.z / p.nf, f = blockIdx.z % p.nf;
  const int band = p.band, axis = p.axis;
  const float* g = (f ? ptrs.g[1] : ptrs.g[0]) + p.g_image * img;
  const float* src = kBwd ? ptrs.s + p.o_image * img : g;
  const float* ctv = kBwd ? ptrs.ct + p.o_image * img : nullptr;
  const int spitch = kBwd ? p.o_pitch : p.g_pitch, scol = kBwd ? p.o_col + f * p.field_cols : 0;
  float* out = kBwd ? (f ? ptrs.out[1] : ptrs.out[0]) + p.g_image * img : ptrs.out[0] + p.o_image * img;
  const int opitch = kBwd ? p.g_pitch : p.o_pitch, ocol = kBwd ? 0 : p.o_col + f * p.field_cols;
  const int sh = p.sh, src_len = p.src_len;
  auto read = [=](long long u, float none) {
    const long long q = u - sh;
    return q >= 0 && q < src_len ? src[at(axis, lane, q, spitch, scol)] : none;
  };
  // the tile reads ring positions o0 .. o0 + kTile + 2 band - 1
  float bnd = kBwd ? -kInf : kInf;
  if (lane < p.nlanes) {
    const long long u1 = (long long)min(o0 + kTile, p.nout) + 2 * band;
    for (long long u = o0 + ty; u < u1; u += kGRowLanes) {
      const float v = read(u, kBwd ? -kInf : kPad);
      bnd = kBwd ? fmaxf(bnd, v) : fminf(bnd, v);
    }
  }
  part[ty][tx] = bnd;
  __syncthreads();
  bnd = part[0][tx];
  for (int i = 1; i < kGRowLanes; ++i) bnd = kBwd ? fmaxf(bnd, part[i][tx]) : fminf(bnd, part[i][tx]);
  if (lane >= p.nlanes) return;
  for (int i = ty; i < kTile; i += kGRowLanes) {
    const int o = o0 + i;
    if (o >= p.nout) break;
    const long long c = (long long)o + band;
    float r;
    if (!kBwd) {
      auto v = [=](int d) { return read(c + d, kPad); };
      const float m = hard_min(v, band, bnd);
      const int reach = fwd_reach(m, bnd, band, p.t, p.inv_t);
      float s = 0.0f;
      for (int d = -reach; d <= reach; ++d) {
        const float z = fwd_z(m, v(d), d, p.inv_t);
        if (z >= -kCut) s = __fadd_rn(s, expf(z));
      }
      r = __fsub_rn(m, __fmul_rn(p.t, logf(s)));
    } else {
      const float target = g[at(axis, lane, o, p.g_pitch, 0)];
      const int reach = bwd_reach(bnd, target, band, p.t, p.inv_t);
      const int qc = o + p.q_off;
      const int dlo = max(-reach, qc - (p.npos - 1)), dhi = min(reach, qc);
      float acc = 0.0f;
      for (int d = dlo; d <= dhi; ++d) {
        const float z = bwd_z(read(c - d, -kInf), d, target, p.inv_t);
        if (z >= -kCut) acc = __fadd_rn(acc, __fmul_rn(expf(z), ctv[at(axis, lane, qc - d, p.o_pitch, scol)]));
      }
      r = acc;
    }
    out[at(axis, lane, o, opitch, ocol)] = r;
  }
}

// ------------------------------------------------------------------ launch

// Shared memory of the staged instances: along y the ring of q_segs segments
// of 16 rows x 33 floats and their bounds; along x, per warp, the ring of
// q_segs segments of 32 floats (and backward the ct ring) and their bounds.
int staged_smem(bool bwd, int axis, int q_segs) {
  return (int)sizeof(float) * (axis == 0 ? q_segs * (kSeg * kStride + kLanes)
                                         : kRowWarps * q_segs * ((bwd ? 2 : 1) * kLanes + 1));
}

int prepare(bool bwd, int n, int nf, int npos, int nlanes, int band, int axis, int implicit, int o_pitch, int o_col,
            float t, float inv_t, Geo* p) {
  if (n < 1 || nf < 1 || nf > 2 || (long long)n * nf > 65535 || npos < 1 || nlanes < 1 || band < 0 ||
      band > kMaxBand || (axis != 0 && axis != 1) || o_col < 0)
    return (int)cudaErrorInvalidValue;
  const long long g_len = implicit ? npos : (long long)npos + 2LL * band;
  const int field_cols = axis == 0 ? nlanes : npos;
  if (g_len > 0x3fffffffLL || (long long)o_col + (long long)nf * field_cols > o_pitch)
    return (int)cudaErrorInvalidValue;
  Geo g{};
  g.n = n, g.nf = nf, g.npos = npos, g.nlanes = nlanes, g.band = band, g.axis = axis, g.implicit = implicit;
  g.g_pitch = axis == 0 ? nlanes : (int)g_len;
  g.g_image = g_len * nlanes;
  g.o_pitch = o_pitch, g.o_col = o_col;
  g.o_image = (long long)(axis == 0 ? npos : nlanes) * o_pitch;
  g.field_cols = field_cols;
  g.nout = bwd ? (int)g_len : npos;
  g.sh = bwd ? (implicit ? band : 2 * band) : (implicit ? band : 0);
  g.src_len = bwd ? npos : (int)g_len;
  g.q_off = implicit ? 0 : -band;
  // a chunk's window and the next chunk's segments; along x a power of two
  if (axis == 0) {
    g.q_segs = (2 * band + kChunk - 1) / kSeg + 1 + kChunk / kSeg;
  } else {
    g.q_segs = 1;
    while (g.q_segs < (2 * band + kRowChunk - 1) / kLanes + 1 + kRowPer) g.q_segs *= 2;
  }
  g.t = t, g.inv_t = inv_t;
  *p = g;
  return 0;
}

// Strips of the positions: enough to give the card about `target` blocks in
// all, each strip a whole number of chunks.
int strip_len(long long nout, int chunk, long long cols, long long target) {
  const long long chunks = (nout + chunk - 1) / chunk;
  long long strips = (target + cols - 1) / cols;
  strips = strips < 1 ? 1 : (strips > chunks ? chunks : strips);
  return (int)(((chunks + strips - 1) / strips) * chunk);
}

template <bool kBwd>
int launch(const Ptrs& ptrs, Geo p, int impl, cudaStream_t stream) {
  const int smem = staged_smem(kBwd, p.axis, p.q_segs);
  const bool fits = smem <= kMaxSmem && (p.axis == 0 || p.q_segs <= kRowMaxQ);
  if (impl == 1 && !fits) return (int)cudaErrorInvalidValue;
  const unsigned gz = (unsigned)(p.n * p.nf);
  const long long nout = p.nout;
  unsigned gx, gy;
  if (impl != 2 && fits) {
    auto kernel = p.axis == 0 ? softmin_cols<kBwd> : softmin_rows<kBwd>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (p.axis == 0) {
      // about one block per SM slot that the ring leaves: one pass over the card
      int per_sm = 1;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
      gx = (unsigned)((p.nlanes + kLanes - 1) / kLanes);
      p.strip = strip_len(nout, kChunk, (long long)gx * gz, (long long)sms * (per_sm > 0 ? per_sm : 1));
    } else {
      // rows are independent warps: a few waves of them
      gx = (unsigned)((p.nlanes + kRowWarps - 1) / kRowWarps);
      p.strip = strip_len(nout, kRowChunk, (long long)gx * gz, 16LL * sms);
    }
    gy = (unsigned)((nout + p.strip - 1) / p.strip);
    if (gy > 65535) return (int)cudaErrorInvalidValue;
    kernel<<<dim3(gx, gy, gz), p.axis == 0 ? kThreads : kRowThreads, smem, stream>>>(ptrs, p);
  } else {
    const long long tiles = (nout + kTile - 1) / kTile;
    if (tiles > 65535) return (int)cudaErrorInvalidValue;
    gx = (unsigned)((p.nlanes + kLanes - 1) / kLanes);
    softmin_global<kBwd><<<dim3(gx, (unsigned)tiles, gz), kGThreads, 0, stream>>>(ptrs, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launchers: plain C entry points for ctypes. npos is the number of output
// positions along the soft-min axis of one forward field (the rows or columns
// of S), nlanes the extent of the other axis; g0 (and g1 where nf = 2) hold
// npos (implicit = 1) or npos + 2 band (implicit = 0) positions along the axis.
// axis 0: along y, 1: along x. The forward writes field f at column o_col + f x
// (nlanes along y, npos along x) of an output of row pitch o_pitch; the
// backward reads S and ct there (s_pitch, s_col) and writes dg0, dg1 in g's
// shape. impl 0 picks the instance, 1 asks for the staged strip (an error where
// it does not fit), 2 for the global-load instance. t is float32(T), inv_t
// float32(1/T). Each launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

extern "C" int chaq_softmin_fwd(const void* g0, const void* g1, void* out, int n, int nf, int npos, int nlanes,
                                int band, int axis, int implicit, int o_pitch, int o_col, float t, float inv_t,
                                int impl, void* stream) {
  Geo p;
  const int rc = prepare(false, n, nf, npos, nlanes, band, axis, implicit, o_pitch, o_col, t, inv_t, &p);
  if (rc != 0) return rc;
  Ptrs ptrs{{(const float*)g0, (const float*)(nf > 1 ? g1 : g0)}, nullptr, nullptr, {(float*)out, nullptr}};
  return launch<false>(ptrs, p, impl, (cudaStream_t)stream);
}

extern "C" int chaq_softmin_bwd(const void* g0, const void* g1, const void* s, const void* ct, void* dg0, void* dg1,
                                int n, int nf, int npos, int nlanes, int band, int axis, int implicit, int s_pitch,
                                int s_col, float t, float inv_t, int impl, void* stream) {
  Geo p;
  const int rc = prepare(true, n, nf, npos, nlanes, band, axis, implicit, s_pitch, s_col, t, inv_t, &p);
  if (rc != 0) return rc;
  Ptrs ptrs{{(const float*)g0, (const float*)(nf > 1 ? g1 : g0)}, (const float*)s, (const float*)ct,
            {(float*)dg0, (float*)(nf > 1 ? dg1 : dg0)}};
  return launch<true>(ptrs, p, impl, (cudaStream_t)stream);
}

