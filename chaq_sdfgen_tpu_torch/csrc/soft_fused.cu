// Undeclared-range soft SDF kernels for Hopper (sm_90a): the adaptive banded
// soft-min of ops/soft_fused.py, forward (F1, F2) and backward (B2, B1).
//
// Layouts (float32, contiguous): gray, field, ct and dgray are (n, h, w); S1,
// the d2 memos and dS1 are (n, 2, h, w), field 0 "in" (seeds on) and field 1
// "out". Pixels outside the image are no taps at all (the TPU kernels pad
// them with height 1e30, which contributes nothing).
//
// soft_f1 replaces chaq_sdfgen_tpu/ops/pallas_soft_fused.py:_f1_kernel
//   (f1_pass). Per pixel, l = (g - 127.5) * (+-1/tau), the heights
//   h_in = min(T softplus(-l), 1e30) and h_out = h_in + T l; then along x,
//   S1 = m - T log sum exp(((m - h[x+d]) - d^2) / T) over |d| <= band, m the
//   hard band-min of h[x+d] + d^2.
// soft_f2 replaces _f2_kernel (f2_pass): the same soft-min along y of each
//   S1 gives d2; d = sqrt(max(d2, 0) + eps), field = d_out - max(d_in - 1, 0);
//   the d2 memos are written for training.
// soft_b2 replaces _b2_kernel (b2_pass): the tails' VJP g from ct and the
//   memos (half = d2 > 0 ? 0.5/d : 0; in: -ct 1{d > 1} half; out: ct half),
//   then along y dS1[p] = sum_q exp(((d2[q] - (q-p)^2) - S1[p]) / T) g[q].
// soft_b1 replaces _b1_kernel (b1_pass): along x
//   dh[p] = sum_q exp(((S1[q] - (q-p)^2) - h[p]) / T) dS1[q], then
//   dgray = sum_f dh (-T) sigmoid(-l_f) (+-1/tau), zero where h >= 1e30.
//
// Skipped taps. A tap enters a sum only if its exponent z (times 1/T) is at
// least -27 (pallas_soft_fused._UNDERFLOW: a relative weight below e^-27).
// Each pixel walks its hard min centre-out and stops once a lower bound of
// its taps + d^2 >= m, and sums only |d| <= reach, the last d whose exponent
// could still pass the cut given that bound (or an upper one); float rounding
// is monotone, so both stops are exact: no tap that the plain version adds is
// left out. The plain version (ops/soft_fused.py) applies the same cut to
// every tap, and the sums run in the same order, d = -reach .. reach.
//
// Bound: operations, on data-dependent tap counts (a few taps each way on
// dense content, up to 2 band + 1 far from any seed); the bytes are 12 (F1),
// 20 (F2), 28 (B2) and 24 (B1) per pixel. Design: F1 and B1 run along rows,
// one block per row tile of up to 4096 (F1) or 2048 (B1) pixels, which stages
// its values over the tile and a band-wide halo in shared memory; F2 runs
// along columns, one block per 32-column x 96-row tile, which stages the
// tile's column window (96 + 2 band rows) one field at a time; B2 walks
// strips of columns. Bounds come from segment extrema, a warp's or a lane's
// own. Float32 on CUDA cores.
//
// F1 is a staged row (PERF.md row 8). What held its first design back: one
// block-wide min over the 256 + 2 band span set
// every pixel's hard-min stop and reach (one stroke anywhere in 388 pixels
// made all of them walk and sum far), the heights (expf and logf) were
// recomputed for every block that held a pixel, 1.52 times a pixel at band
// 66, the reach came from a serial loop, and lanes took different paths.
// Now a block of 16 warps owns a row tile of up to 4096 pixels:
//   * it stages the heights of both fields over the tile and a band-wide
//     halo, computed once a pixel (once in all where W <= 4096), with each
//     32-position segment's least height;
//   * warp k takes the 32-pixel chunks k, k + 16, ...: the least of its
//     taps (the 32 positions at each end one by one, the whole segments
//     between from their minima) sets each lane's hard-min stop and reach,
//     the reach a float32 estimate corrected to the loop's integer;
//   * a warp whose reaches are all at most 16 runs every tap, the cut as a
//     select (its lanes pass it together); else it goes segment by segment
//     and takes a segment's taps only out to the last |d| whose exponent,
//     formed from the segment's least height, still passes the cut, with a
//     branch around expf (its lanes pass it at different taps).
// On dense content the reaches are short already, so the taps (an accurate
// expf each, about half of them live) set the time there; on strokes the
// local bounds cut the loop.
//
// B2 is a staged strip (PERF.md row 10), as the column soft-min of
// softmin.cu. What held its first design back: one window-wide max of d2 set
// every pixel's reach (one large memo anywhere in a 32 x (64 + 2 band) tile
// made all its pixels loop over 2 band + 1 taps for ~8 that pass the cut),
// the tails' VJP (an IEEE sqrt and divide) was recomputed for each of the
// (64 + 2 band) / 64 tiles that hold a row, and two windows of 50-74 KB left
// 3-4 blocks an SM, each staging, reducing and waiting one field at a time.
// Now a block owns 32 columns (one per lane) of ONE field and walks a strip
// of rows (4 blocks per SM slot over the card), 32 rows a chunk, 4 per warp:
//   * d2 and ct arrive through cp.async into a ring of 16-row segments; the
//     next chunk's segments load while this chunk computes, so each input row
//     is read once per strip ((strip + 2 band) / strip times in all);
//   * when a segment lands, every warp takes 4 of its rows: g = tail_vjp(ct,
//     d2) replaces ct, computed once per staged element, and the rows' max of
//     d2 goes into the segment's per-lane max (atomicMax on an
//     order-preserving int form of the float);
//   * a warp's reach comes from the segments its 4 + 2 band taps cover (a
//     float32 estimate corrected to the loop's integer), and past a reach of
//     16 each segment whose max leaves every one of its taps below the cut is
//     skipped: its nearest tap's exponent, formed from the max, bounds all of
//     its taps' (rounding is monotone), so only taps that fail the cut go; a
//     warp takes one path (every tap, or segment by segment), not both;
//   * the ring takes (2 band + 31) / 16 + 3 segments of 2 x 16 x 32 floats:
//     54 KB at band 66 (4 blocks of 8 warps an SM), 74 KB at band 112 (3),
//     at most 64 registers a thread; S1 targets (loaded for a warp's rows
//     together) and dS1 stores are coalesced along the row.
// The sum runs d ascending over the taps that pass, as _weight_sum adds them.
//
// F2 (PERF.md row 9) stays a column tile. What held its first design back:
// one block-wide min of S1 over the tile's 32 x (64 + 2 band) window set
// every pixel's hard-min stop and reach (one small S1 anywhere in 196 rows
// made all 2048 pixels walk and sum far), the reach came from a serial loop,
// and each thread's 8 outputs a field were unrolled, 16 copies of the tap
// loops in all. Now a block owns 32 columns x 96 rows:
//   * per field a warp stages whole 16-row segments of the window (96 + 2
//     band rows, 2.4 reads of each S1 row at band 66, was 3.06), keeping
//     each one's least S1 per lane (column); 32-43 KB;
//   * warp w takes 12 consecutive rows; a lane's bound is the least S1 over
//     its own taps for those rows (the rows of the partial segments at the
//     ends one by one, the whole segments between from their minima); no
//     block-wide minimum remains;
//   * the reach is a float32 estimate corrected to the loop's integer
//     (reach_of); the lanes step together to the warp's longest, so the
//     loop's branch is uniform; a thread's rows run through one copy of the
//     loops (unrolled over its rows, they ran 7-22% slower).
// Built, measured and dropped (PERF.md row 9): a strip of both fields
// through B2's cp.async ring (its ring, barriers and per-row bookkeeping cost
// 0.30 ms before any tap: 0.76-0.82 ms on dense content against the
// parent's 0.59), both fields staged at once (4 blocks an SM, +4-10%), F1's
// per-segment reach clipping and B2's segment skips (+2-4%: on these inputs
// few segments can be skipped), the cut as a select (+30%). The sums run d
// ascending over the taps that pass, each behind a branch around expf.

// B1 is a staged row tile too (PERF.md row 11). What held its first design
// back: a block of 256 pixels re-read S1 and dS1 of both fields over 256 + 2
// band positions (1.52 times at band 66), and one block-wide max of S1 per
// field, found by a serial loop, set the reach of every pixel of the block.
// Now:
//   * a block of 16 warps owns a row tile of up to 2048 pixels and stages S1
//     and dS1 of both fields over it and a band-wide halo through cp.async,
//     with each 32-position segment's greatest S1 (38 KB at band 112: 4
//     blocks an SM, 32 registers a thread);
//   * a warp's reach per field comes from its own taps: the greatest S1 over
//     them (the 32 positions at each end one by one, the whole segments
//     between from their maxima) against the least height of its lanes (the
//     exponent bound is monotone in the height, so this is the largest of
//     the lanes' own reaches), a float32 estimate corrected to the loop's
//     integer; a field none of whose lanes' tap 0 passes is skipped;
//   * each field's loop runs d = -reach .. reach for the whole warp (its
//     lanes read consecutive positions), a tap's weight behind a branch
//     around expf.
// One loop a lane over both fields (the warp stepping max(n0 + n1) times,
// not max(n0) + max(n1)) and F1's per-segment clipping past a reach of 16
// were built and measured: the first cut the warp's steps by a quarter on
// noise in +-2000 but each step cost more (lanes apart in position and
// field, expf behind a select), the second lost a quarter on strokes (its
// lanes diverge between taking taps and finding segments); neither is
// kept (PERF.md row 11). The sums run d ascending over the taps that pass,
// as _weight_sum adds them.

// Halo-extended blocks (the sharded tier). F1 and B1 take a live-row window
// [ylo, yhi): a row outside it is beyond the image (an edge shard's halo),
// so F1 writes the clipped height 1e30 as its S1, which F2's cut drops like
// a missing tap, and B1 writes a zero dgray (pallas_soft_fused._params'
// prm[5:7]); a single-device call passes (0, h) and computes what it did
// before. F2 and B2 need no window: they take the S1 block with its halo
// rows attached as the image (pass2_ext), the caller crops the field and
// gives the halo rows a zero cotangent, and B2 returns their dS1 with the
// interior's.
//
// Exact numbers: every multiply and add is an _rn intrinsic, so nvcc
// contracts nothing into an FMA; expf, logf and IEEE sqrt and division, no
// --use_fast_math. Each kernel's arithmetic is its plain version's, op for op.

#include <cuda_runtime.h>

#include "staged.cuh"

namespace {

constexpr int kMaxBand = 112;      // pallas_soft_fused.fused_geometry_ok: band <= 128 - 16
constexpr int kLanes = 32;         // F2, B2: columns per block, one per lane
constexpr int kF2Threads = 256;    // F2: 8 warps
constexpr int kF2Warps = kF2Threads / kLanes;
constexpr int kF2Rows = 96;        // F2: output rows per block
constexpr int kF2Per = kF2Rows / kF2Warps;  // F2: consecutive rows per warp
constexpr int kB2Warps = 8;        // B2: warps per block
constexpr int kB2Threads = kB2Warps * kLanes;
constexpr int kSeg = 16;           // F2, B2: rows per segment (B2: of the ring)
constexpr int kB2Per = 4;          // B2: rows per warp and chunk
constexpr int kB2Chunk = kB2Warps * kB2Per;  // B2: rows per chunk
constexpr int kShort = 16;         // B2, F1, B1: a reach up to this runs every tap, no segment tests
constexpr int kRowSeg = 32;        // F1, B1: positions per segment bound (a warp's chunk)
constexpr int kRowTile = 4096;     // F1, B1: output pixels per block, at most (a row tile)
constexpr int kRowThreads = 512;   // F1, B1: 16 warps
constexpr float kCut = 27.0f;      // pallas_soft_fused._UNDERFLOW
constexpr float kPadH = 1e30f;     // height clip (pallas_soft_fused._PAD_H)
constexpr float kInf = __builtin_huge_valf();

struct Soft {
  int n, h, w, band;
  float scale;  // (+-1) x 1/tau rounded once: l = (g - 127.5) * scale
  float t, inv_t, eps;
  int ylo, yhi;  // F1/B1: the live rows
};

struct B2Geo {
  int h, w, band;
  float t, inv_t, eps;
  int col_blocks;  // blocks per field across the columns
  int q_segs;      // ring segments
  int strip;       // output rows per block
};

__device__ __forceinline__ float logit(float g, float scale) {
  return __fmul_rn(__fsub_rn(g, 127.5f), scale);
}

// h_in = min(T softplus(-l), 1e30), h_out = h_in + T l (softplus(l) =
// softplus(-l) + l), softplus open-coded as the TPU kernel has it.
__device__ __forceinline__ void heights(float l, float t, float& h0, float& h1) {
  const float x = -l;
  const float sp = __fadd_rn(fmaxf(x, 0.0f), logf(__fadd_rn(1.0f, expf(-fabsf(x)))));
  h0 = fminf(__fmul_rn(t, sp), kPadH);
  h1 = __fadd_rn(h0, __fmul_rn(t, l));
}

__device__ __forceinline__ float soft_dist(float d2, float eps) {
  return __fsqrt_rn(__fadd_rn(d2 > 0.0f ? d2 : 0.0f, eps));
}

// The tails' VJP at one pixel of one field.
__device__ __forceinline__ float tail_vjp(float ct, float d2, bool inside, float eps) {
  const float d = soft_dist(d2, eps);
  const float half = __fdiv_rn(d2 > 0.0f ? 0.5f : 0.0f, d);
  return inside ? __fmul_rn(-ct, d > 1.0f ? half : 0.0f) : __fmul_rn(ct, half);
}

// The heights' and threshold's VJP of one field: dh (-T) sigmoid(-l_f)
// (zero where the height is clipped) times dl_f/dgray = sgn scale.
__device__ __forceinline__ float height_vjp(float dh, float h, float lf, float sgn_scale, float t) {
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(lf)));
  const float dl = h < kPadH ? __fmul_rn(__fmul_rn(dh, -t), sig) : 0.0f;
  return __fmul_rn(dl, sgn_scale);
}

// ------------------------------------------------------------ F1, staged

// Min over the warp; every lane must call it.
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// F1's taps d .. dend of one field at staged position j, in order, each
// added to s if its exponent passes the cut. kBranch: a branch around expf,
// for warps whose lanes pass the cut at different taps (the long path);
// else a select (s + 0 is s), for warps whose lanes pass it together. d^2 as
// df * df: exact for |d| <= 112.
template <bool kBranch>
__device__ __forceinline__ void f1_taps(const float* hv, int j, int d, int dend, float m, float inv_t, float& s) {
  float df = (float)d;
  for (; d <= dend; ++d, df = __fadd_rn(df, 1.0f)) {
    const float z = __fmul_rn(__fsub_rn(__fsub_rn(m, hv[j + d]), __fmul_rn(df, df)), inv_t);
    if (kBranch) {
      if (z >= -kCut) s = __fadd_rn(s, expf(z));
    } else {
      s = __fadd_rn(s, z >= -kCut ? expf(z) : 0.0f);
    }
  }
}

// The bounds of one field's soft-min at staged position j, its taps hv[j +
// d], |d| <= band (+inf outside the image), for a warp whose taps are the
// positions from ws on: m, the hard min, walked centre-out until the least
// of the warp's taps + d^2 >= m; and reach, the last |d| whose exponent
// could still pass the cut given that least tap (a float32 estimate
// corrected to the loop's integer). The least of the warp's taps: the 32
// positions at each end (which hold the partial end segments) one by one,
// the whole segments between from segm (each 32-position segment's least
// height). live: the lane has a pixel (else m = +inf, reach 0).
__device__ __forceinline__ void f1_bounds(const float* hv, const float* segm, int j, int ws, int band, float t,
                                          float inv_t, bool live, float& m, int& reach) {
  const int lane = threadIdx.x & 31, we = ws + kRowSeg - 1 + 2 * band;
  const int s_first = (ws + kRowSeg - 1) / kRowSeg, s_last = (we + 1) / kRowSeg - 1;
  float lo = fminf(hv[ws + lane], hv[we - lane]);
  if (s_first + lane <= s_last) lo = fminf(lo, segm[s_first + lane]);
  const float vmin = warp_min(lo);
  m = kInf;
  reach = 0;
  if (!live) return;
  m = hv[j];
  float df = 1.0f;
  for (int d = 1; d <= band; ++d, df = __fadd_rn(df, 1.0f)) {
    const float dd = __fmul_rn(df, df);
    if (__fadd_rn(vmin, dd) >= m) break;
    m = fminf(m, __fadd_rn(fminf(hv[j - d], hv[j + d]), dd));
  }
  const float gap = __fsub_rn(m, vmin);
  reach = reach_of([=](int r) { return __fmul_rn(__fsub_rn(gap, (float)(r * r)), inv_t) >= -kCut; },
                   sqrtf(fmaxf(__fadd_rn(gap, kCut * t), 0.0f)), band);
}

// One field's sum of exp(z) over the taps |d| <= reach that pass the cut, d
// ascending, on the long path: segment by segment, a segment's taps taken
// only out to |d| <= rs, its own reach from its least height (the exponent
// formed from that height bounds its taps': rounding is monotone).
__device__ __forceinline__ float f1_segment_sum(const float* hv, const float* segm, int j, float m, int reach,
                                                float t, float inv_t) {
  float s = 0.0f;
  for (int d = -reach; d <= reach;) {
    const int sg = (j + d) / kRowSeg, dend = min(reach, (sg + 1) * kRowSeg - 1 - j);
    const float top = __fsub_rn(m, segm[sg]);
    const int rs = reach_of([=](int r) { return __fmul_rn(__fsub_rn(top, (float)(r * r)), inv_t) >= -kCut; },
                            sqrtf(fmaxf(__fadd_rn(top, kCut * t), 0.0f)), reach);
    f1_taps<true>(hv, j, max(d, -rs), min(dend, rs), m, inv_t, s);
    d = dend + 1;
  }
  return s;
}

// grid (tiles x H, N); block 512. A block owns a tile of up to 4096 pixels of
// one row, x in [x0, x0 + lt), and stages the heights of both fields at
// positions j = x - x0 + pad (pad: the band rounded up to a segment), +inf
// outside the image, computed once per pixel, with each 32-position
// segment's least height; then warp k takes the 32-pixel chunks k, k + 16, ...
// span: the staged positions of the longest tile.
__global__ void __launch_bounds__(kRowThreads) soft_f1_kernel(const float* gray, float* s1, Soft p, int tiles,
                                                           int pad, int span) {
  extern __shared__ float f1_smem[];
  float* hv = f1_smem;                 // field f's heights at hv + f * span
  float* segm = hv + 2 * span;         // field f's segment minima at segm + f * (span / 32)
  const int sps = span / kRowSeg;
  const int y = blockIdx.x / tiles, x0 = (blockIdx.x % tiles) * kRowTile;
  const int lt = min(kRowTile, p.w - x0);
  const size_t plane = (size_t)p.h * p.w;
  float* out = s1 + (size_t)blockIdx.y * 2 * plane + (size_t)y * p.w;
  if (y < p.ylo || y >= p.yhi) {  // beyond the image: no seed, height 1e30
    for (int x = x0 + threadIdx.x; x < x0 + lt; x += kRowThreads) {
      out[x] = kPadH;
      out[plane + x] = kPadH;
    }
    return;
  }
  const float* g = gray + (size_t)blockIdx.y * plane + (size_t)y * p.w;
  const int nchunks = (lt + kRowSeg - 1) / kRowSeg;
  const int nst = nchunks * kRowSeg + 2 * pad;  // a multiple of 32: whole warps go round the loop together
  for (int j = threadIdx.x; j < nst; j += kRowThreads) {
    const int x = x0 - pad + j;
    float h0 = kInf, h1 = kInf;
    if (x >= 0 && x < p.w) heights(logit(g[x], p.scale), p.t, h0, h1);
    hv[j] = h0;
    hv[span + j] = h1;
    h0 = warp_min(h0);
    h1 = warp_min(h1);
    if ((threadIdx.x & 31) == 0) {
      segm[j / kRowSeg] = h0;
      segm[sps + j / kRowSeg] = h1;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x / 32; k < nchunks; k += kRowThreads / 32) {
    const int j = pad + k * kRowSeg + (threadIdx.x & 31);
    const int x = x0 + j - pad;
    const bool live = x < p.w;
    const int ws = pad + k * kRowSeg - p.band;  // the warp's first tap
    float m0, m1;
    int r0, r1;
    f1_bounds(hv, segm, j, ws, p.band, p.t, p.inv_t, live, m0, r0);
    f1_bounds(hv + span, segm + sps, j, ws, p.band, p.t, p.inv_t, live, m1, r1);
    float s0 = 0.0f, s1 = 0.0f;
    // a warp takes one path for each field (lanes apart on two paths would
    // run both): every tap where all its reaches are short, else segment by
    // segment
    if (__all_sync(0xffffffffu, r0 <= kShort)) {
      if (live) f1_taps<false>(hv, j, -r0, r0, m0, p.inv_t, s0);
    } else if (live) {
      s0 = f1_segment_sum(hv, segm, j, m0, r0, p.t, p.inv_t);
    }
    if (__all_sync(0xffffffffu, r1 <= kShort)) {
      if (live) f1_taps<false>(hv + span, j, -r1, r1, m1, p.inv_t, s1);
    } else if (live) {
      s1 = f1_segment_sum(hv + span, segm + sps, j, m1, r1, p.t, p.inv_t);
    }
    if (live) {
      out[x] = __fsub_rn(m0, __fmul_rn(p.t, logf(s0)));
      out[plane + x] = __fsub_rn(m1, __fmul_rn(p.t, logf(s1)));
    }
  }
}

// ------------------------------------------------------------ B1, staged

constexpr int kB1Tile = 2048;  // B1: output pixels per block, at most (4 blocks an SM)

// Max over the warp; every lane must call it.
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// B1's exponent at tap distance r for the tap value top, against target:
// ((top - r^2) - target) / T, as _weight_sum forms it (r^2 exact up to 112).
__device__ __forceinline__ float b1_z(float top, int r, float target, float inv_t) {
  return __fmul_rn(__fsub_rn(__fsub_rn(top, (float)(r * r)), target), inv_t);
}

// The last |d| in [0, band] whose exponent could pass the cut given top, the
// greatest of the taps (a float32 estimate corrected to the loop's integer);
// -1 where even tap 0 fails that bound: no tap passes.
__device__ __forceinline__ int b1_reach(float top, float target, int band, float t, float inv_t) {
  if (!(b1_z(top, 0, target, inv_t) >= -kCut)) return -1;
  return reach_of([=](int r) { return b1_z(top, r, target, inv_t) >= -kCut; },
                  sqrtf(fmaxf(__fadd_rn(__fsub_rn(top, target), kCut * t), 0.0f)), band);
}

// The greatest S1 of one field over a warp's taps, the staged positions ws ..
// ws + 31 + 2 band: the 32 positions at each end (which hold the partial end
// segments) one by one, the whole segments between from segx (each
// 32-position segment's greatest value).
__device__ __forceinline__ float b1_warp_max(const float* sv, const float* segx, int ws, int band) {
  const int lane = threadIdx.x & 31, we = ws + kRowSeg - 1 + 2 * band;
  const int s_first = (ws + kRowSeg - 1) / kRowSeg, s_last = (we + 1) / kRowSeg - 1;
  float hi = fmaxf(sv[ws + lane], sv[we - lane]);
  if (s_first + lane <= s_last) hi = fmaxf(hi, segx[s_first + lane]);
  return warp_max(hi);
}

// One field's sum at staged position j for the warp's reach r: the taps d =
// -r .. r, all lanes stepping together over consecutive staged positions,
// each tap's weight added behind a branch around expf (a lane's taps past
// its own reach fail the cut). r = -1: no lane of the warp has a tap.
__device__ __forceinline__ float b1_taps(const float* sv, const float* sg, int j, int r, float target, float inv_t) {
  float acc = 0.0f, df = (float)(-r);
  for (int q = j - r; q <= j + r; ++q, df = __fadd_rn(df, 1.0f)) {
    const float z = __fmul_rn(__fsub_rn(__fsub_rn(sv[q], __fmul_rn(df, df)), target), inv_t);
    if (z >= -kCut) acc = __fadd_rn(acc, __fmul_rn(expf(z), sg[q]));
  }
  return acc;
}

// grid (tiles x H, N); block 512. A block owns a tile of up to 2048 pixels of
// one row, x in [x0, x0 + lt), and stages S1 and dS1 of both fields at
// positions j = x - x0 + pad (pad: the band rounded up to a segment; S1 -inf
// and dS1 0 outside the image), each value read once, with each 32-position
// segment's greatest S1; then warp k takes the 32-pixel chunks k, k + 16, ...
// span: the staged positions of the longest tile.
__global__ void __launch_bounds__(kRowThreads, 4) soft_b1_kernel(const float* gray, const float* s1,
                                                              const float* ds1, float* dgray, Soft p,
                                                              int tiles, int pad, int span) {
  extern __shared__ float b1_smem[];
  float* sv = b1_smem;          // field f's S1 at sv + f * span
  float* sg = sv + 2 * span;    // field f's dS1 at sg + f * span
  float* segx = sg + 2 * span;  // field f's segment maxima at segx + f * (span / 32)
  const int sps = span / kRowSeg, lane = threadIdx.x & 31;
  const int y = blockIdx.x / tiles, x0 = (blockIdx.x % tiles) * kB1Tile;
  const int lt = min(kB1Tile, p.w - x0);
  const size_t plane = (size_t)p.h * p.w;
  float* out = dgray + (size_t)blockIdx.y * plane + (size_t)y * p.w;
  if (y < p.ylo || y >= p.yhi) {  // beyond the image: its gray is no input
    for (int x = x0 + threadIdx.x; x < x0 + lt; x += kRowThreads) out[x] = 0.0f;
    return;
  }
  const size_t row = (size_t)blockIdx.y * 2 * plane + (size_t)y * p.w;
  const int nchunks = (lt + kRowSeg - 1) / kRowSeg;
  const int nst = nchunks * kRowSeg + 2 * pad;  // a multiple of 32
  for (int j = threadIdx.x; j < nst; j += kRowThreads) {
    const int x = x0 - pad + j;
    if (x >= 0 && x < p.w) {
      cp_async4(sv + j, s1 + row + x);
      cp_async4(sv + span + j, s1 + row + plane + x);
      cp_async4(sg + j, ds1 + row + x);
      cp_async4(sg + span + j, ds1 + row + plane + x);
    } else {
      sv[j] = -kInf;
      sv[span + j] = -kInf;
      sg[j] = 0.0f;
      sg[span + j] = 0.0f;
    }
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();
  for (int s = threadIdx.x / 32; s < nst / kRowSeg; s += kRowThreads / 32) {
    const float m0 = warp_max(sv[s * kRowSeg + lane]), m1 = warp_max(sv[span + s * kRowSeg + lane]);
    if (lane == 0) {
      segx[s] = m0;
      segx[sps + s] = m1;
    }
  }
  __syncthreads();
  const float* g = gray + (size_t)blockIdx.y * plane + (size_t)y * p.w;
  for (int k = threadIdx.x / 32; k < nchunks; k += kRowThreads / 32) {
    const int j = pad + k * kRowSeg + lane;
    const int x = x0 + k * kRowSeg + lane;
    const bool live = x < x0 + lt;
    const int ws = pad + k * kRowSeg - p.band;  // the warp's first tap
    const float v0 = b1_warp_max(sv, segx, ws, p.band), v1 = b1_warp_max(sv + span, segx + sps, ws, p.band);
    float l = 0.0f, h0 = kInf, h1 = kInf;  // no pixel: a height that lowers no bound, no tap passes
    if (live) {
      l = logit(g[x], p.scale);
      heights(l, p.t, h0, h1);
    }
    // the warp's reach per field: that of its least height (the bound is
    // monotone in the target), so the largest of its lanes'
    const int r0 = b1_reach(v0, warp_min(h0), p.band, p.t, p.inv_t);
    const int r1 = b1_reach(v1, warp_min(h1), p.band, p.t, p.inv_t);
    const float dh0 = b1_taps(sv, sg, j, r0, h0, p.inv_t), dh1 = b1_taps(sv + span, sg + span, j, r1, h1, p.inv_t);
    if (live) out[x] = __fadd_rn(height_vjp(dh0, h0, l, p.scale, p.t), height_vjp(dh1, h1, -l, -p.scale, p.t));
  }
}

// ------------------------------------------------------------ F2, a tile

// The least of one column's staged values over window rows [u0, u1] (col:
// the column's row 0, rows 32 apart): the rows of a partial 16-row segment at
// either end one by one, the whole segments between from segm (each
// segment's least value, segments 32 apart).
__device__ __forceinline__ float f2_window_min(const float* col, const float* segm, int u0, int u1) {
  const int j0 = u0 / kSeg, j1 = u1 / kSeg;
  float lo = kInf;
  auto rows = [&](int r0, int r1) {
    for (int r = r0; r <= r1; ++r) lo = fminf(lo, col[r * kLanes]);
  };
  if (j0 == j1) {
    rows(u0, u1);
    return lo;
  }
  if (u0 % kSeg == 0) lo = segm[j0 * kLanes]; else rows(u0, j0 * kSeg + kSeg - 1);
  for (int j = j0 + 1; j < j1; ++j) lo = fminf(lo, segm[j * kLanes]);
  if (u1 % kSeg == kSeg - 1) lo = fminf(lo, segm[j1 * kLanes]); else rows(j1 * kSeg, u1);
  return lo;
}

// grid (column blocks, row tiles, N); block 256. A block owns columns [x0, x0
// + 32) (one per lane) and rows [y0, y0 + 96) of image blockIdx.z; per field
// it stages window row r = image row y0 - band + r (+inf outside the image),
// segs segments of 16 rows, segment k by warp k mod 8 with its least value per
// lane; then warp w takes rows y0 + 12 w .. + 11. The field at a pixel needs
// both fields' d2: a thread keeps its rows' d2_in until their d2_out is formed.
__global__ void __launch_bounds__(kF2Threads) soft_f2_kernel(const float* s1, float* field, float* d2, Soft p,
                                                             int segs) {
  extern __shared__ float win[];          // segs x 16 x 32
  float* segm = win + segs * kSeg * kLanes;  // segs x 32
  const int tx = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  const int x = blockIdx.x * kLanes + tx, y0 = blockIdx.y * kF2Rows;
  const int band = p.band, h = p.h, W = p.w;
  const float t = p.t, inv_t = p.inv_t;
  const size_t plane = (size_t)h * W;
  const bool live = x < W;
  const int ow = w * kF2Per, nw = min(kF2Per, h - y0 - ow);  // the warp's rows of the tile
  float d2_in[kF2Per];
  for (int f = 0; f < 2; ++f) {
    const float* src = s1 + ((size_t)blockIdx.z * 2 + f) * plane;
    for (int k = w; k < segs; k += kF2Warps) {
      float v[kSeg];
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        const int y = y0 - band + k * kSeg + i;
        v[i] = live && y >= 0 && y < h ? src[(size_t)y * W + x] : kInf;
      }
      float lo = kInf;
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        win[(k * kSeg + i) * kLanes + tx] = v[i];
        lo = fminf(lo, v[i]);
      }
      segm[k * kLanes + tx] = lo;
    }
    __syncthreads();
    if (nw > 0) {
      const float* col = win + tx;
      // a lower bound of every tap of the warp's rows in this lane
      const float vmin = f2_window_min(col, segm + tx, ow, ow + nw - 1 + 2 * band);
      // one copy of the loops for the thread's rows
#pragma unroll 1
      for (int i = 0; i < nw; ++i) {
        const float* v = col + (ow + i + band) * kLanes;  // tap 0
        // m, the hard min walked centre-out until vmin + d^2 >= m; reach,
        // the last |d| whose exponent could pass the cut given vmin. A lane
        // without a pixel: reach 0.
        float m = kInf;
        int reach = 0;
        if (live) {
          m = v[0];
          float df = 1.0f;
          for (int d = 1; d <= band; ++d, df = __fadd_rn(df, 1.0f)) {
            const float dd = __fmul_rn(df, df);
            if (__fadd_rn(vmin, dd) >= m) break;
            m = fminf(m, __fadd_rn(fminf(v[-d * kLanes], v[d * kLanes]), dd));
          }
          const float gap = __fsub_rn(m, vmin);
          reach = reach_of([=](int r) { return __fmul_rn(__fsub_rn(gap, (float)(r * r)), inv_t) >= -kCut; },
                           sqrtf(fmaxf(__fadd_rn(gap, kCut * t), 0.0f)), band);
        }
        // the lanes step together to the warp's longest reach (a tap past a
        // lane's own reach fails the cut)
        reach = __reduce_max_sync(0xffffffffu, reach);
        if (!live) continue;
        float s = 0.0f, df = (float)(-reach);
        for (int d = -reach; d <= reach; ++d, df = __fadd_rn(df, 1.0f)) {
          const float z = __fmul_rn(__fsub_rn(__fsub_rn(m, v[d * kLanes]), __fmul_rn(df, df)), inv_t);
          if (z >= -kCut) s = __fadd_rn(s, expf(z));
        }
        const float val = __fsub_rn(m, __fmul_rn(t, logf(s)));
        const size_t at = (size_t)(y0 + ow + i) * W + x;
        if (d2 != nullptr) d2[((size_t)blockIdx.z * 2 + f) * plane + at] = val;
        if (f == 0) {
          d2_in[i] = val;
        } else {
          const float d_in = soft_dist(d2_in[i], p.eps), d_out = soft_dist(val, p.eps);
          field[(size_t)blockIdx.z * plane + at] =
              __fsub_rn(d_out, d_in > 1.0f ? __fsub_rn(d_in, 1.0f) : 0.0f);
        }
      }
    }
    __syncthreads();  // the window is restaged for the next field
  }
}

// ------------------------------------------------------------ B2, staged

// A block owns 32 columns (one per lane) of one field of one image and walks
// a strip of rows, 32 output rows a chunk: warp w takes rows o0 + 4 w .. + 3,
// one column per lane. Ring position u holds source row u - band (-inf and a
// zero g outside the image); output o's tap d sits at u = o + band + d. Ring
// position u lives in ring row u mod P, P = 16 q_segs: segment j holds
// u in [16 j, 16 j + 16) and never straddles the ring's end. The d2 memo and
// ct arrive through cp.async; when a segment lands, one pass turns its ct into
// g = tail_vjp(ct, d2) in place and keeps its maximum of d2 per lane. The
// next chunk's segments load while this chunk computes.
__device__ __forceinline__ float b2_z(float v, int d, float target, float inv_t) {
  return __fmul_rn(__fsub_rn(__fsub_rn(v, (float)(d * d)), target), inv_t);
}

// A float as an int whose order is the floats' (NaN as -inf, as fmaxf drops
// it), so that atomicMax on shared memory takes a segment's max; and back.
__device__ __forceinline__ int max_key(float v) {
  const int i = __float_as_int(v == v ? v : -kInf);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float key_value(int k) { return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff); }

__global__ void __launch_bounds__(kB2Threads, 4) soft_b2_kernel(const float* ct, const float* d2,
                                                                const float* s1, float* ds1, B2Geo p) {
  extern __shared__ float smem[];
  const int Q = p.q_segs, P = Q * kSeg;
  float* rd = smem;                // P x 32: d2
  float* rg = rd + P * kLanes;     // P x 32: ct as it lands, then g
  int* segb = (int*)(rg + P * kLanes);  // Q x 32: each segment's max of d2 (max_key)
  const int tx = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  const int f = blockIdx.x / p.col_blocks;
  const int x0 = (blockIdx.x % p.col_blocks) * kLanes, x = x0 + tx;
  const int band = p.band, h = p.h, W = p.w;
  const float t = p.t, inv_t = p.inv_t, eps = p.eps;
  const size_t plane = (size_t)h * W;
  const size_t fp = ((size_t)blockIdx.z * 2 + f) * plane;
  const float* src_d = d2 + fp;
  const float* src_ct = ct + (size_t)blockIdx.z * plane;
  const float* tgt = s1 + fp;
  float* out = ds1 + fp;

  const int o_start = blockIdx.y * p.strip;
  const int o_end = min(o_start + p.strip, h);
  const int span = 2 * band + kB2Chunk - 1;  // a chunk's taps: ring positions [o0, o0 + span]

  // segment j into ring segment slot js: 16 rows of 32 columns, coalesced
  auto load = [&](int j, int js) {
#pragma unroll
    for (int e = threadIdx.x; e < kSeg * kLanes; e += kB2Threads) {
      const int l = e % kLanes, r = e / kLanes;
      const int q = j * kSeg + r - band, k = (js * kSeg + r) * kLanes + l;
      if (x0 + l < W && q >= 0 && q < h) {
        const size_t o = (size_t)q * W + x0 + l;
        cp_async4(rd + k, src_d + o);
        cp_async4(rg + k, src_ct + o);
      } else {
        rd[k] = -kInf;
        rg[k] = 0.0f;
      }
      if (r == 0) segb[js * kLanes + l] = max_key(-kInf);
    }
  };

  // segment j sits in slot j mod Q: the chunk's first segment jb in slot jbs,
  // segment jb + k (k < Q) in wrapq(jbs + k)
  auto wrapq = [=](int v) { return v >= Q ? v - Q : v; };
  int issued = o_start / kSeg - 1, bounded = issued;
  int jbs = (o_start / kSeg) % Q, ljs = jbs;  // ljs: the slot of the next segment to load
  while (issued < (o_start + span) / kSeg) load(++issued, ljs), ljs = wrapq(ljs + 1);
  cp_commit();
  const float* dl = rd + tx;
  const float* gl = rg + tx;
  const int* sl = segb + tx;
  for (int o0 = o_start; o0 < o_end; o0 += kB2Chunk, jbs = wrapq(jbs + kB2Chunk / kSeg)) {
    const int need = (o0 + span) / kSeg, jb = o0 / kSeg;
    cp_wait_all();
    __syncthreads();  // this chunk's segments are in; the last chunk's taps are read
    const int pre = o0 + kB2Chunk < o_end ? (o0 + kB2Chunk + span) / kSeg : need;
    while (issued < pre) load(++issued, ljs), ljs = wrapq(ljs + 1);
    cp_commit();
    // the segments that landed, a quarter (4 rows) per warp and step: g in
    // place of ct, and each segment's max of d2
    for (int k = w; k < (need - bounded) * 4; k += kB2Warps) {
      const int js = wrapq(jbs + bounded + 1 + k / 4 - jb);
      float* cd = rd + (js * kSeg + (k % 4) * 4) * kLanes + tx;
      float* cg = rg + (js * kSeg + (k % 4) * 4) * kLanes + tx;
      float b = -kInf;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = cd[i * kLanes];
        // a tap at -inf fails the cut: its g is never read
        cg[i * kLanes] = v == -kInf ? 0.0f : tail_vjp(cg[i * kLanes], v, f == 0, eps);
        b = fmaxf(b, v);
      }
      atomicMax(segb + js * kLanes + tx, max_key(b));
    }
    bounded = need;
    __syncthreads();
    const int ow = o0 + kB2Per * w;  // this warp's first row
    if (ow >= o_end || x >= W) continue;
    const int nw = min(kB2Per, o_end - ow);
    float targets[kB2Per];  // S1 at the warp's rows, loaded together
#pragma unroll
    for (int i = 0; i < kB2Per; ++i) targets[i] = i < nw ? tgt[(size_t)(ow + i) * W + x] : 0.0f;
    float bnd = -kInf;  // over the segments this warp's taps cover
    for (int j = ow / kSeg, js = wrapq(jbs + j - jb); j <= (ow + kB2Per - 1 + 2 * band) / kSeg;
         ++j, js = wrapq(js + 1))
      bnd = fmaxf(bnd, key_value(sl[js * kLanes]));
    // ring row of output o's tap 0: jbs * 16 + (o - o0) + band, wrapped once
    const int cb = jbs * kSeg + band - o0;
#pragma unroll
    for (int i = 0; i < kB2Per; ++i) {
      if (i >= nw) break;
      const int o = ow + i;
      const int c = cb + o >= P ? cb + o - P : cb + o;
      const float target = targets[i];
      const int reach = reach_of([=](int r) { return b2_z(bnd, r, target, inv_t) >= -kCut; },
                                 sqrtf(fmaxf(__fadd_rn(__fsub_rn(bnd, target), kCut * t), 0.0f)), band);
      float acc = 0.0f;
      auto taps = [&](int d, int dend, int row) {
        for (; d <= dend; ++d, row += kLanes) {
          const float z = b2_z(dl[row], d, target, inv_t);
          if (z >= -kCut) acc = __fadd_rn(acc, __fmul_rn(expf(z), gl[row]));
        }
      };
      // the warp takes one path: lanes apart on two paths would run both
      if (__all_sync(__activemask(), reach <= kShort && c >= reach && c + reach < P)) {
        // short reaches that do not wrap: every tap in order
        taps(-reach, reach, (c - reach) * kLanes);
      } else {
        // d ascending, one segment at a time (its taps are consecutive ring
        // rows); a segment whose max leaves every one of its taps below the
        // cut is skipped
        for (int d = -reach; d <= reach;) {
          const int u = o + band + d, j = u / kSeg, dend = min(reach, (j + 1) * kSeg - 1 - o - band);
          const int dm = d > 0 ? d : (dend < 0 ? -dend : 0);
          const int js = wrapq(jbs + j - jb);
          if (b2_z(key_value(sl[js * kLanes]), dm, target, inv_t) >= -kCut)
            taps(d, dend, (js * kSeg + u % kSeg) * kLanes);
          d = dend + 1;
        }
      }
      out[(size_t)o * W + x] = acc;
    }
  }
}

int prepare(int n, int h, int w, int band, float scale, float t, float inv_t, float eps, int ylo,
            int yhi, Soft* p) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || band < 0 || band > kMaxBand) return (int)cudaErrorInvalidValue;
  if ((long long)((w + kRowTile - 1) / kRowTile) * h > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if ((h + kF2Rows - 1) / kF2Rows > 65535) return (int)cudaErrorInvalidValue;
  *p = Soft{n, h, w, band, scale, t, inv_t, eps, ylo, yhi};
  return 0;
}

// A row tile's staged positions: the longest tile rounded up to a segment,
// and a band-wide halo each side (pad: the band rounded up to a segment).
int row_pad(int band) { return (band + kRowSeg - 1) / kRowSeg * kRowSeg; }
int row_span(int w, int band, int tile) { return (min(w, tile) + kRowSeg - 1) / kRowSeg * kRowSeg + 2 * row_pad(band); }

dim3 col_grid(const Soft& p) {
  return dim3((unsigned)((p.w + kLanes - 1) / kLanes), (unsigned)((p.h + kF2Rows - 1) / kF2Rows),
              (unsigned)p.n);
}

// F2's window: 96 + 2 band rows in 16-row segments, and each segment's least
// value per lane (32 KB at band 66, 43 KB at band 112).
int col_segs(int band) { return (kF2Rows + 2 * band + kSeg - 1) / kSeg; }
size_t col_smem(int band) { return sizeof(float) * (size_t)col_segs(band) * (kSeg + 1) * kLanes; }

}  // namespace

// Launchers: plain C entry points for ctypes. Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError(). scale is
// (+-1) x float32(1/tau), inv_t float32(1/T); eps is read by F2 and B2 only,
// the live rows [ylo, yhi) by F1 and B1 only.

extern "C" int chaq_soft_f1(const void* gray, void* s1, int n, int h, int w, int band, float scale,
                            float t, float inv_t, float eps, int ylo, int yhi, void* stream) {
  Soft p;
  const int rc = prepare(n, h, w, band, scale, t, inv_t, eps, ylo, yhi, &p);
  if (rc != 0) return rc;
  const int tiles = (w + kRowTile - 1) / kRowTile;
  const int pad = row_pad(band), span = row_span(w, band, kRowTile);  // at most 4352 positions: 35 KB
  const size_t smem = sizeof(float) * 2 * ((size_t)span + span / kRowSeg);
  soft_f1_kernel<<<dim3((unsigned)(tiles * h), (unsigned)n), kRowThreads, smem, (cudaStream_t)stream>>>(
      (const float*)gray, (float*)s1, p, tiles, pad, span);
  return (int)cudaGetLastError();
}

extern "C" int chaq_soft_f2(const void* s1, void* field, void* d2, int n, int h, int w, int band,
                            float scale, float t, float inv_t, float eps, int ylo, int yhi,
                            void* stream) {
  Soft p;
  const int rc = prepare(n, h, w, band, scale, t, inv_t, eps, ylo, yhi, &p);
  if (rc != 0) return rc;
  soft_f2_kernel<<<col_grid(p), kF2Threads, col_smem(band), (cudaStream_t)stream>>>(
      (const float*)s1, (float*)field, (float*)d2, p, col_segs(band));
  return (int)cudaGetLastError();
}

extern "C" int chaq_soft_b2(const void* ct, const void* d2, const void* s1, void* ds1, int n, int h,
                            int w, int band, float scale, float t, float inv_t, float eps, int ylo,
                            int yhi, void* stream) {
  Soft p;
  int rc = prepare(n, h, w, band, scale, t, inv_t, eps, ylo, yhi, &p);
  if (rc != 0) return rc;
  B2Geo g{h, w, band, t, inv_t, eps, (w + kLanes - 1) / kLanes, 0, 0};
  // a chunk's window and the next chunk's segments: at most 74 KB (band 112)
  g.q_segs = (2 * band + kB2Chunk - 1) / kSeg + 1 + kB2Chunk / kSeg;
  const int smem = (int)sizeof(float) * g.q_segs * (2 * kSeg * kLanes + kLanes);
  if (smem > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(soft_b2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != 0) return rc;
  }
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, soft_b2_kernel, kB2Threads, smem);
  // strips of whole chunks, about four blocks per SM slot in all: the strips'
  // halo rows stay a small share, and blocks that meet strokes (long tap
  // loops) do not leave a last wave to a few SMs
  const long long cols = 2LL * g.col_blocks * n, chunks = (h + kB2Chunk - 1) / kB2Chunk;
  long long strips = (4LL * sms * (per_sm > 0 ? per_sm : 1) + cols - 1) / cols;
  strips = strips < 1 ? 1 : (strips > chunks ? chunks : strips);
  g.strip = (int)(((chunks + strips - 1) / strips) * kB2Chunk);
  const dim3 grid((unsigned)(2 * g.col_blocks), (unsigned)((h + g.strip - 1) / g.strip), (unsigned)n);
  soft_b2_kernel<<<grid, kB2Threads, smem, (cudaStream_t)stream>>>(
      (const float*)ct, (const float*)d2, (const float*)s1, (float*)ds1, g);
  return (int)cudaGetLastError();
}

extern "C" int chaq_soft_b1(const void* gray, const void* s1, const void* ds1, void* dgray, int n,
                            int h, int w, int band, float scale, float t, float inv_t, float eps,
                            int ylo, int yhi, void* stream) {
  Soft p;
  const int rc = prepare(n, h, w, band, scale, t, inv_t, eps, ylo, yhi, &p);
  if (rc != 0) return rc;
  const int tiles = (w + kB1Tile - 1) / kB1Tile;
  const int pad = row_pad(band), span = row_span(w, band, kB1Tile);
  // S1 and dS1 of both fields and the segment maxima: at most 38 KB (band
  // 112), 4 blocks of 16 warps an SM
  const int smem = (int)sizeof(float) * (4 * span + 2 * (span / kRowSeg));
  if (smem > 48 * 1024) {
    const int rc2 = (int)cudaFuncSetAttribute(soft_b1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc2 != 0) return rc2;
  }
  soft_b1_kernel<<<dim3((unsigned)(tiles * h), (unsigned)n), kRowThreads, smem, (cudaStream_t)stream>>>(
      (const float*)gray, (const float*)s1, (const float*)ds1, (float*)dgray, p, tiles, pad, span);
  return (int)cudaGetLastError();
}
