// Banded Gaussian cols-conv kernels for Hopper (sm_90a): the pass 2 of the
// sharded declared-range soft field (parallel/sharded.py, the shard-local
// two-conv split of chaq_sdfgen_tpu/parallel/sharded.py:_local_soft_mm),
// which reads the pass-1 sums of a shard with a halo of k rows of its
// neighbours on each side.
//
// cols_conv replaces chaq_sdfgen_tpu/ops/pallas_band_conv.py:_cols_kernel
//   (cols_conv). out[o] = sum_{d = -k..k} w(d) in[o + row_off + d], w(d) =
//   exp(-d^2/T), zero outside the input's rows. The conv is its own adjoint
//   (symmetric taps, zero boundary), so one kernel serves both directions:
//   the forward reads the (h + 2k)-row halo'd slab and writes its h interior
//   rows (row_off = k); the backward reads the h-row cotangent and writes
//   the slab's h + 2k rows (row_off = -k). Tap radii up to 128: the TPU
//   kernel stops at 16, the alignment of its 16-row halo blocks, and runs
//   wider taps as an XLA einsum.
// p2_fused_fwd replaces _p2f_kernel (p2_fused_fwd): the cols conv of both
//   pass-1 sums (a_in, a_out) then the tails (soft_tails.cuh): d2 = c -
//   T log s (1e30 where s <= 1e-30), d = sqrt(max(d2, 0) + eps), field =
//   d_out - max(d_in - 1, 0), and the two d2 memos; (h + 2k) rows in, h out.
// p2_fused_bwd replaces _p2b_kernel (p2_fused_bwd): the tails' VJP from the
//   cotangent and the memos (dead windows give 0, never through the exp),
//   then the cols conv of ds_in and ds_out; h rows in, h + 2k out (the
//   halo rows' cotangents go back to their owners through the halo
//   exchange's VJP).
//
// Bound: the sums must stay bit for bit the plain versions', so each tap is
// an unfused multiply and add, two FP32 issue slots a tap and field; at k 29
// (cols_conv on the wide path) that floor lies above the bytes (4 B per
// pixel per operand read or written), at k 10 (the pair) below them.
//
// Design (PERF.md rows 17-19): all three kernels run on one column
// walker, with a producer (the input, or the tails' VJP of the cotangent and
// memos) and an epilogue (a store, or the tails) of each. What held the
// first design, a 64 x 64 output tile a block, back: each tap read its
// weight and the staged value from shared memory (2 loads for 2 float
// operations), and the 2k halo rows, with the producer, were staged again
// for every 64 rows. Now a block of 256 threads owns 32 columns and walks a
// strip of rows in 64-row chunks:
//   * a warp takes one 8-row group of the chunk, a lane one column: the
//     lane's 8 outputs sum their taps from a register window, so each
//     staged value is read once a thread (8 + 2k loads for 8 (2k + 1) taps),
//     and a warp's loads are one row of 32 columns, conflict-free;
//   * the taps come from the kernel's parameters at fixed offsets: the tap
//     loop is unrolled up to the wrappers' limit, radius 128, each step
//     behind a test of the radius (uniform over the block), so one instance
//     serves every radius. An instance unrolled only to 32 (the wide taps'
//     29, the pair's 10) runs these radii no faster
//     (scripts/torch_kernel_parts.py, part band_ceiling_32), so there are
//     no per-ceiling instances;
//   * a chunk's window (64 + 2k rows) sits in one of two buffers; the next
//     chunk's window is its last 2k rows, copied across, and 64 new rows.
//     cols_conv's and p2_fused_fwd's new rows are their inputs: cp.async
//     stages them straight into the other buffer while the current chunk's
//     sums run (zeros outside the input). p2_fused_bwd's producer is the
//     tails' VJP: the new rows' inputs are loaded into registers before the
//     sums and turned into ds after them, the VJP run on every row with the
//     outside ones zeroed by a select (no branch around it, so the 8 rows'
//     chains interleave). One barrier a chunk. The halo rows and the VJP
//     are produced once a strip, (S + 2k) / S times a pixel, not
//     (64 + 2k) / 64;
//   * the launcher sizes the strips: whole chunks, as many strips as fill
//     the card's resident blocks once (its occupancy, asked once per device
//     and radius), so one wave leaves no tail;
//   * shared memory 2 x fields x (64 + 2k) x 32 x 4 B: 31 KB at k 29, 43 KB
//     for the pair at k 10, 160 KB at k 128 with two fields.
// Tried and dropped (PERF.md): loading each window value a tap ahead (the
// loads left the radius tests and the registers rose to 124-255), strips
// of even length, one block walking a run of chunks across tiles (its
// neighbours then read other rows of the same columns), and 4 producer
// warps running the VJP beside 8 summing warps (the producers bound it).
// The soft_mm.cu strip walker (strip_walk) serves neither: it runs a rows
// conv into a ring before each cols chunk, holds radii up to 16 (its ring
// and skewed conv-input rows are sized for that), and takes 128 columns a
// block, which would leave a 4096-wide shard 32 blocks a strip.
// Float32 on CUDA cores, no tensor cores: TF32 or bf16 products move
// knee-pixel gradients by percents.
//
// Exact numbers: the sums run in the order d = -k .. k, each multiply and
// add an _rn intrinsic, so nvcc contracts nothing into an FMA; logf, expf,
// IEEE sqrt and reciprocal, no --use_fast_math; (d2 - c) / T is an exact
// product where T is a power of two (div_by). Each kernel's arithmetic is
// its plain version's (ops/band_conv.py), op for op (the VJP's gates as
// soft_tails.cuh forms them: the same bits).

#include <cuda_runtime.h>

#include "soft_tails.cuh"
#include "staged.cuh"

namespace {

constexpr int kMaxK = 128;                // tap radius limit
constexpr int kCols = 32;                 // columns a block: a lane each
constexpr int kPer = 8;                   // consecutive output rows a thread
constexpr int kWarps = 8;                 // row groups a chunk: a warp each
constexpr int kThreads = kCols * kWarps;  // 256
constexpr int kChunk = kPer * kWarps;     // output rows a chunk (64)

// The taps: w[i] = w(i - k), i <= 2k, zero past.
struct Taps {
  float w[2 * kMaxK + 1];
};

// Input planes of h_in rows, output planes of h_out rows, both w wide;
// output row o sums input rows o + row_off - k .. o + row_off + k.
struct Frame {
  int h_in, h_out, w, k, row_off;
};

// Producers. Where a field's conv input is its input itself (kCopy), src()
// gives it and the walker stages it with cp.async; else load() reads a
// pixel's inputs into registers and many() turns a thread's rows of them
// into each field's conv input.
struct Load1 {
  static constexpr int kFields = 1;
  static constexpr bool kCopy = true;
  const float* in;
  __device__ __forceinline__ const float* src(int) const { return in; }
};

struct Load2 {
  static constexpr int kFields = 2;
  static constexpr bool kCopy = true;
  const float* a;
  const float* b;
  __device__ __forceinline__ const float* src(int i) const { return i == 0 ? a : b; }
};

struct Vjp2 {
  static constexpr int kFields = 2, kRaw = 3;
  static constexpr bool kCopy = false;
  TailsVjp vjp;
  __device__ __forceinline__ void load(size_t i, float* r) const {
    r[0] = vjp.ct[i];
    r[1] = vjp.d2_in[i];
    r[2] = vjp.d2_out[i];
  }
  template <int N>
  __device__ __forceinline__ void many(const float (&r)[N][kRaw], float (&v)[N][kFields]) const {
    float g[N], a[N], b[N], di[N], dd[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      g[n] = r[n][0];
      a[n] = r[n][1];
      b[n] = r[n][2];
    }
    vjp.many(g, a, b, di, dd);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      v[n][0] = di[n];
      v[n][1] = dd[n];
    }
  }
};

// Epilogues: many() turns the sums of a thread's 8 output pixels into what
// each writes, store() writes one pixel's.
struct Store1 {
  static constexpr int kOut = 1;
  float* out;
  template <int N>
  __device__ __forceinline__ void many(const float (&s)[1][N], float (&v)[N][kOut]) const {
#pragma unroll
    for (int n = 0; n < N; ++n) v[n][0] = s[0][n];
  }
  __device__ __forceinline__ void store(size_t i, const float* v) const { out[i] = v[0]; }
};

struct Store2 {
  static constexpr int kOut = 2;
  float* a;
  float* b;
  template <int N>
  __device__ __forceinline__ void many(const float (&s)[2][N], float (&v)[N][kOut]) const {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      v[n][0] = s[0][n];
      v[n][1] = s[1][n];
    }
  }
  __device__ __forceinline__ void store(size_t i, const float* v) const {
    a[i] = v[0];
    b[i] = v[1];
  }
};

struct TailsEpi {
  static constexpr int kOut = 3;
  Tails tails;
  template <int N>
  __device__ __forceinline__ void many(const float (&s)[2][N], float (&v)[N][kOut]) const {
    float fld[N], a[N], b[N];
    tails.many(s[0], s[1], fld, a, b);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      v[n][0] = fld[n];
      v[n][1] = a[n];
      v[n][2] = b[n];
    }
  }
  __device__ __forceinline__ void store(size_t i, const float* v) const { tails.store(i, v[0], v[1], v[2]); }
};

// One 4-byte cp.async into shared memory, or a zero where copy is false
// (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async4_or_zero(float* dst, const float* src, bool copy) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(copy ? 4 : 0) : "memory");
}

// The taps 0 .. 2k of 8 consecutive outputs of each field's column: out[f][m]
// = sum_i w[i] src[f plane + (m + i) 32], i ascending from 0, each multiply
// and add rounded on its own (the plain version's order). Each staged value
// is read once into a register window; the loop is unrolled up to the
// radius limit, each step behind a test of the radius, so w[i] is a kernel
// parameter at a fixed offset.
template <int NF>
__device__ __forceinline__ void col_sums(const float* src, int plane, const float* w, int k,
                                         float (&out)[NF][kPer]) {
  float v[NF][kPer + 2 * kMaxK];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) out[f][m] = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer - 1; ++j) v[f][j] = src[f * plane + j * kCols];
  }
#pragma unroll
  for (int i = 0; i <= 2 * kMaxK; ++i) {
    if (i > 2 * k) break;
    const float wv = w[i];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      v[f][i + kPer - 1] = src[f * plane + (i + kPer - 1) * kCols];
#pragma unroll
      for (int m = 0; m < kPer; ++m) out[f][m] = __fadd_rn(out[f][m], __fmul_rn(wv, v[f][m + i]));
    }
  }
}

// A block: output columns [32 bx, 32 bx + 32) and rows [o_start, o_end) of
// image blockIdx.z, in 64-row chunks. Window row j of chunk c is input row
// y0 + 64 c + j (y0 = o_start + row_off - k), j < 64 + 2k; output row
// o_start + 64 c + t sums window rows t .. t + 2k. A pixel outside the input
// (rows or columns) gives a zero conv input (the conv's zero boundary).
template <class Producer, class Epilogue>
__device__ __forceinline__ void col_walk(const Producer& prod, const Epilogue& epi, const Frame& f, const Taps& taps,
                                         int strip) {
  constexpr int NF = Producer::kFields;
  extern __shared__ float smem[];  // [2 buffers][NF][64 + 2k][32]
  const int k = f.k, span = kChunk + 2 * k, plane = span * kCols;
  const int q = threadIdx.x % kCols, g = threadIdx.x / kCols;
  const int x = blockIdx.x * kCols + q;
  const bool col_in = x < f.w;
  const int o_start = blockIdx.y * strip, o_end = min(o_start + strip, f.h_out);
  const int chunks = (o_end - o_start + kChunk - 1) / kChunk;
  const int y0 = o_start + f.row_off - k;
  const size_t in_plane = (size_t)blockIdx.z * f.h_in * f.w;
  const size_t out_plane = (size_t)blockIdx.z * f.h_out * f.w;

  auto inside = [&](int y) { return col_in && y >= 0 && y < f.h_in; };
  // chunk c's sums from its window, then the epilogue
  auto finish = [&](int c, const float* cur) {
    float s[NF][kPer];
    col_sums<NF>(cur + kPer * g * kCols + q, plane, taps.w, k, s);
    float v[kPer][Epilogue::kOut];
    epi.many(s, v);
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int o = o_start + kChunk * c + kPer * g + m;
      if (col_in && o < o_end) epi.store(out_plane + (size_t)o * f.w + x, v[m]);
    }
  };
  // the next window's first 2k rows: this window's last 2k
  auto carry = [&](const float* cur, float* nxt) {
    for (int j = g; j < 2 * k; j += kWarps) {
#pragma unroll
      for (int i = 0; i < NF; ++i) nxt[i * plane + j * kCols + q] = cur[i * plane + (j + kChunk) * kCols + q];
    }
  };

  if constexpr (Producer::kCopy) {
    // rows first .. first + count - 1 of a window (those inside it) whose
    // row 0 is input row y_top, by cp.async, zeros outside the input
    auto stage = [&](int y_top, int first, int count, float* buf) {
      for (int j = first + g; j < first + count && j < span; j += kWarps) {
        const bool in = inside(y_top + j);
        const size_t i = in ? in_plane + (size_t)(y_top + j) * f.w + x : 0;
#pragma unroll
        for (int fld = 0; fld < NF; ++fld) cp_async4_or_zero(buf + fld * plane + j * kCols + q, prod.src(fld) + i, in);
      }
      cp_commit();
    };
    stage(y0, 0, span, smem);
    for (int c = 0; c < chunks; ++c) {
      float* cur = smem + (c & 1) * NF * plane;
      float* nxt = smem + ((c + 1) & 1) * NF * plane;
      cp_wait_all();
      __syncthreads();  // the chunk's window is in; the other buffer's last readers are done
      if (c + 1 < chunks) stage(y0 + kChunk * (c + 1), 2 * k, kChunk, nxt);  // in flight during the sums
      finish(c, cur);
      if (c + 1 < chunks) carry(cur, nxt);
    }
    return;
  } else {
    constexpr int NR = Producer::kRaw;
    // a thread's share of 64 rows of a window whose row 0 is input row
    // y_top: rows first + g + 8 m, those inside the window (a test uniform
    // over a warp); their inputs loaded into registers ahead of the
    // producer, zeros outside the input. The producer runs on all 8 rows at
    // once, with no branch around it (their chains interleave), and a zero
    // is selected where the pixel lies outside.
    auto fetch = [&](int y_top, int first, float(&r)[kPer][NR]) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int j = first + g + kWarps * m;
#pragma unroll
        for (int i = 0; i < NR; ++i) r[m][i] = 0.0f;
        if (j < span && inside(y_top + j)) prod.load(in_plane + (size_t)(y_top + j) * f.w + x, r[m]);
      }
    };
    auto put = [&](int y_top, int first, const float(&r)[kPer][NR], float* buf) {
      float v[kPer][NF];
      prod.many(r, v);
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int j = first + g + kWarps * m;
        if (j < span) {
          const bool in = inside(y_top + j);
#pragma unroll
          for (int i = 0; i < NF; ++i) buf[i * plane + j * kCols + q] = in ? v[m][i] : 0.0f;
        }
      }
    };
    // chunk 0's whole window, 128 rows at a time (both halves' loads first)
    float raw[kPer][NR], ahead[kPer][NR];
    for (int j = 0; j < span; j += 2 * kChunk) {
      fetch(y0, j, raw);
      fetch(y0, j + kChunk, ahead);
      put(y0, j, raw, smem);
      put(y0, j + kChunk, ahead, smem);
    }
    if (chunks > 1) fetch(y0 + kChunk, 2 * k, raw);
    for (int c = 0; c < chunks; ++c) {
      float* cur = smem + (c & 1) * NF * plane;
      float* nxt = smem + ((c + 1) & 1) * NF * plane;
      __syncthreads();  // the chunk's window is in; the other buffer's last readers are done
      finish(c, cur);
      if (c + 1 < chunks) {
        // the next window: this one's last 2k rows, then 64 new rows
        carry(cur, nxt);
        put(y0 + kChunk * (c + 1), 2 * k, raw, nxt);
        if (c + 2 < chunks) fetch(y0 + kChunk * (c + 2), 2 * k, raw);
      }
    }
  }
}

// grid (column tiles, strips, N); block 256.
__global__ void __launch_bounds__(kThreads) cols_conv_kernel(Load1 prod, Store1 epi, const __grid_constant__ Frame f,
                                                             const __grid_constant__ Taps taps, int strip) {
  col_walk(prod, epi, f, taps, strip);
}

__global__ void __launch_bounds__(kThreads) p2_fused_fwd_kernel(Load2 prod, TailsEpi epi,
                                                                const __grid_constant__ Frame f,
                                                                const __grid_constant__ Taps taps, int strip) {
  col_walk(prod, epi, f, taps, strip);
}

__global__ void __launch_bounds__(kThreads) p2_fused_bwd_kernel(Vjp2 prod, Store2 epi, const __grid_constant__ Frame f,
                                                                const __grid_constant__ Taps taps, int strip) {
  col_walk(prod, epi, f, taps, strip);
}

size_t smem_bytes(int fields, int k) { return sizeof(float) * 2 * (size_t)fields * (kChunk + 2 * k) * kCols; }

// Output rows a strip: whole chunks, as many strips as fill the card's
// resident blocks once (sms x per_sm over the column tiles of all images),
// at least one, at most one a chunk.
int strip_rows(int h_out, int w, int n, int sms, int per_sm) {
  const long long tiles = (long long)((w + kCols - 1) / kCols) * n, chunks = (h_out + kChunk - 1) / kChunk;
  long long strips = (long long)sms * (per_sm > 0 ? per_sm : 1) / tiles;
  strips = strips < 1 ? 1 : (strips > chunks ? chunks : strips);
  return (int)((chunks + strips - 1) / strips) * kChunk;
}

// Fills the taps, lets the kernel take its shared memory, sizes the strips
// and launches. The card's SMs and the kernel's resident blocks at each
// radius are asked once per device (a launch's host time is a share of
// these kernels' time).
template <class Kernel, class Producer, class Epilogue>
int launch_walk(Kernel kernel, const Producer& prod, const Epilogue& epi, const Frame& f, const float* taps_host, int n,
                cudaStream_t stream) {
  static size_t allowed[64];
  static int slots[64][kMaxK + 2];  // [device][0]: SMs, [device][1 + k]: blocks an SM (0: not asked)
  Taps taps;
  for (int i = 0; i <= 2 * kMaxK; ++i) taps.w[i] = i <= 2 * f.k ? taps_host[i] : 0.0f;
  const size_t smem = smem_bytes(Producer::kFields, f.k);
  int rc = allow_smem(kernel, smem, allowed);
  if (rc != 0) return rc;
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  if (dev < 64 && slots[dev][1 + f.k] > 0) {
    sms = slots[dev][0];
    per_sm = slots[dev][1 + f.k];
  } else {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (dev < 64 && per_sm > 0) {
      slots[dev][0] = sms;
      slots[dev][1 + f.k] = per_sm;
    }
  }
  const int strip = strip_rows(f.h_out, f.w, n, sms, per_sm);
  const dim3 grid((unsigned)((f.w + kCols - 1) / kCols), (unsigned)((f.h_out + strip - 1) / strip), (unsigned)n);
  kernel<<<grid, kThreads, smem, stream>>>(prod, epi, f, taps, strip);
  return (int)cudaGetLastError();
}

int check(int n, int h_in, int h_out, int w, int k, const float* taps_host) {
  return n < 1 || n > 65535 || h_in < 1 || h_out < 1 || w < 1 || k < 0 || k > kMaxK || taps_host == nullptr
             ? (int)cudaErrorInvalidValue
             : 0;
}

}  // namespace

// Launchers: plain C entry points for ctypes. Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError(). taps holds
// the 2k + 1 taps w(-k .. k). Output row o reads input rows o + row_off - k ..
// o + row_off + k of the h_in-row input (zero outside).

extern "C" int chaq_cols_conv(const void* in, void* out, int n, int h_in, int h_out, int w, int k,
                              int row_off, const float* taps, void* stream) {
  const int rc = check(n, h_in, h_out, w, k, taps);
  if (rc != 0) return rc;
  const Frame f{h_in, h_out, w, k, row_off};
  const Load1 prod{(const float*)in};
  const Store1 epi{(float*)out};
  return launch_walk(cols_conv_kernel, prod, epi, f, taps, n, (cudaStream_t)stream);
}

// a_in, a_out: (n, h_in, w); field and the memos (null: none): (n, h_out, w).
extern "C" int chaq_p2_fused_fwd(const void* a_in, const void* a_out, void* field, void* d2_in,
                                 void* d2_out, int n, int h_in, int h_out, int w, int k, int row_off,
                                 const float* taps, float t, float eps, float shift, void* stream) {
  if ((d2_in == nullptr) != (d2_out == nullptr)) return (int)cudaErrorInvalidValue;
  const int rc = check(n, h_in, h_out, w, k, taps);
  if (rc != 0) return rc;
  const Frame f{h_in, h_out, w, k, row_off};
  const Load2 prod{(const float*)a_in, (const float*)a_out};
  const TailsEpi epi{Tails{(float*)field, (float*)d2_in, (float*)d2_out, shift, t, eps}};
  return launch_walk(p2_fused_fwd_kernel, prod, epi, f, taps, n, (cudaStream_t)stream);
}

// ct, d2_in, d2_out: (n, h_in, w); da_in, da_out: (n, h_out, w).
extern "C" int chaq_p2_fused_bwd(const void* ct, const void* d2_in, const void* d2_out, void* da_in,
                                 void* da_out, int n, int h_in, int h_out, int w, int k, int row_off,
                                 const float* taps, float t, float eps, float shift, void* stream) {
  const int rc = check(n, h_in, h_out, w, k, taps);
  if (rc != 0) return rc;
  const Frame f{h_in, h_out, w, k, row_off};
  const Vjp2 prod{TailsVjp{(const float*)ct, (const float*)d2_in, (const float*)d2_out, shift, t, eps,
                           pow2_inverse(t)}};
  const Store2 epi{(float*)da_in, (float*)da_out};
  return launch_walk(p2_fused_bwd_kernel, prod, epi, f, taps, n, (cudaStream_t)stream);
}
