"""Where nine kernels' time goes, on one NVIDIA GPU: soft_b1, soft_mm_bwd,
soft_f2, soft_mm_fwd, the cols-conv kernels (cols_conv, p2_fused_fwd,
p2_fused_bwd) and the row passes (edt_rows, brute_rows) timed as built,
then built again from an edited copy of chaq_sdfgen_tpu_torch/csrc with one
part stripped out or changed, so the difference is that part's share or
that design's cost. A stripped kernel computes wrong values; it is timed
only, never used. The design variants (f2_64_rows .. f2_both_fields,
fwd_divide, band_vjp_div, band_slow_paths, band_one_chunk_strips ..
band_ceiling_32, rows_scalar_walk .. rows_lb4) compute the same values.

    python3 scripts/torch_kernel_parts.py [part ...]

(the parts named, or whose names start with a word given, and "as built";
all of them with no argument)

Parts (each an exact text replacement; a replacement that no longer matches
the sources stops the script):
  b1_no_taps      soft_b1 without its tap loops (staging, heights, reaches
                  and the VJP are left);
  b1_no_expf      soft_b1's taps without expf;
  mm_no_vjp       soft_mm_bwd without the tails' VJP (ds = the staged
                  cotangent and memo);
  mm_no_occ_vjp   soft_mm_bwd without the occupancy VJP (dgray = a sum);
  mm_divide       soft_mm_bwd dividing by T and tau where they are powers of
                  two too (no exact products);
  f2_no_walk      soft_f2 without its hard-min walk (m = the centre tap);
  f2_no_taps      soft_f2 without its sum over the taps (the reach is left);
  f2_64_rows      soft_f2 with 64-row tiles (the parent's);
  f2_lane_reach   soft_f2's lanes each to its own reach, not the warp's
                  longest;
  f2_unrolled     soft_f2's loop over a thread's rows unrolled (the
                  parent's);
  f2_select       soft_f2's cut as a select (expf for every tap looped);
  f2_both_fields  soft_f2 staging both fields' windows at once (twice the
                  shared memory, one barrier pair);
  fwd_no_occ      soft_mm_fwd without the occupancies' transcendentals;
  fwd_no_tails    soft_mm_fwd without the tails (field = a sum, no memos);
  fwd_divide      soft_mm_fwd dividing by tau where it is a power of two
                  too (the design before it; its values are right);
  band_one_tap    the cols-conv kernels with one tap (the window's loads,
                  the producer, the copy and the epilogue are left);
  band_no_vjp     p2_fused_bwd without the tails' VJP (ds = the staged
                  cotangent and the sum of the memos);
  band_vjp_no_div, band_vjp_no_exp  the tails' VJP without its gates'
                  reciprocals (products) or its expf;
  band_no_sqrt    the batched tails and VJP without their square roots;
  band_vjp_div    the VJP's gates (0.5 or 0) / d as IEEE divisions (the
                  first design; the same bits as (0.5 or 0) rcp(d));
  band_slow_paths the batched tails and VJP through __fsqrt_rn and
                  __frcp_rn (a branch to a slow path each), not the fast
                  paths written out (the same bits);
  band_no_tails   p2_fused_fwd without the tails (the field a sum, the
                  memos the sums);
  band_tails_no_log   the tails without logf;
  band_one_chunk_strips  strips of one 64-row chunk: the parent's tiling of
                  rows, each tile producing its 2k halo rows again;
  band_blocks_1, band_blocks_2  strips sized for 1 or 2 resident blocks
                  an SM, not the occupancy the card reports;
  band_no_prefetch    cols_conv's and p2_fused_fwd's next window staged
                  after the sums, not during them;
  band_lb_cols6, band_lb_fwd4, band_lb_bwd3, band_lb_bwd4  the kernels'
                  registers held to 6 blocks an SM (cols_conv), 4
                  (p2_fused_fwd), 3 or 4 (p2_fused_bwd);
  band_load_ahead     each tap's new window value loaded a tap ahead of
                  its use, not in the tap that first adds it;
  band_one_batch  p2_fused_bwd's first window 64 rows at a time, not both
                  halves' loads first;
  band_128_threads    blocks of 4 warps, 32-row chunks;
  band_16_rows    16 outputs a thread, blocks of 4 warps (64-row chunks);
  band_ceiling_32     the tap loop unrolled to radius 32, not 128 (the
                  same values at these inputs' radii, 10 and 29);
  rows_no_scan    the row passes without their ballot-and-shuffle scans
                  (each chunk walked from no seed outside it);
  rows_copy       the row passes' loads, masks and stores only (no scan,
                  no walk);
  rows_scalar_walk    the epilogues a pixel a step, not two (row_words.cuh's
                  pairs);
  rows_no_bool_path   every word's masks by the tri-state byte tests;
  rows_no_prefetch    a warp a segment, its codes staged when it starts
                  (not during the walk of its previous one);
  rows_unroll_1, rows_walk_unroll_1  the mask loop, or the right-to-left
                  walk, not unrolled;
  rows_byte_stores    every output stored a byte or element at a time;
  rows_one_step   segments of one step (512 pixels), each with a look
                  around its ends;
  rows_whole_rows     a warp a whole row at any launch size (no segments);
  rows_lb3, rows_lb4  the row kernels' registers held to 3 or 4 blocks an
                  SM.
Times: CUDA events around 10 back-to-back calls, the median of 5 windows
(chip_smoke.cuda_ms), at 4096x4096, spread 64, tau 2, T 1, on the inputs
chip_smoke.py uses (soft_f2 on all three, the declared kernels on the
bench's noise at k 10); the cols-conv kernels on phase 26's and the row
passes on the glyph (edt_rows at bands 66 and 302, brute_rows at spread
64, whole and on a 1024-row shard) as a CUDA graph of 10 calls
(chip_smoke.graph_ms: their host launch cost is near their device time);
the card's name and power limit are printed first.
"""

import os
import shutil
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from chaq_sdfgen_tpu_torch.ops import (  # noqa: E402
    _build, band_conv, cuda_brute, cuda_edt, cuda_soft_mm, soft_fused, soft_mxu,
)

# soft_f2's staging of one field's window, and of both at once (f2_both_fields)
F2_STAGE = """  for (int f = 0; f < 2; ++f) {
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
      const float vmin = f2_window_min(col, segm + tx, ow, ow + nw - 1 + 2 * band);"""
F2_STAGE_BOTH = """  for (int k = w; k < 2 * segs; k += kF2Warps) {
    const int ff = k / segs, kk = k - ff * segs;
    const float* src = s1 + ((size_t)blockIdx.z * 2 + ff) * plane;
    float v[kSeg];
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const int y = y0 - band + kk * kSeg + i;
      v[i] = live && y >= 0 && y < h ? src[(size_t)y * W + x] : kInf;
    }
    float lo = kInf;
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      win[((ff * segs + kk) * kSeg + i) * kLanes + tx] = v[i];
      lo = fminf(lo, v[i]);
    }
    segm[(ff * segs + kk) * kLanes + tx] = lo;
  }
  __syncthreads();
  for (int f = 0; f < 2; ++f) {
    if (nw > 0) {
      const float* col = win + f * segs * kSeg * kLanes + tx;
      const float vmin = f2_window_min(col, segm + f * segs * kLanes + tx, ow, ow + nw - 1 + 2 * band);"""

# the row passes' scans: the carries before each step, and each lane's nearest
# seeds outside its chunk (the walk then reads only what the look-arounds give)
ROWS_NO_SCAN = [
    ("row_words.cuh", "        take<true, K>(c, m, bt, bf, kAll, (int)((js + s * kLanes) * kChunk - e0));\n", ""),
    ("row_words.cuh", "        take<true, K>(lo, m, bt, bf, below, x0);\n        take<false, K>(hi, m, bt, bf, above, x0);\n"
                      "        take<false, K>(after, m, bt, bf, kAll, x0);\n", ""),
]
# brute_rows' epilogue a pixel a step (the pairs' design before it)
BRUTE_SCALAR_SIDE = """template <bool kLeft>
__device__ __forceinline__ void side(uint32_t mp, int x0, int n1, int n2, int sent, int* d1, int* d2) {
#pragma unroll
  for (int k = 0; k < rw::kChunk; ++k) {
    const int i = kLeft ? k : rw::kChunk - 1 - k;
    if (mp >> i & 1u) n2 = n1, n1 = x0 + i;
    d1[i] = min(kLeft ? x0 + i - n1 : n1 - x0 - i, sent);
    d2[i] = min(kLeft ? x0 + i - n2 : n2 - x0 - i, sent);
  }
}

// The epilogue of brute_rows (row_words.cuh's walk, K = 2)"""
BRUTE_PAIRS_BODY = """    uint32_t sel[8], d1[8], d2[8];
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
    }"""
BRUTE_SCALAR_BODY = """    int d1[rw::kChunk], d2[rw::kChunk];
#pragma unroll
    for (int pol = 0; pol < 2; ++pol) {
      const uint32_t mp = m >> (16 * pol) & 0xffffu;
      T* dst = out + 4 * pol * plane;
      side<true>(mp, x0, pol ? lo.f[0] : lo.t[0], pol ? lo.f[1] : lo.t[1], sent, d1, d2);
      rw::put_chunk(dst, j, d1, e0, w, vec);
      rw::put_chunk(dst + plane, j, d2, e0, w, vec);
      side<false>(mp, x0, pol ? hi.f[0] : hi.t[0], pol ? hi.f[1] : hi.t[1], sent, d1, d2);
      rw::put_chunk(dst + 2 * plane, j, d1, e0, w, vec);
      rw::put_chunk(dst + 3 * plane, j, d2, e0, w, vec);
    }"""

PARTS = {
    "as built": [],
    "b1_no_taps": [("soft_fused.cu",
                    "const float dh0 = b1_taps(sv, sg, j, r0, h0, p.inv_t), "
                    "dh1 = b1_taps(sv + span, sg + span, j, r1, h1, p.inv_t);",
                    "const float dh0 = (float)r0, dh1 = (float)r1;")],
    "b1_no_expf": [("soft_fused.cu", "if (z >= -kCut) acc = __fadd_rn(acc, __fmul_rn(expf(z), sg[q]));",
                    "if (z >= -kCut) acc = __fadd_rn(acc, __fmul_rn(z, sg[q]));")],
    "mm_no_vjp": [("soft_mm.cu", "vjp(raw[e], raw[kRows * kIn + e], raw[2 * kRows * kIn + e], ds_in, ds_out);",
                   "ds_in = raw[e], ds_out = raw[kRows * kIn + e];")],
    "mm_no_occ_vjp": [("soft_mm.cu", "    if (!live) {\n      dgray[i] = 0.0f;\n      return;\n    }",
                       "    if (true) {\n      dgray[i] = live ? __fadd_rn(g, __fadd_rn(de_in, de_out)) : 0.0f;\n"
                       "      return;\n    }")],
    "mm_divide": [("soft_mm.cu", "shift, t, eps, pow2_inverse(t)}};", "shift, t, eps, 0.0f}};"),
                  ("soft_mm.cu", "test_above != 0, pow2_inverse(tau)};", "test_above != 0, 0.0f};")],
    "f2_no_walk": [("soft_fused.cu", "            if (__fadd_rn(vmin, dd) >= m) break;\n",
                    "            if (true) break;\n")],
    "f2_no_taps": [("soft_fused.cu", "        float s = 0.0f, df = (float)(-reach);\n",
                    "        float s = 1.0f + (float)reach, df = (float)(-reach);\n        if (false)\n")],
    "f2_64_rows": [("soft_fused.cu", "constexpr int kF2Rows = 96;", "constexpr int kF2Rows = 64;")],
    "f2_lane_reach": [("soft_fused.cu", "        reach = __reduce_max_sync(0xffffffffu, reach);\n", "")],
    "f2_unrolled": [("soft_fused.cu", "#pragma unroll 1\n      for (int i = 0; i < nw; ++i) {",
                     "#pragma unroll\n      for (int i = 0; i < kF2Per; ++i) {\n        if (i >= nw) break;")],
    "f2_select": [("soft_fused.cu",
                   "          if (z >= -kCut) s = __fadd_rn(s, expf(z));\n        }\n        const float val",
                   "          s = __fadd_rn(s, z >= -kCut ? expf(z) : 0.0f);\n        }\n        const float val")],
    "f2_both_fields": [
        ("soft_fused.cu", F2_STAGE, F2_STAGE_BOTH),
        ("soft_fused.cu", "  float* segm = win + segs * kSeg * kLanes;  // segs x 32",
         "  float* segm = win + 2 * segs * kSeg * kLanes;"),
        ("soft_fused.cu", "    __syncthreads();  // the window is restaged for the next field\n", ""),
        ("soft_fused.cu", "size_t col_smem(int band) { return sizeof(float) *",
         "size_t col_smem(int band) { return 2 * sizeof(float) *"),
        ("soft_fused.cu", "  soft_f2_kernel<<<col_grid(p), kF2Threads, col_smem(band), (cudaStream_t)stream>>>(",
         "  cudaFuncSetAttribute(soft_f2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)col_smem(band));\n"
         "  soft_f2_kernel<<<col_grid(p), kF2Threads, col_smem(band), (cudaStream_t)stream>>>(")],
    "fwd_no_occ": [("soft_mm.cu", "occupancies_of(l, log1pf(expf(-fabsf(l))), ct1, e_in, e_out);",
                    "e_in = l, e_out = ct1;")],
    "fwd_no_tails": [("soft_mm.cu", "    tails(i, s_in, s_out);\n", "    tails.field[i] = __fadd_rn(s_in, s_out);\n")],
    "fwd_divide": [("soft_mm.cu", "tau, pow2_inverse(tau), shift / t, test_above != 0}",
                    "tau, 0.0f, shift / t, test_above != 0}")],
    "band_one_tap": [("band_conv.cu", "    if (i > 2 * k) break;\n    const float wv",
                      "    if (i > 0) break;\n    const float wv")],
    "band_no_vjp": [("band_conv.cu", "    vjp.many(g, a, b, di, dd);\n",
                     "    for (int n = 0; n < N; ++n) di[n] = g[n], dd[n] = __fadd_rn(a[n], b[n]);\n")],
    "band_vjp_no_div": [("soft_tails.cuh", "__fmul_rn(a[n] > 0.0f ? 0.5f : 0.0f, r_in[n]);",
                         "__fmul_rn(a[n] > 0.0f ? 0.5f : 0.0f, d_in[n]);"),
                        ("soft_tails.cuh", "__fmul_rn(b[n] > 0.0f ? 0.5f : 0.0f, r_out[n]);",
                         "__fmul_rn(b[n] > 0.0f ? 0.5f : 0.0f, d_out[n]);")],
    "band_vjp_div": [("soft_tails.cuh", "__fmul_rn(a[n] > 0.0f ? 0.5f : 0.0f, r_in[n]);",
                      "__fdiv_rn(a[n] > 0.0f ? 0.5f : 0.0f, d_in[n]);"),
                     ("soft_tails.cuh", "__fmul_rn(b[n] > 0.0f ? 0.5f : 0.0f, r_out[n]);",
                      "__fdiv_rn(b[n] > 0.0f ? 0.5f : 0.0f, d_out[n]);")],
    "band_slow_paths": [("soft_tails.cuh", "  if (!fast) {\n", "  if (true) {\n")],
    "band_no_sqrt": [("soft_tails.cuh", "    d[n] = sqrt_fast(x[n]);", "    d[n] = x[n];"),
                     ("soft_tails.cuh", "  if (!fast) {\n", "  if (false) {\n")],
    "band_vjp_no_exp": [("soft_tails.cuh", "    const float e = expf(div_by(__fsub_rn(d2, c), t, inv_t2));",
                         "    const float e = div_by(__fsub_rn(d2, c), t, inv_t2);")],
    "band_no_tails": [("band_conv.cu", "    tails.many(s[0], s[1], fld, a, b);\n",
                       "    for (int n = 0; n < N; ++n)\n"
                       "      fld[n] = __fadd_rn(s[0][n], s[1][n]), a[n] = s[0][n], b[n] = s[1][n];\n")],
    "band_tails_no_log": [("soft_tails.cuh", "__fsub_rn(c, __fmul_rn(t, logf(s)))", "__fsub_rn(c, __fmul_rn(t, s))")],
    "band_one_chunk_strips": [("band_conv.cu", "  return (int)((chunks + strips - 1) / strips) * kChunk;",
                               "  return kChunk;")],
    "band_blocks_1": [("band_conv.cu", "  long long strips = (long long)sms * (per_sm > 0 ? per_sm : 1) / tiles;",
                       "  long long strips = (long long)sms * 1 / tiles;")],
    "band_blocks_2": [("band_conv.cu", "  long long strips = (long long)sms * (per_sm > 0 ? per_sm : 1) / tiles;",
                       "  long long strips = (long long)sms * 2 / tiles;")],
    "band_no_prefetch": [
        ("band_conv.cu", "      if (c + 1 < chunks) stage(y0 + kChunk * (c + 1), 2 * k, kChunk, nxt);"
                         "  // in flight during the sums\n"
                         "      finish(c, cur);\n",
         "      finish(c, cur);\n      if (c + 1 < chunks) stage(y0 + kChunk * (c + 1), 2 * k, kChunk, nxt);\n")],
    "band_lb_cols6": [("band_conv.cu", "__launch_bounds__(kThreads) cols_conv_kernel",
                       "__launch_bounds__(kThreads, 6) cols_conv_kernel")],
    "band_lb_fwd4": [("band_conv.cu", "__launch_bounds__(kThreads) p2_fused_fwd_kernel",
                      "__launch_bounds__(kThreads, 4) p2_fused_fwd_kernel")],
    "band_lb_bwd3": [("band_conv.cu", "__launch_bounds__(kThreads) p2_fused_bwd_kernel",
                      "__launch_bounds__(kThreads, 3) p2_fused_bwd_kernel")],
    "band_lb_bwd4": [("band_conv.cu", "__launch_bounds__(kThreads) p2_fused_bwd_kernel",
                      "__launch_bounds__(kThreads, 4) p2_fused_bwd_kernel")],
    "band_load_ahead": [
        ("band_conv.cu", "    for (int j = 0; j < kPer - 1; ++j) v[f][j] = src[f * plane + j * kCols];",
         "    for (int j = 0; j < kPer; ++j) v[f][j] = src[f * plane + j * kCols];"),
        ("band_conv.cu", "      v[f][i + kPer - 1] = src[f * plane + (i + kPer - 1) * kCols];",
         "      if (i < 2 * k) v[f][i + kPer] = src[f * plane + (i + kPer) * kCols];")],
    "band_one_batch": [("band_conv.cu", "    for (int j = 0; j < span; j += 2 * kChunk) {\n      fetch(y0, j, raw);\n"
                                        "      fetch(y0, j + kChunk, ahead);\n      put(y0, j, raw, smem);\n"
                                        "      put(y0, j + kChunk, ahead, smem);\n    }",
                        "    for (int j = 0; j < span; j += kChunk) {\n      fetch(y0, j, raw);\n"
                        "      put(y0, j, raw, smem);\n"
                        "    }")],
    "band_128_threads": [("band_conv.cu", "constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "band_16_rows": [("band_conv.cu", "constexpr int kWarps = 8;", "constexpr int kWarps = 4;"),
                     ("band_conv.cu", "constexpr int kPer = 8;", "constexpr int kPer = 16;")],
    "band_ceiling_32": [("band_conv.cu", "constexpr int kMaxK = 128;", "constexpr int kMaxK = 32;")],
    "rows_no_scan": ROWS_NO_SCAN,
    "rows_copy": ROWS_NO_SCAN + [
        ("edt.cu", "        for (int i = 0; i < 8; ++i) f[i] = d = (d + 0x00010001u) & ~sel[i];",
         "        for (int i = 0; i < 8; ++i) f[i] = sel[i];"),
        ("edt.cu", "          d = (d + 0x00010001u) & ~sel[i];\n          f[i] = __vminu2(__vminu2(f[i], d), cc);",
         "          f[i] &= cc;"),
        ("brute.cu", "    const uint32_t p1 = a1 + 0x00010001u, p2 = a2 + 0x00010001u;\n"
                     "    a2 = (p2 & ~sel[i]) | (p1 & sel[i]);\n    a1 = p1 & ~sel[i];\n"
                     "    d1[i] = __vminu2(a1, ss);\n    d2[i] = __vminu2(a2, ss);",
         "    d1[i] = sel[i] & ss;\n    d2[i] = d1[i];")],
    "rows_scalar_walk": [
        ("edt.cu", "    if (sizeof(T) == 4 || clip > rw::kPairMax) {", "    if (true) {"),
        ("brute.cu", "// The epilogue of brute_rows (row_words.cuh's walk, K = 2)", BRUTE_SCALAR_SIDE),
        ("brute.cu", BRUTE_PAIRS_BODY, BRUTE_SCALAR_BODY)],
    "rows_no_bool_path": [("row_words.cuh", "  if (((v.x | v.y | v.z | v.w) & 0xfefefefeu) == 0) {", "  if (false) {")],
    "rows_no_prefetch": [("row_words.cuh", "  *grid = (unsigned)(need < per_sm ? need : per_sm);",
                          "  *grid = (unsigned)need;")],
    "rows_unroll_1": [("row_words.cuh", "#pragma unroll 4\n      for (int s = 0; s < nsteps; ++s) {",
                       "#pragma unroll 1\n      for (int s = 0; s < nsteps; ++s) {")],
    "rows_walk_unroll_1": [("row_words.cuh", "#pragma unroll 2\n      for (int s = nsteps - 1; s >= 0; --s) {",
                            "#pragma unroll 1\n      for (int s = nsteps - 1; s >= 0; --s) {")],
    "rows_byte_stores": [("row_words.cuh", "  if (vec && full_chunk(j, e0, w)) {\n    uint4* out",
                          "  if (false) {\n    uint4* out")],
    "rows_one_step": [("row_words.cuh", "  while (s > 1 && nrows * count(s) < kTargetWarps) s = (s + 1) / 2;",
                       "  s = 1;")],
    "rows_whole_rows": [("row_words.cuh", "kTargetWarps = 2048;", "kTargetWarps = 0;")],
    "rows_lb3": [("edt.cu", "__launch_bounds__(rw::kThreads)\nedt_rows_kernel", "__launch_bounds__(rw::kThreads, 3)\nedt_rows_kernel"),
                 ("brute.cu", "__launch_bounds__(rw::kThreads)\nbrute_rows_kernel",
                  "__launch_bounds__(rw::kThreads, 3)\nbrute_rows_kernel")],
    "rows_lb4": [("edt.cu", "__launch_bounds__(rw::kThreads)\nedt_rows_kernel", "__launch_bounds__(rw::kThreads, 4)\nedt_rows_kernel"),
                 ("brute.cu", "__launch_bounds__(rw::kThreads)\nbrute_rows_kernel",
                  "__launch_bounds__(rw::kThreads, 4)\nbrute_rows_kernel")],
}


ORIG_CSRC = _build.CSRC_DIR


def build(edits, work):
    """Load the kernels' library built from a copy of csrc with ``edits``
    applied."""
    src = os.path.join(work, "csrc")
    shutil.copytree(ORIG_CSRC, src)
    for name, old, new in edits:
        path = os.path.join(src, name)
        text = open(path).read()
        if old not in text:
            raise SystemExit(f"{name}: the text to replace is not in the sources: {old[:60]}")
        open(path, "w").write(text.replace(old, new))
    _build.CSRC_DIR, _build.BUILD_DIR, _build._lib = src, os.path.join(work, "lib"), None
    _build.load()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_parts: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    band, tau, t = cs.SPREAD + 2, cs.TRAIN_TAU, cs.TRAIN_T
    rng = np.random.default_rng(cs.SEED + 5)
    glyph = cs.glyph_image(cs.SIZE, cs.SEED + 1)
    inputs = {
        "noise": torch.from_numpy((rng.random((cs.SIZE, cs.SIZE)) * 255).astype(np.float32)).to(dev),
        "pm2000": torch.from_numpy(cs.pm_noise((cs.SIZE, cs.SIZE), cs.SEED + 6)).to(dev),
        "glyph+-2040": torch.from_numpy(glyph[..., 1].astype(np.float32) / 255 * 4080 - 2040).to(dev),
    }
    with tempfile.TemporaryDirectory() as tmp:
        build([], os.path.join(tmp, "inputs"))
        b1_in = {}
        for name, g in inputs.items():
            s1 = soft_fused.f1_pass(g, band, tau, t)
            _, d2 = soft_fused.f2_pass(s1, band, t, cs.EPS)
            b1_in[name] = (g, s1, soft_fused.b2_pass(torch.ones_like(g), d2, s1, band, t, cs.EPS))
        g0 = inputs["noise"]
        k1, k2, c = soft_mxu.range_stats(band, tau, t, cs.U8)
        args = (c, k1, k2, tau, t, 1e-6, True)
        _, d2i, d2o = cuda_soft_mm.mm_fused_fwd(g0, *args)
        ct = torch.ones_like(g0)
        s1s = {name: soft_fused.f1_pass(g, band, tau, t) for name, g in inputs.items()}
        x = cs.band_conv_inputs(dev, inputs["noise"], torch.from_numpy(glyph[..., 1].astype(np.float32)).to(dev),
                                np.random.default_rng(cs.SEED + 26))
        p2, wk2, h4 = x["p2"], x["wk2"], cs.SIZE // cs.SHARDS
        _, m_in, m_out = band_conv.p2_fused_fwd_plain(x["s_in"], x["s_out"], *p2)
        band_runs = {
            f"p2_fused_fwd k {p2[0]}": lambda: band_conv.p2_fused_fwd(x["s_in"], x["s_out"], *p2),
            f"p2_fused_bwd k {p2[0]}": lambda: band_conv.p2_fused_bwd(x["ct"], m_in, m_out, *p2),
            f"cols_conv k {wk2}": lambda: band_conv.cols_conv(x["e"], wk2, cs.WIDE_T),
            f"cols_conv k {wk2} backward": lambda: band_conv.cols_conv(x["ctw"], wk2, cs.WIDE_T, -wk2, h4 + 2 * wk2),
        }
        b = cs.threshold.hard_threshold(torch.from_numpy(glyph).to(dev))
        shard = b[: cs.SIZE // cs.SHARDS].contiguous()
        rows_runs = {
            "edt_rows u8 band 66": lambda: cuda_edt.row_distances_u8(b, band),
            "edt_rows u16 band 302": lambda: cuda_edt.row_distances_u8(b, 302),
            f"brute_rows spread {cs.SPREAD}": lambda: cuda_brute.seed_strips(b, cs.SPREAD),
            "edt_rows u8 shard": lambda: cuda_edt.row_distances_u8(shard, band),
            "brute_rows shard": lambda: cuda_brute.seed_strips(shard, cs.SPREAD),
        }
        chosen = sys.argv[1:]
        for part, edits in PARTS.items():
            if chosen and part != "as built" and not any(part.startswith(a) for a in chosen):
                continue
            build(edits, os.path.join(tmp, part.replace(" ", "_")))
            line = []
            if part == "as built" or part.startswith("b1"):
                for name, (g, s1, ds1) in b1_in.items():
                    ms = cs.cuda_ms(lambda: soft_fused.b1_pass(g, s1, ds1, band, tau, t))
                    line.append(f"soft_b1 {name} {ms:.4f}")
            if part == "as built" or part.startswith("mm"):
                ms = cs.cuda_ms(lambda: cuda_soft_mm.mm_fused_bwd(ct, d2i, d2o, g0, *args))
                line.append(f"soft_mm_bwd k {k1} {ms:.4f}")
            if part == "as built" or part.startswith("f2"):
                for name, s1 in s1s.items():
                    ms = cs.cuda_ms(lambda: soft_fused.f2_pass(s1, band, t, cs.EPS))
                    line.append(f"soft_f2 {name} {ms:.4f}")
            if part == "as built" or part.startswith("fwd"):
                for memos in (True, False):
                    ms = cs.cuda_ms(lambda: cuda_soft_mm.mm_fused_fwd(g0, *args, memos=memos))
                    line.append(f"soft_mm_fwd k {k1}{'' if memos else ' serving'} {ms:.4f}")
            if part == "as built" or part.startswith("band"):
                for name, fn in band_runs.items():
                    line.append(f"{name} {cs.graph_ms(fn):.4f}")
            if part == "as built" or part.startswith("rows"):
                for name, fn in rows_runs.items():
                    line.append(f"{name} {cs.graph_ms(fn):.4f}")
            print(f"part {part}: " + ", ".join(line) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
