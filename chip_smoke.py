"""Smoke run of the PyTorch port on one NVIDIA GPU (the Hopper H100 target).

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. the card's name and power limit; a CUDA device is required;
  2. build the kernels from chaq_sdfgen_tpu_torch/csrc with nvcc, and the
     native PNG codec (native/sdfio) with make;
  3. each hard kernel against its plain PyTorch version on the card, byte
     for byte (tolerance 0), at 4096x4096 on dense noise and on a sparse
     glyph-like image for spreads 1/64/300/1024 (pass 2's staged walk in
     uint8 and uint16, and at 1024 its per-pixel walk), on odd shapes,
     uniform masks, a batch of 3 and a 300-row int32 strip (staged);
  4. the pass-2 sqrt tail against numerics.refined_sqrt on all 2^24
     integer radicands, and the IEEE sqrt (edt_dist's below 2^24 - 1) too;
  5. the hard main path: the CLI (python -m chaq_sdfgen_tpu_torch -i in.png
     -o out.png -s 64) on a 4096x4096 gray+alpha PNG made from a seed,
     checked against the plain pipeline on the card; SDFGenerator at 256x256
     against the NumPy oracle of the reference binary; and the launch
     counters of both kernels over one SDFGenerator run of the main path,
     and of their uint16 instances over one run at spread 300;
  6. hard times with CUDA events (per call over 10 back-to-back calls, the
     median of 5 such windows, after a warm-up): each pass and
     the whole pipeline, kernels against plain versions, at 4096x4096
     spread 64 on both inputs (edt_rows, and its uint16 instance at spread
     300, also as a CUDA graph of 10 calls and the host's time a call:
     graph_ms, host_us); the path pass 2 takes on each input and at
     spread 300 on the glyph, the rows a pixel reads and the segments it
     tests (band_walk_counts, whose minima must be the per-pixel walk's);
  7. where the hard main path's device time goes: torch.profiler over 10
     runs on the glyph input, device time per kernel and the device's busy
     share of the window (profiler on);
  8. each soft kernel against its plain version on the card: the forward's
     field and both d2 memos within 1e-4 on live pixels with the same dead
     windows, the backward's dgray within 1e-4 of the scale of torch
     autograd through the plain forward (a seeded random cotangent); at
     4096x4096 on uniform noise and on the glyph image's alpha, spread 64,
     (tau, T) = (2, 1) and (1, 0.5), both threshold senses; and on 1x17,
     17x1, 129x130, 384x260 and a batch of 3;
  9. the soft main path: the CLI --soft -s 64 --soft-field f.npy on the
     4096x4096 glyph PNG (bytes within 1 and field within 1e-4 of the plain
     pipeline on the card, and its own launch log), then the training step
     (value and gradient of the summed field at tau 2, T 1, spread 64, and
     an SGD update of the pixels) for 3 steps, with both soft kernels'
     launch counters read over those steps, and the first step's value and
     gradient held against the plain version;
 10. soft times (CUDA events, as in phase 6) at 4096x4096
     spread 64: soft_mm_fwd without memos (serving) and with them
     (training), soft_mm_bwd, both also at tap radii 16, the training step
     and SDFGenerator(soft).generate, each against its plain version;
     each kernel's two convs alone as F.conv2d (cuDNN, TF32 off) on the
     (2, 4096, 4096) stack of the occupancies (soft_mm_fwd) or of the tails'
     VJP (soft_mm_bwd): their library_ms, convs only, checked against the
     plain convs within 1e-5 of the scale; and soft_mm_bwd against
     mm_fused_bwd_plain on the step's cotangent;
 11. where the training step's device time goes: torch.profiler over 10
     steps, device time per kernel and the busy share;
 12. each adaptive soft kernel (csrc/soft_fused.cu) against its plain
     version on the card, bit for bit (tolerance 0), and the four under
     autograd against torch autograd through the plain forward (dgray
     within 1e-4 of the scale plus 1e-7: autograd forms h_out's derivative
     as T - T sigmoid(-l), which cancels to about 2^-24 T where the kernels
     keep T sigmoid(l), and tiny images have tiny gradients): at 4096x4096 on the bench's noise in [0, 255), noise in
     +-2000 and the glyph image's alpha mapped to +-2040, band 66 and 112,
     (tau, T) = (2, 1) and (1, 0.5), both threshold senses; and on 1x17,
     17x1, 129x130, 384x260 and a batch of 3. On the glyph input autograd
     runs on the 1024x1024 corner (through the plain forward it keeps one
     tensor per tap, and far from the strokes every tap of the band is
     live), and dgray is held within 1e-3 of the scale: there the in-field's
     S1 and d2 reach ~T 1083, and the backward, which forms its weights from
     those memos as the TPU kernels do, inherits their rounding, ulp(S)/T
     relative (1.6e-4 of the scale at T 0.5 on a 512x512 glyph image, on
     the CPU);
 13. the undeclared-range path through its entry points at 4096x4096:
     3 training steps of soft_sdf_field without gray_range on the bench's
     noise (the gate must launch soft_mm_*) and on noise in +-2000 (it must
     launch soft_f1/f2/b2/b1), the first step's value and gradient held
     against the plain version; 3 Adam steps of SoftSDFModel on a
     (4096, 4096, 2) image in +-2000, the first held against a plain twin;
     and the CLI --soft --soft-tau 0.25 -s 64 --soft-field f.npy on the
     glyph PNG against the plain pipeline, its launch log showing F1 and F2;
 14. adaptive times (CUDA events, as in phase 6): each of the four kernels
     and its plain version, the gated training step on the bench's noise,
     the adaptive step forced on it, the out-of-gamut step and the
     SoftSDFModel step; soft_b2, soft_f1, soft_f2 and soft_b1 also on the
     glyph in +-2040, each with its taps a pixel and field on each input
     (b2_loop_taps, f1_loop_taps, f2_loop_taps: live, the kernel's loop,
     the loop of the design before it, whose reach came from a window-wide
     bound; f2_loop_taps also F2's hard-min walk steps; b1_loop_taps also
     B1's warp steps against those of the design before it);
 15. where the adaptive steps' device time goes: torch.profiler over the
     forced adaptive step and the gated out-of-gamut step;
 16. the BRUTE kernels (csrc/brute.cu: brute_rows, brute_scan_bytes) and the
     exact-distance kernels (edt_dist_core: its values on the tiles it
     finishes, its segment table and tile flags; edt_dist) against their plain versions on the
     card, tolerance 0 (bytes; float32 bits): 4096x4096 noise and glyph at
     spreads 1 and 64 (the scan's dense blocks walk |dy| <= 8 first, its
     sparse ones stage at once: both inputs take both), spreads 254 and 300
     (uint16 strips) at 1024x1024 (at 300 past the staged window: the
     per-pixel walk) and 300x1100 (uint16, staged), odd shapes, uniform and
     0/255 masks and a batch of 3; for edt_dist
     also one far seed at 2048x2048 (walks past the block's window) and the 4104x128
     two-seed image (saturation tier 16383) against NumPy brute force;
 17. the BRUTE and JFA paths through their entry points: the CLI with
     --algorithm brute and --algorithm jfa at 4096x4096 spread 64 on the
     glyph PNG against the plain pipeline on the card; SDFGenerator BRUTE
     at 256x256 against the NumPy oracle of the OpenCL binary, JFA at
     256x256 against the port on the CPU (bitwise) and the oracle of the
     OpenMP binary (JFA's rare misses allowed, as its JAX tests do); the
     launch counters over one SDFGenerator BRUTE run and one
     signed_distance_field_exact run at 4096x4096, and that field against
     its plain version;
 18. BRUTE, JFA and exact-distance times (CUDA events, as in phase 6) at
     4096x4096 spread 64 on both inputs: each kernel against its plain
     version (brute_rows also as a CUDA graph and the host's time a call)
     and the three pipelines; edt_dist on both strips of the
     signed field (each exact_dist two launches), edt_dist_core (the first)
     and edt_dist (the second, from the first's table and flags) alone, and
     on each strip the tiles' paths, the
     rows a pixel reads (from device memory too) and the segments it
     tests (dist_walk_counts, whose minima must be edt_dist's); the halo scan
     (brute_scan_bytes_halo, the same kernel) at row_off 0 on the whole
     image beside brute_scan_bytes, byte for byte equal to it, with the rows
     a pixel reads against the per-pixel walk's and the blocks that staged
     their window (scan_walk_taps);
 19. where the BRUTE pipeline's and signed_distance_field_exact's device
     time goes: torch.profiler, as in phase 7;
 20. the composed path's soft-min kernels (csrc/softmin.cu: softmin_col_fwd,
     softmin_col_bwd) against their plain versions on the card, tolerance 0
     (float32 bits): the explicit column form on the strips the composed
     path gave them before (pass 1 per field on the transposed, padded
     heights, pass 2 on both fields side by side): 4096x4096 at band 130
     on noise in [0, 255), noise in +-2000 and the glyph's alpha mapped to
     +-2040; 2048x2048 at band 258; bands 0, 1 and 113; 1x4096, 4096x1,
     139x131 and a batch of 3; then, on the same inputs, the forms the
     composed path runs now (check_forms): pass 1 along x on both fields'
     heights with implicit sentinels, written at a column offset into S1 and
     its VJP reading the halves in place, pass 2 along y with implicit
     sentinels, and pass 1 against the column form + torch.cat; the
     global-load instance on the 4096x4096 pm2000 strips and at band 1000 on
     2048x2048 (past the staged strip's shared memory); an all-1e30 strip
     (finite, above 1e29);
 21. the composed path through its entry points at 4096x4096, spread 128:
     3 training steps of soft_sdf_field without gray_range on the bench's
     noise and on noise in +-2000 (the counters must show 2 + 2 soft-mins
     per step and no other soft kernel), one 1x4096 row, 3 Adam
     steps of SoftSDFModel(spread=128) and the CLI --soft -s 128
     --gray-range -1000000000 1000000000 on the glyph PNG, each held
     against its plain twin (the same entry point with the plain versions
     in the kernels' place); the glyph's 1024x1024 corner, blurred and in
     +-2040, against the scan oracle (gradient within 1e-3 of the scale,
     phase 12's tolerance: far from the strokes the backward forms its
     weights from S ~ 1e3); and the declared wide-tap step (tau 2, T 8:
     tap radii 28, 29) on the glyph, which must launch no kernel, its
     1024x1024 corner against soft_mxu.soft_field_collapsed;
 22. composed times (CUDA events, as in phase 6): both kernels per step on
     noise in +-2000 and on the glyph in +-2040 (softmin_step_times: the
     forms the path runs, 2 launches each way, their plain versions, and
     the column form it ran before, 3 launches each way; bounds and live
     taps), the composed step on both noises and its plain twin, the
     SoftSDFModel step and the wide-tap step; then torch.profiler over the
     composed step. `python3 chip_smoke.py --composed-turn` runs phase 22's
     measurements alone (composed_turn), on this tree or its parent;
 23. the halo kernel's two launchers (csrc/halo.cu: halo_slab,
     halo_ring_shift) against their plain versions bit for bit, and the
     halo'd frames it writes in place against the ppermute form, in uint8,
     uint16, int32 and float32: 4 logical shards of a 4096-wide image at
     bands 66 and 72 (one hop, the edge fills), 8 shards of 64 rows at
     band 150 (3 hops); each timed per exchange (one launch) beside its
     plain version and its Tensor.to form (library_ms), the frames beside
     halo.exchange_row_halo with their own bytes bound; then the host-time
     split of one exchange of each and of their Tensor.to forms (wall,
     _build.launch, the ctypes launch calls, device time);
 24. the sharded EXACT and BRUTE pipelines (parallel/sharded.py) at 4096²,
     spread 64, on the glyph and the noise, over a (4,) 'y' mesh and a
     (2, 2) ('y', 'x') mesh of logical shards of the card, each under
     ppermute and rdma, and an (8, 2048, 2048) stack on ('data', 'y'),
     each byte for byte the single-device pipeline; checked, not timed:
     EXACT at spread 300 (uint16 strips), 1024² over 16 shards at spread
     100 (multi-hop, both halo forms), the int32 strips (spread 65600)
     against their plain versions; brute_scan_bytes_halo byte for byte
     against its plain version and the one-device bytes on every shard's
     frame of both inputs, at spread 64 (uint8, the staged kernel) and 300
     (uint16, past its shared memory: the per-pixel walk), each shard
     timed, their sum and the four back to back; the launch
     counters over the rdma main path (the halo kernels and the halo scan
     must launch, the halo kernel once per exchange, or hop, and device:
     halo_slab 3 times, halo_ring_shift 4), the ppermute one (no halo
     kernel) and one device (no sharded kernel); times of the 4-shard runs
     against one device;
 25. sharded JFA over both meshes at 1024² bit for bit against
     jfa_distance, and one 4096² sharded JFA time; with 2 or more cards,
     phase 24's (n,) mesh over real cards, SDFGenerator(sharding=...) and
     the CLI --shard-y n --halo-impl rdma, else one line that says the
     multi-card path was not run.
 26. the sharded soft tier's kernels against their plain versions on the
     card, bit for bit, at the shapes the tier gives them: the cols conv
     and tails pair (csrc/band_conv.cu: p2_fused_fwd, p2_fused_bwd) on
     shard 1 of a 4000x4096 image over 4 shards (1000 rows, tier 1b; tau 2,
     T 1, spread 64, k2 = 10), the cols conv (cols_conv) both ways on shard
     1 of 4096x4096 at T 8 (k2 = 29); the declared kernels on halo'd blocks
     with live windows (soft_mm_fwd/bwd, phase 8's tolerances) and F1/B1
     with a live-row window that is not (0, H); each timed beside its plain
     version (rows 17-19 also as CUDA graphs of 10 calls, graph_ms, logged
     beside ms: their host launch cost nears their device time), and cols_conv beside F.conv2d
     (cuDNN, no TF32), the one PyTorch call that computes its function,
     p2_fused_fwd/bwd beside their two convs as F.conv2d (convs only: no
     PyTorch call computes the tails or their VJP around them) (library_ms,
     each checked against the plain cols conv within 1e-5 of the scale);
 27. sharded soft steps (the summed field, its gradient and an SGD update)
     over logical shards of the card, each under ppermute and rdma, against
     the single-device step: tier 1a on the bench's u8 noise at 4096x4096
     on (4,) and (2, 2), 1b at 4000x4096 on (4,), the wide taps (T 8) on
     the glyph on (4,), the adaptive tier (window, and split forced) on
     noise in +-2000 on (4,), the composed tier at spread 128 on (4,) and
     an (8, 1024, 1024) stack on ('data', 'y'); each tier read from the
     launch counters; 1b also against the same body over a (1,) mesh of
     the card (the same rows-conv products, no shard boundary: gradient
     within 1e-6 of the scale by the knee rule); the launch counters over
     the main path (one 1b step and one wide-tap step under rdma); times
     (CUDA events, as in phase 6) of each step, each rdma step beside its
     ppermute twin; torch.profiler over the 1a and 1b steps;
 28. the entry points: SDFGenerator(soft, sharding) on the glyph byte for
     byte one device (over the cards there are, up to 4; phase 27 holds
     the tier over 4 logical shards), SoftSDFModel(mesh=...) Adam steps
     over 4 logical shards against one device (losses within 1e-6
     relative, the first step's parameter gradients within 1e-6 of their
     scale, the parameters after 3 steps within 1e-5), and the CLI
     --soft --shard-y N --halo-impl rdma (N: the cards, up to 4) on the
     glyph PNG byte for byte the unsharded SDFGenerator;
 29. the batched glyph atlas (models/atlas.py) at full width, spread 64: a
     (4, 4096, 4096, 2) stack of glyph pages (atlas_pages: the glyph image
     turned and mirrored) and the JAX bench's (8, 1024, 1024) glyphs
     (bench_glyphs), each atlas_sdf call one edt_rows and one edt_band_bytes
     launch (read from the counters), every image byte for byte per-image
     SDFGenerator.generate, both kernels on each stack's mask against their
     plain versions; times (CUDA events, as in phase 6; time_compiled's best
     of 5) against per-image generate;
 30. atlas_sdf over a (2, 2) ('data', 'y') global_mesh of logical shards of
     the card, byte for byte one device (4 launches of each kernel), and
     timed; atlas_sdf_spread_sweep over spreads 8, 64, 128 and 300 (pass 1
     at band 304, uint16 strips; pass 2 at each spread + 2): 1 edt_rows and
     4 edt_band_bytes launches, every level byte for byte per-spread
     atlas_sdf, the uint16 kernels on the stack against their plain
     versions (pass 2 also at band 66 on the band-304 strips); timed beside
     the per-spread calls and JAX's form, every level at the shared band;
 31. checkpoint.save_train_state after two Adam steps of SoftSDFModel
     (spread 64, the glyph's 1024x1024 corner), restore_train_state into a
     fresh model and optimizer, and the third step bit for bit the
     uninterrupted one (loss, parameters, Adam state); profiling.device_trace
     around one atlas call (inside kernel_timer) in this process, logged
     (after phases 3-28 torch.profiler loses a session's first kernel
     records here), and in a fresh process, whose Chrome trace must name
     edt_rows and edt_band_staged kernels (their device time logged);
 32. the multi-host tier in two processes on the card: two workers of this
     script (--dcn-worker), joined by distributed.initialize over gloo (one
     card cannot hold two NCCL ranks), each driving 2 logical shards of
     cuda:0; atlas_sdf on the glyph pages over global_mesh(y_per_host=2)
     and (y_per_host=1), each process's pages byte for byte per-image
     SDFGenerator.generate with 2 edt_rows and 2 edt_band_bytes launches;
     SoftSDFModel(mesh=global mesh, batch_axis="data") 2 Adam steps on a
     (2, 4096, 4096, 2) batch in +-2000, F1, F2, B2 and B1 launched in
     each process, against the same steps in this process over a (2, 2)
     logical mesh (losses within 1e-6 relative, the first step's
     gradients within 1e-6 of their scale, the parameters within 1e-5; the
     same parameters in both workers); times (CUDA events: the atlas call
     alone and with the other process at work, the step; the host's time
     of the step's all_reduce). Both workers must exit 0 with their OK
     line; past a timeout both are killed and the run fails.
`python3 chip_smoke.py --kernel-turn` times rows 1-11 and 14-19 and what
they serve alone (kernel_turn: edt_turn first, with the row passes, rows
1, 3 and 14, at 4096^2 on the glyph and the noise: edt_rows at bands 66,
302 and the exact field's 8190, brute_rows at spread 64, each as CUDA
events, a CUDA graph and the host's time a call, since the wrappers' host
cost nears their device time, with digests of their outputs;
band_conv_turn on phase 26's inputs, as CUDA graphs too), on this tree or
(copied in) its parent. `python3 chip_smoke.py --atlas-turn` runs phases
29-31 alone, `python3 chip_smoke.py --dcn-turn` phase 32.
The last three lines are the nvidia-smi line, the kernels' JSON summary
and {"ok": true, ...}. A kernel's bound_ms is the larger of the bytes it
must move at 3.35 TB/s and the operations its function needs on these
inputs at 67 T/s (the H100 SXM's HBM3 rate and float32 rate outside the
tensor cores, which counts an FMA as two operations; the hard kernels'
integer operations are counted at the same rate; the cols-conv kernels'
unfused _rn multiplies and adds count as an FMA's issue slot each,
band_conv_bounds); for the adaptive and the column soft-min kernels the
operations count the taps that this run's data puts inside the cut; for
the column searches
(edt_band_bytes, brute_scan_bytes, edt_dist) the count is what a
linear-time lower envelope needs, whatever the kernel's own walk does.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import socket
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from chaq_sdfgen_tpu_torch.config import SdfConfig, ShardingConfig, SoftConfig
from chaq_sdfgen_tpu_torch.models import checkpoint
from chaq_sdfgen_tpu_torch.models.atlas import atlas_sdf, atlas_sdf_spread_sweep, sweep_band
from chaq_sdfgen_tpu_torch.models.sdf_model import SDFGenerator, signed_distance_field_exact
from chaq_sdfgen_tpu_torch.models.soft_model import SoftSDFModel, create_train_state, make_train_step
from chaq_sdfgen_tpu_torch.ops import (
    _build, band_conv, brute, cuda_brute, cuda_edt, cuda_soft_mm, edt, jfa, merge, soft_fused, soft_mxu, softmin,
    softsdf, threshold,
)
from chaq_sdfgen_tpu_torch.parallel import cuda_halo, halo, sharded
from chaq_sdfgen_tpu_torch.parallel.distributed import global_mesh, initialize
from chaq_sdfgen_tpu_torch.parallel.mesh import local_index, make_mesh
from chaq_sdfgen_tpu_torch.ops.numerics import refined_sqrt, softplus
from chaq_sdfgen_tpu_torch.utils import imageio, profiling, sdfio_native

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE = 4096
SPREAD = 64
SEED = 20261016
TIMING_ITERS = 10
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SOFT_PARAMS = ((2.0, 1.0), (1.0, 0.5))  # (tau, T): the bench's training step, the CLI's default
TRAIN_TAU, TRAIN_T, TRAIN_LR = 2.0, 1.0, 1e-6
U8 = (0.0, 255.0)

KERNELS = {
    "edt_rows": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/edt.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_edt.py:169",
    },
    "edt_band_bytes": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/edt.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_edt.py:336",
    },
    "edt_rows_u16": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/edt.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_edt.py:664",
    },
    "edt_band_bytes_u16": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/edt.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_edt.py:794",
    },
    "soft_mm_fwd": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/soft_mm.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_soft_mm.py:161",
    },
    "soft_mm_bwd": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/soft_mm.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_soft_mm.py:211",
    },
    "soft_f1": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/soft_fused.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_soft_fused.py:467",
    },
    "soft_f2": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/soft_fused.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_soft_fused.py:565",
    },
    "soft_b2": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/soft_fused.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_soft_fused.py:661",
    },
    "soft_b1": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/soft_fused.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_soft_fused.py:784",
    },
    "brute_rows": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/brute.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_brute.py:144",
    },
    "brute_scan_bytes": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/brute.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_brute.py:330",
    },
    "edt_dist": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/edt.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_edt.py:1092",
    },
    "edt_dist_core": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/edt.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_edt.py:1106",
    },
    "softmin_col_fwd": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/softmin.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_soft.py:51",
    },
    "softmin_col_bwd": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/softmin.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_soft.py:181",
    },
    "brute_scan_bytes_halo": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/brute.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_brute.py:546",
    },
    "halo_slab": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/halo.cu",
        "replaces": "chaq_sdfgen_tpu/parallel/pallas_halo.py:34",
    },
    "halo_ring_shift": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/halo.cu",
        "replaces": "chaq_sdfgen_tpu/parallel/pallas_halo.py:96",
    },
    "p2_fused_fwd": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/band_conv.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_band_conv.py:68",
    },
    "p2_fused_bwd": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/band_conv.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_band_conv.py:116",
    },
    "cols_conv": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/band_conv.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_band_conv.py:48",
    },
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    require(a.shape == b.shape and a.dtype == b.dtype, f"shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


def glyph_image(size: int, seed: int) -> np.ndarray:
    """(size, size, 2) gray+alpha: a few thousand stroke segments, 2-10 px
    thick, in alpha (a sparse glyph-atlas-like mask); noise in gray."""
    rng = np.random.default_rng(seed)
    alpha = np.zeros((size, size), np.uint8)
    cell = 128
    for cy in range(0, size, cell):
        for cx in range(0, size, cell):
            if rng.random() < 0.35:
                continue  # empty atlas cells: large distances live there
            for _ in range(rng.integers(1, 4)):
                p0 = rng.uniform(16, cell - 16, 2)
                p1 = rng.uniform(16, cell - 16, 2)
                r = rng.uniform(1, 5)
                yy, xx = np.mgrid[:cell, :cell].astype(np.float32)
                d = p1 - p0
                t = np.clip(((yy - p0[0]) * d[0] + (xx - p0[1]) * d[1]) / max(d @ d, 1e-6), 0, 1)
                dist2 = (yy - p0[0] - t * d[0]) ** 2 + (xx - p0[1] - t * d[1]) ** 2
                alpha[cy : cy + cell, cx : cx + cell][dist2 <= r * r] = 255
    gray = rng.integers(0, 256, size=(size, size), dtype=np.uint8)
    return np.stack([gray, alpha], -1)


def noise_image(size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(size, size, 2), dtype=np.uint8)


def png_gray_alpha(img2ch: np.ndarray) -> bytes:
    """Minimal PNG encoder for 8-bit gray+alpha (color type 4)."""
    h, w, _ = img2ch.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img2ch.reshape(h, 2 * w)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 4, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


def cuda_ms(fn, iters: int = TIMING_ITERS, windows: int = 5) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``iters``
    back-to-back calls, so that the card's queue, not the host's launch
    overhead, sets the time; the median of ``windows`` such windows, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def profile_device(label: str, fn, runs: int = 10) -> None:
    """Device time by kernel over ``runs`` calls of ``fn`` (after a warm-up)
    and the device's busy share of the window, profiler on."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0 and e.cpu_time_total == 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    require(busy_us > 0, f"profile {label}: no device time traced")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        log(f"profile {label}: {e.self_device_time_total / runs / 1e3:.4f} ms/run "
            f"{100 * e.self_device_time_total / busy_us:.1f}% ({e.count} launches, "
            f"{e.self_device_time_total / e.count / 1e3:.4f} ms each)  {e.key[:90]}")
    log(f"profile {label}: device busy {busy_us / runs / 1e3:.4f} ms/run of a "
        f"{window_us / runs / 1e3:.4f} ms/run window ({100 * busy_us / window_us:.1f}% busy, profiler on)")


def graph_ms(fn, iters: int = TIMING_ITERS, windows: int = 5) -> float:
    """Milliseconds per call of ``fn``: a CUDA graph of ``iters``
    back-to-back calls replayed between CUDA events, the median of
    ``windows`` replays, after a warm-up call: the card's time, without
    the host's launch cost between calls."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return float(np.median(times))


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds per call of ``fn`` (its launches queued, not
    waited for)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def bound(nbytes: float, flops: float) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes at the HBM rate and
    the float operations at the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def band_bytes_flops(npix: int) -> float:
    """Float operations pass 2's function needs, whatever the algorithm:
    per pixel and field, ~15 for a linear-time lower envelope of the
    clipped column parabolas (an intersection and an evaluation), plus ~25
    for the sqrt refinement, merge and remap of the pixel."""
    return (2 * 15 + 25) * npix


def dist_flops(npix: int) -> float:
    """Float operations edt_dist's function needs, whatever the algorithm:
    per pixel, ~15 for a linear-time lower envelope of the column's
    parabolas dy^2 + d^2 (an intersection and an evaluation), plus ~25 for
    the sqrt refinement and the NO_SEED select."""
    return (15 + 25) * npix


def brute_scan_flops(npix: int) -> float:
    """Operations brute_scan_bytes's function needs, whatever the algorithm:
    per pixel and side, ~15 for a lower envelope of the column's parabolas
    dy^2 + dx1^2 and ~5 for the diagonal candidates (row y' swaps in its
    second-nearest seed for only the two pixels y' +- dx1, a scatter-min);
    plus ~35 for the tail (sqrt refinement, OpenCL sign, fallback, remap).
    At 10 B/px the bytes stay the bound unless the search needs more than
    ~80 operations per pixel and side."""
    return (2 * (15 + 5) + 35) * npix


def soft_flops(npix: int, k1: int, k2: int, forward: bool) -> float:
    """Float operations of a soft kernel: per pixel, both fields' rows and
    cols convs (a multiply and an add per tap), plus the occupancy and the
    tails (forward) or the tails' VJP and the occupancy VJP (backward),
    each transcendental counted as one operation."""
    convs = 2 * 2 * ((2 * k1 + 1) + (2 * k2 + 1))
    return npix * (convs + (22 if forward else 35))


# --------------------------------------------------------------- hard phases


def hard_phases(dev, noise, glyph):
    """Phases 3-7. Returns (errors, launches, glyph times, bounds)."""
    err = {"edt_rows": 0, "edt_band_bytes": 0, "edt_rows_u16": 0, "edt_band_bytes_u16": 0}
    inputs = {
        "noise": threshold.hard_threshold(torch.from_numpy(noise).to(dev)),
        "glyph": threshold.hard_threshold(torch.from_numpy(glyph).to(dev)),
    }
    log(f"inputs: {SIZE}x{SIZE}, TRUE share noise {float(inputs['noise'].float().mean()):.4f} "
        f"glyph {float(inputs['glyph'].float().mean()):.4f}")

    def check(name: str, b: torch.Tensor, spread: int, asymmetric: bool = False) -> None:
        band = spread + 2
        din, dout = cuda_edt.row_distances_u8(b, band)
        pin, pout = cuda_edt.row_distances_u8_plain(b, band)
        e1 = max(max_abs_err(din, pin), max_abs_err(dout, pout))
        apply_sqrt = b.shape[-2] > 1
        got = cuda_edt.fused_pass2_bytes(din, dout, spread, asymmetric, band, apply_sqrt)
        want = cuda_edt.fused_pass2_bytes_plain(pin, pout, spread, asymmetric, band, apply_sqrt)
        e2 = max_abs_err(got, want)
        torch.cuda.synchronize()
        u16 = "_u16" if din.dtype == torch.uint16 else ""
        err["edt_rows" + u16] = max(err["edt_rows" + u16], e1)
        err["edt_band_bytes" + u16] = max(err["edt_band_bytes" + u16], e2)
        log(f"check {name} {tuple(b.shape)} spread {spread}{' asym' if asymmetric else ''}: "
            f"edt_rows err {e1}, edt_band_bytes err {e2}")
        require(e1 == 0 and e2 == 0, f"kernel disagrees with its plain version on {name}")

    for name, b in inputs.items():
        for spread in (1, 64, 300, 1024):
            check(name, b, spread)
    check("glyph", inputs["glyph"], 64, asymmetric=True)
    rng = np.random.default_rng(SEED + 2)
    for shape in ((1, 17), (17, 1), (139, 131), (3, 256, 256)):
        b = torch.from_numpy(rng.random(shape) < 0.3).to(dev)
        for spread in (1, 64):
            check("random", b, spread)
    for fill in (False, True):
        for spread in (64, 1024):
            check(f"uniform-{fill}", torch.full((512, 384), fill, device=dev), spread)
    # int32 strips short enough for the staged walk (phase 24 holds a 1024-row one, past it)
    check("glyph 300 rows int32", inputs["glyph"][:300, :1100].contiguous(), 65600)
    codes = torch.from_numpy(rng.integers(0, 3, size=(139, 131), dtype=np.uint8)).to(dev)
    e = max(max_abs_err(a, p) for a, p in zip(cuda_edt.row_distances_u8(codes, 66),
                                              cuda_edt.row_distances_u8_plain(codes, 66)))
    log(f"check tri-state codes (139, 131): edt_rows err {e}")
    require(e == 0, "edt_rows disagrees on tri-state codes")

    # phase 4: the sqrt tail on every integer radicand below 2^24
    n = torch.arange(1 << 24, dtype=torch.float32, device=dev)
    bad = int((cuda_edt.refined_sqrt_cuda(n).view(torch.int32) != refined_sqrt(n).view(torch.int32)).sum())
    log(f"check refined_sqrt tail over 2^24 integers: {bad} mismatches")
    require(bad == 0, "the kernel's sqrt tail differs from numerics.refined_sqrt")
    # edt_dist takes the IEEE sqrt below 2^24 - 1 (csrc/edt.cu dist_tail): the
    # same root there (at 2^24 - 1 the refined root rounds up)
    m = n[:-1]
    bad = int((torch.sqrt(m).view(torch.int32) != refined_sqrt(m).view(torch.int32)).sum())
    log(f"check IEEE sqrt against refined_sqrt over the integers below 2^24 - 1: {bad} mismatches")
    require(bad == 0, "the IEEE sqrt differs from numerics.refined_sqrt below 2^24 - 1")
    del m
    del n

    # phase 5: the main path
    cli_out, _, _ = run_cli(glyph, ["-s", str(SPREAD)], "hard")
    want = cuda_edt.fused_sdf_bytes_plain(inputs["glyph"], SPREAD).cpu().numpy()
    require(cli_out.shape == (SIZE, SIZE), f"CLI output shape {cli_out.shape}")
    cli_err = int(np.abs(cli_out.astype(np.int32) - want.astype(np.int32)).max())
    log(f"main path hard: CLI max abs err vs plain pipeline {cli_err}")
    require(cli_err == 0, "CLI output differs from the plain pipeline")

    from sdfref import oracle

    small = glyph[:256, :256]
    gen_small = SDFGenerator(SdfConfig(spread=SPREAD), device=dev).generate(small).cpu().numpy()
    ora_err = int(np.abs(gen_small.astype(np.int32) - oracle.sdf_pipeline_openmp(small, spread=SPREAD)).max())
    log(f"main path hard: SDFGenerator 256x256 vs the reference oracle: max abs err {ora_err}")
    require(ora_err == 0, "SDFGenerator differs from the oracle of the reference binary")

    gen = SDFGenerator(SdfConfig(spread=SPREAD), device=dev)
    img_dev = torch.from_numpy(glyph).to(dev)
    torch.cuda.synchronize()
    for k in cuda_edt.LAUNCHES:
        cuda_edt.LAUNCHES[k] = 0
    out = gen.generate(img_dev)
    torch.cuda.synchronize()
    launches = {k: cuda_edt.LAUNCHES[k] for k in ("edt_rows", "edt_band_bytes")}
    log(f"main path hard: SDFGenerator {SIZE}x{SIZE} launches {dict(cuda_edt.LAUNCHES)}")
    require(out.shape == (SIZE, SIZE) and out.dtype == torch.uint8, "main path output shape/dtype")
    require(bool((out.cpu().numpy() == cli_out).all()), "SDFGenerator and CLI outputs differ")
    # the same path at spread 300, where the strips are uint16 (rows 3-4)
    gen300 = SDFGenerator(SdfConfig(spread=300), device=dev)
    torch.cuda.synchronize()
    for k in cuda_edt.LAUNCHES:
        cuda_edt.LAUNCHES[k] = 0
    out300 = gen300.generate(img_dev)
    torch.cuda.synchronize()
    launches.update({k: cuda_edt.LAUNCHES[k] for k in ("edt_rows_u16", "edt_band_bytes_u16")})
    log(f"main path hard: SDFGenerator {SIZE}x{SIZE} spread 300 launches {dict(cuda_edt.LAUNCHES)}")
    e300 = max_abs_err(out300, cuda_edt.fused_sdf_bytes_plain(inputs["glyph"], 300))
    require(e300 == 0, "SDFGenerator at spread 300 differs from the plain pipeline")
    for k, v in launches.items():
        require(v > 0, f"kernel {k} was not launched on the main path")

    # phase 6: times at 4096x4096 spread 64 (CUDA events, see cuda_ms)
    band = SPREAD + 2
    times = {}
    for name, b in inputs.items():
        img = torch.from_numpy(noise if name == "noise" else glyph).to(dev)
        din, dout = cuda_edt.row_distances_u8(b, band)
        t = {
            "edt_rows": cuda_ms(lambda: cuda_edt.row_distances_u8(b, band)),
            "edt_rows_plain": cuda_ms(lambda: cuda_edt.row_distances_u8_plain(b, band)),
            "edt_band_bytes": cuda_ms(lambda: cuda_edt.fused_pass2_bytes(din, dout, SPREAD, False, band)),
            "edt_band_bytes_plain": cuda_ms(
                lambda: cuda_edt.fused_pass2_bytes_plain(din, dout, SPREAD, False, band)),
            "pipeline": cuda_ms(lambda: gen.generate(img)),
            "pipeline_plain": cuda_ms(
                lambda: cuda_edt.fused_sdf_bytes_plain(threshold.hard_threshold(img), SPREAD)),
        }
        times[name] = t
        for k, ms in t.items():
            log(f"time {name} {k}: {ms:.4f} ms  {SIZE * SIZE / ms / 1e6:.3f} Gpix/s")
        rows_time(f"{name} edt_rows band {band}", lambda: cuda_edt.row_distances_u8(b, band))
        log_band_walk(f"{name} spread {SPREAD}", din, dout, band)

    # bounds on the main path's (glyph) input
    npix = SIZE * SIZE
    din, dout = cuda_edt.row_distances_u8(inputs["glyph"], band)
    bounds = {
        "edt_rows": bound(npix * (1 + 2 * din.element_size()), 6 * npix),
        "edt_band_bytes": bound(npix * (2 * din.element_size() + 1), band_bytes_flops(npix)),
    }
    # the u16 strips (spread 300), which the main path does not run
    b, band16 = inputs["glyph"], 302
    din, dout = cuda_edt.row_distances_u8(b, band16)
    t16 = {
        "edt_rows_u16": cuda_ms(lambda: cuda_edt.row_distances_u8(b, band16)),
        "edt_rows_u16_plain": cuda_ms(lambda: cuda_edt.row_distances_u8_plain(b, band16), 2, 3),
        "edt_band_bytes_u16": cuda_ms(lambda: cuda_edt.fused_pass2_bytes(din, dout, 300, False, band16)),
        "edt_band_bytes_u16_plain": cuda_ms(
            lambda: cuda_edt.fused_pass2_bytes_plain(din, dout, 300, False, band16), 2, 3),
    }
    b16 = {
        "edt_rows_u16": bound(npix * (1 + 2 * din.element_size()), 6 * npix),
        "edt_band_bytes_u16": bound(npix * (2 * din.element_size() + 1), band_bytes_flops(npix)),
    }
    for k, ms in t16.items():
        log(f"time glyph spread 300 {k}: {ms:.4f} ms  {SIZE * SIZE / ms / 1e6:.3f} Gpix/s")
    rows_time(f"glyph edt_rows band {band16}", lambda: cuda_edt.row_distances_u8(b, band16))
    log_band_walk("glyph spread 300", din, dout, band16)
    times["glyph"].update(t16)
    bounds.update(b16)
    for k, (ms, by) in bounds.items():
        log(f"bound hard {k}: {ms:.4f} ms ({by})")

    # phase 7: device time by kernel over the main path, and the busy share
    img = torch.from_numpy(glyph).to(dev)
    profile_device("hard", lambda: gen.generate(img))
    return err, launches, times["glyph"], bounds


def log_band_walk(label: str, din: torch.Tensor, dout: torch.Tensor, band: int) -> None:
    """The path pass 2 takes on these strips and what it reads
    (band_walk_counts)."""
    r = band_walk_counts(din, dout, band)
    path = f"staged, blocks {r['blocks']}" if r["staged"] else "the per-pixel walk (past shared memory)"
    log(f"walk of edt_band_bytes {label}: {path}; rows read a pixel (both fields) {r['rows']:.3f}, segment "
        f"tests {r['tests']:.3f}; the per-pixel walk {r['pixel_rows']:.3f} rows")


def run_cli(img2ch: np.ndarray, flags: list, label: str, soft_field: bool = False):
    """The CLI on ``img2ch`` as a PNG, in its own process: (output bytes,
    stderr lines, the --soft-field array or None). Raises if it fails."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        in_png, out_png = os.path.join(tmp, "in.png"), os.path.join(tmp, "out.png")
        field_npy = os.path.join(tmp, "field.npy")
        with open(in_png, "wb") as f:
            f.write(png_gray_alpha(img2ch))
        flags = flags + (["--soft-field", field_npy] if soft_field else [])
        cmd = [sys.executable, "-m", "chaq_sdfgen_tpu_torch", "-i", in_png, "-o", out_png,
               "--log-level", "info", *flags]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        require(res.returncode == 0, f"CLI {label} failed ({res.returncode}): {res.stderr[-2000:]}")
        for line in res.stderr.splitlines():
            log(f"  cli {label}: {line}")
        log(f"main path {label}: CLI {SIZE}x{SIZE} {' '.join(flags)} in {cli_s:.2f} s wall "
            f"(process, decode, kernels' build cache, encode)")
        out = imageio.load_gray_alpha(out_png)[..., 0]
        return out, res.stderr.splitlines(), np.load(field_npy) if soft_field else None


# --------------------------------------------------------------- soft phases


def soft_check(gray: torch.Tensor, tau: float, t: float, above: bool, ct: torch.Tensor):
    """One soft case on the card: (fwd err, bwd abs err, bwd rel err)."""
    k1, k2, c = soft_mxu.range_stats(SPREAD + 2, tau, t, U8)
    field, d2i, d2o = cuda_soft_mm.mm_fused_fwd(gray, c, k1, k2, tau, t, 1e-6, above)
    x = gray.clone().requires_grad_()
    pf, pi, po = cuda_soft_mm.mm_fused_fwd_plain(x, c, k1, k2, tau, t, 1e-6, above)
    e_fwd = 0.0
    for got, want in ((d2i, pi.detach()), (d2o, po.detach())):
        require(bool(torch.equal(got >= 1e29, want >= 1e29)), "soft_mm_fwd: dead windows differ")
        live = want < 1e29
        if bool(live.any()):
            e_fwd = max(e_fwd, float((got - want).abs()[live].max()))
    live = (pi < 1e29) & (po < 1e29)
    if bool(live.any()):
        e_fwd = max(e_fwd, float((field - pf.detach()).abs()[live].max()))
    dk = cuda_soft_mm.mm_fused_bwd(ct, d2i, d2o, gray, c, k1, k2, tau, t, 1e-6, above)
    dp, = torch.autograd.grad(pf, x, ct)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(dk).all()), "soft_mm_bwd: non-finite dgray")
    e_bwd = float((dk - dp).abs().max())
    rel = e_bwd / max(float(dp.abs().max()), 1e-30)
    return e_fwd, e_bwd, rel


def soft_phases(dev, glyph):
    """Phases 8-11. Returns (errors, launches, times, bounds)."""
    err = {"soft_mm_fwd": 0.0, "soft_mm_bwd": 0.0}
    rng = np.random.default_rng(SEED + 3)
    big = {
        "noise": torch.from_numpy((rng.random((SIZE, SIZE)) * 255).astype(np.float32)).to(dev),
        "glyph": torch.from_numpy(glyph[..., 1].astype(np.float32)).to(dev),
    }
    cases = [(f"{name} {SIZE}x{SIZE}", g) for name, g in big.items()]
    for shape in ((1, 17), (17, 1), (129, 130), (384, 260), (3, 256, 256)):
        cases.append((f"noise {shape}", torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(dev)))
    for name, g in cases:
        ct = torch.from_numpy(rng.standard_normal(tuple(g.shape)).astype(np.float32)).to(dev)
        for tau, t in SOFT_PARAMS:
            for above in (True, False):
                e_fwd, e_bwd, rel = soft_check(g, tau, t, above, ct)
                err["soft_mm_fwd"] = max(err["soft_mm_fwd"], e_fwd)
                err["soft_mm_bwd"] = max(err["soft_mm_bwd"], e_bwd)
                log(f"check soft {name} tau {tau} T {t}{'' if above else ' inverted'}: "
                    f"soft_mm_fwd err {e_fwd:.3e}, soft_mm_bwd err {e_bwd:.3e} ({rel:.3e} of scale)")
                require(e_fwd <= 1e-4, f"soft_mm_fwd disagrees with its plain version on {name}")
                require(rel < 1e-4, f"soft_mm_bwd disagrees with autograd of the plain forward on {name}")

    # phase 9: the soft main path. Serving: the CLI's --soft on the glyph PNG.
    cli_out, cli_log, cli_field = run_cli(glyph, ["--soft", "-s", str(SPREAD)], "soft", soft_field=True)
    soft_cfg = SoftConfig()
    pk1, pk2, pc = soft_mxu.range_stats(SPREAD + 2, soft_cfg.tau, soft_cfg.temperature, U8)
    plain_field = soft_mxu.soft_field_collapsed(
        big["glyph"], pk1, pk2, pc, soft_cfg.tau, soft_cfg.temperature, soft_cfg.eps)[0]
    plain_bytes = torch.clamp(merge.soft_remap(plain_field, SPREAD, False, "hard"), 0, 255)
    plain_bytes = plain_bytes.to(torch.int32).cpu().numpy()
    plain_field = plain_field.cpu().numpy()
    require(cli_out.shape == (SIZE, SIZE) and cli_field.shape == (SIZE, SIZE), "soft CLI output shapes")
    require(bool(np.isfinite(cli_field).all()), "soft CLI field is not finite")
    e_bytes = int(np.abs(cli_out.astype(np.int32) - plain_bytes).max())
    e_field = float(np.abs(cli_field - plain_field).max())
    log(f"main path soft: CLI vs plain pipeline: bytes max abs err {e_bytes} "
        f"({float((cli_out != plain_bytes).mean()):.2e} of bytes differ), field max abs err {e_field:.3e}")
    require(e_bytes <= 1 and e_field <= 1e-4, "soft CLI differs from the plain pipeline")
    cli_launches = json.loads(next(l for l in cli_log if "kernel launches" in l).split("launches ", 1)[1])
    require(cli_launches["soft_mm_fwd"] > 0, "the soft CLI did not launch soft_mm_fwd")

    # Training: the bench's value-and-gradient step with an SGD update.
    g0 = big["noise"]
    k1, k2, c = soft_mxu.range_stats(SPREAD + 2, TRAIN_TAU, TRAIN_T, U8)

    def loss_fn(g):
        return softsdf.soft_sdf_field(g, SPREAD, tau=TRAIN_TAU, temperature=TRAIN_T, gray_range=U8).sum()

    def train_step(g):
        x = g.detach().requires_grad_()
        value = loss_fn(x)
        value.backward()
        with torch.no_grad():
            return x - TRAIN_LR * x.grad, value.detach(), x.grad

    def plain_train_step(g):
        x = g.detach().requires_grad_()
        value = soft_mxu.soft_field_collapsed(x, k1, k2, c, TRAIN_TAU, TRAIN_T, 1e-6)[0].sum()
        value.backward()
        with torch.no_grad():
            return x - TRAIN_LR * x.grad, value.detach(), x.grad

    torch.cuda.synchronize()
    for k in cuda_soft_mm.LAUNCHES:
        cuda_soft_mm.LAUNCHES[k] = 0
    g, values, first = g0, [], None
    for step in range(3):
        g, value, grad = train_step(g)
        values.append(float(value))
        first = first if first is not None else grad
    torch.cuda.synchronize()
    launches = dict(cuda_soft_mm.LAUNCHES)
    log(f"main path soft: training {SIZE}x{SIZE} 3 steps, losses {values}, launches {launches}")
    for k, v in launches.items():
        require(v > 0, f"kernel {k} was not launched on the soft main path")
    require(all(math.isfinite(v) for v in values) and bool(torch.isfinite(g).all()),
            "training step is not finite")
    _, p_value, p_grad = plain_train_step(g0)
    rel_v = abs(values[0] - float(p_value)) / abs(float(p_value))
    rel_g = float((first - p_grad).abs().max()) / float(p_grad.abs().max())
    log(f"main path soft: step 1 vs plain: loss rel err {rel_v:.3e}, gradient {rel_g:.3e} of scale")
    require(rel_v < 1e-5 and rel_g < 1e-4, "training step differs from the plain version")

    # phase 10: times at 4096x4096 spread 64
    times = {}
    gen = SDFGenerator(SdfConfig(spread=SPREAD), soft=soft_cfg, device=dev)
    img = torch.from_numpy(glyph).to(dev)
    args = (c, k1, k2, TRAIN_TAU, TRAIN_T, 1e-6, True)
    _, d2i, d2o = cuda_soft_mm.mm_fused_fwd(g0, *args)
    ct = torch.ones_like(g0)  # the cotangent of a summed loss

    def plain_generate():
        gray = img[..., 1].to(torch.float32)
        f = soft_mxu.soft_field_collapsed(gray, pk1, pk2, pc, soft_cfg.tau, soft_cfg.temperature, soft_cfg.eps)[0]
        return torch.clamp(merge.soft_remap(f, SPREAD, False, "hard"), 0, 255).to(torch.int32).to(torch.uint8)

    times["soft_mm_fwd_serving"] = cuda_ms(lambda: cuda_soft_mm.mm_fused_fwd(g0, *args, memos=False))
    times["soft_mm_fwd_serving_plain"] = cuda_ms(
        lambda: cuda_soft_mm.mm_fused_fwd_plain(g0, *args, memos=False))
    times["soft_mm_fwd"] = cuda_ms(lambda: cuda_soft_mm.mm_fused_fwd(g0, *args))
    times["soft_mm_fwd_plain"] = cuda_ms(lambda: cuda_soft_mm.mm_fused_fwd_plain(g0, *args))
    times["soft_mm_bwd"] = cuda_ms(lambda: cuda_soft_mm.mm_fused_bwd(ct, d2i, d2o, g0, *args))
    times["soft_mm_bwd_plain"] = cuda_ms(lambda: cuda_soft_mm.mm_fused_bwd_plain(ct, d2i, d2o, g0, *args))
    times["training_step"] = cuda_ms(lambda: train_step(g0))
    times["training_step_plain"] = cuda_ms(lambda: plain_train_step(g0))
    times["generate"] = cuda_ms(lambda: gen.generate(img))
    times["generate_plain"] = cuda_ms(plain_generate)
    times["soft_mm_bwd_k16"] = mm_bwd_times(g0, (16,))[16]
    times["soft_mm_bwd_library"] = mm_bwd_library(ct, d2i, d2o, c, k1, k2)
    times["soft_mm_fwd_k16"] = mm_fwd_times(g0, (16,))[(16, True)]
    times["soft_mm_fwd_library"] = mm_fwd_library(g0, c, k1, k2)
    for k, ms in times.items():
        log(f"time soft {k}: {ms:.4f} ms  {SIZE * SIZE / ms / 1e6:.3f} Gpix/s")
    dk = cuda_soft_mm.mm_fused_bwd(ct, d2i, d2o, g0, *args)
    dp = cuda_soft_mm.mm_fused_bwd_plain(ct, d2i, d2o, g0, *args)
    log(f"check soft_mm_bwd against mm_fused_bwd_plain on the card (the step's cotangent): max abs err "
        f"{float((dk - dp).abs().max()) / float(dp.abs().max()):.3e} of the scale; digest {digest(dk)}")
    del dk, dp

    npix = SIZE * SIZE
    bounds = {
        "soft_mm_fwd_serving": bound(8 * npix, soft_flops(npix, k1, k2, True)),
        "soft_mm_fwd": bound(16 * npix, soft_flops(npix, k1, k2, True)),
        "soft_mm_bwd": bound(20 * npix, soft_flops(npix, k1, k2, False)),
        "soft_mm_bwd_k16": bound(20 * npix, soft_flops(npix, 16, 16, False)),
        "soft_mm_fwd_k16": bound(16 * npix, soft_flops(npix, 16, 16, True)),
    }
    for k, (ms, by) in bounds.items():
        log(f"bound soft {k}: {ms:.4f} ms ({by}); measured {times[k]:.4f} ms, "
            f"roofline share {100 * ms / times[k]:.1f}%")

    # phase 11: device time by kernel over the training step
    profile_device("soft training step", lambda: train_step(g0))
    return err, launches, times, bounds


def mm_fwd_times(g: torch.Tensor, radii=(10, 16)) -> dict:
    """soft_mm_fwd on the bench's input at tap radii k1 = k2 = k, with the
    memos (training) and without (serving) ({(k, memos): ms}, CUDA events),
    each with a digest of its outputs (turns on two trees compare them)."""
    _, _, c = soft_mxu.range_stats(SPREAD + 2, TRAIN_TAU, TRAIN_T, U8)
    out = {}
    for k in radii:
        args = (c, k, k, TRAIN_TAU, TRAIN_T, 1e-6, True)
        for memos in (True, False):
            out[(k, memos)] = cuda_ms(lambda: cuda_soft_mm.mm_fused_fwd(g, *args, memos=memos))
            res = cuda_soft_mm.mm_fused_fwd(g, *args, memos=memos)
            dig = " ".join(digest(x) for x in (res if memos else (res,)))
            log(f"time soft soft_mm_fwd k {k} {'with memos' if memos else 'serving'}: {out[(k, memos)]:.4f} ms; "
                f"digest {dig}")
    return out


def mm_fwd_library(g, c, k1, k2) -> float:
    """The library yardstick of soft_mm_fwd: its two convs alone as F.conv2d
    (cuDNN, TF32 off) on the (2, H, W) stack of the occupancies, as
    mm_bwd_library times the backward's; checked against the plain convs
    within 1e-5 of the scale. No PyTorch call computes the whole kernel (the
    occupancies and the tails around the convs), so this times the convs
    only."""
    _, e_in, e_out = soft_mxu.occupancy(g, TRAIN_TAU, TRAIN_T, c, True)
    return convs_library("soft_mm_fwd", torch.stack([e_in, e_out]).unsqueeze(1), k1, k2)


def convs_library(name, stack, k1, k2) -> float:
    """The two convs of the declared kernels as F.conv2d (cuDNN, TF32 off)
    on a (2, 1, H, W) stack, the 1 x (2 k1 + 1) taps then the (2 k2 + 1) x 1
    (symmetric, so cross-correlation is the conv), zero padding: ms, after a
    check against the plain convs within 1e-5 of the scale."""
    conv2d = torch.nn.functional.conv2d
    w1, w2 = soft_mxu.tap_weights(k1, TRAIN_T), soft_mxu.tap_weights(k2, TRAIN_T)
    t1 = torch.tensor(w1, dtype=torch.float32, device=stack.device).view(1, 1, 1, -1)
    t2 = torch.tensor(w2, dtype=torch.float32, device=stack.device).view(1, 1, -1, 1)
    convs = lambda: conv2d(conv2d(stack, t1, padding=(0, k1)), t2, padding=(k2, 0))  # noqa: E731
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = torch.stack([soft_mxu.conv_cols(soft_mxu.conv_rows(d[0], w1), w2) for d in stack])
        e_lib = float((convs().squeeze(1) - want).abs().max()) / float(want.abs().max())
        ms = cuda_ms(convs)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    log(f"check {name}'s convs against F.conv2d (cuDNN, no TF32) on the {tuple(stack.shape)} stack, "
        f"k1 {k1} k2 {k2}: max abs err {e_lib:.3e} of the scale {float(want.abs().max()):.4e}; "
        f"F.conv2d (convs only) {ms:.4f} ms")
    require(e_lib <= 1e-5, "the plain convs differ from F.conv2d")
    return ms


def mm_bwd_times(g: torch.Tensor, radii=(10, 16)) -> dict:
    """soft_mm_bwd on the bench's input at tap radii k1 = k2 = k ({k: ms},
    CUDA events; a summed loss's cotangent, the forward's memos), each with
    a digest of its output (turns on two trees compare it)."""
    _, _, c = soft_mxu.range_stats(SPREAD + 2, TRAIN_TAU, TRAIN_T, U8)
    ct = torch.ones_like(g)
    out = {}
    for k in radii:
        args = (c, k, k, TRAIN_TAU, TRAIN_T, 1e-6, True)
        _, d2i, d2o = cuda_soft_mm.mm_fused_fwd(g, *args)
        out[k] = cuda_ms(lambda: cuda_soft_mm.mm_fused_bwd(ct, d2i, d2o, g, *args))
        log(f"time soft soft_mm_bwd k {k}: {out[k]:.4f} ms; digest "
            f"{digest(cuda_soft_mm.mm_fused_bwd(ct, d2i, d2o, g, *args))}")
    return out


def mm_bwd_library(ct, d2i, d2o, c, k1, k2) -> float:
    """The library yardstick of soft_mm_bwd: its two convs alone as F.conv2d
    (cuDNN, TF32 off) on the (2, H, W) stack of the tails' VJP. No PyTorch
    call computes the whole kernel (the tails' VJP and the occupancy VJP
    around the convs), so this times the convs only."""
    ds = torch.stack(soft_mxu.tails_vjp(ct, d2i, d2o, TRAIN_T, c, 1e-6)).unsqueeze(1)
    return convs_library("soft_mm_bwd", ds, k1, k2)


# ------------------------------------------------------ adaptive soft phases

FUSED_SPREADS = (64, 110)  # band 66, the bench's, and 112, the kernels' limit
EPS = 1e-6
ADAM_LR = 5e-2


def pm_noise(shape, seed, amp=2000.0) -> np.ndarray:
    """Noise in +-amp: every height of it lies far outside the gamut."""
    return (np.random.default_rng(seed).random(shape) * 2 * amp - amp).astype(np.float32)


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    require(a.shape == b.shape, f"shapes {tuple(a.shape)} and {tuple(b.shape)}")
    return float((a - b).abs().max()) if a.numel() else 0.0


def fused_check(g, band, tau, t, above, ct, crop=None):
    """One adaptive case on the card: each kernel against its plain version
    on the same inputs ({kernel: max abs err}), and the four under autograd
    against autograd through the plain forward ((err, scale), on ``crop``
    of the image when given)."""
    args = (band, tau, t, above)
    s1p = soft_fused.f1_plain(g, *args)
    fp, d2p = soft_fused.f2_plain(s1p, band, t, EPS)
    ds1p = soft_fused.b2_plain(ct, d2p, s1p, band, t, EPS)
    field, d2 = soft_fused.f2_pass(s1p, band, t, EPS)
    errs = {
        "soft_f1": abs_err(soft_fused.f1_pass(g, *args), s1p),
        "soft_f2": max(abs_err(field, fp), abs_err(d2, d2p),
                       abs_err(soft_fused.f2_pass(s1p, band, t, EPS, memos=False), fp)),
        "soft_b2": abs_err(soft_fused.b2_pass(ct, d2p, s1p, band, t, EPS), ds1p),
        "soft_b1": abs_err(soft_fused.b1_pass(g, s1p, ds1p, *args),
                           soft_fused.b1_plain(g, s1p, ds1p, *args)),
    }
    del s1p, fp, d2p, ds1p, field, d2
    if crop is not None:
        g, ct = g[crop].contiguous(), ct[crop].contiguous()
    x = g.clone().requires_grad_()
    (soft_fused.soft_sdf_field_fused(x, band, tau, t, EPS, above) * ct).sum().backward()
    y = g.clone().requires_grad_()
    pf = soft_fused.f2_plain(soft_fused.f1_plain(y, *args), band, t, EPS, memos=False)
    want, = torch.autograd.grad(pf, y, ct)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(x.grad).all()), "adaptive backward: non-finite dgray")
    return errs, abs_err(x.grad, want), float(want.abs().max())


def softmin_taps(v: torch.Tensor, band: int, t: float, dim: int) -> int:
    """Taps inside the cut (exponent >= -27) of the soft-min of v along
    ``dim``, over all pixels: the exponentials that the function needs."""
    inv_t, n = float(np.float32(1.0 / t)), v.shape[dim]
    pad = [0, 0] * (-dim)
    pad[-1] = pad[-2] = band
    vp = torch.nn.functional.pad(v, pad, value=float("inf"))
    m = v
    for d in range(1, band + 1):
        m = torch.minimum(m, torch.minimum(vp.narrow(dim, band - d, n), vp.narrow(dim, band + d, n)) + float(d * d))
    cnt = torch.zeros((), dtype=torch.int64, device=v.device)
    for d in range(-band, band + 1):
        cnt += ((((m - vp.narrow(dim, band + d, n)) - float(d * d)) * inv_t) >= -27.0).sum()
    return int(cnt)


def weight_taps(v: torch.Tensor, target: torch.Tensor, band: int, t: float, dim: int) -> int:
    """Taps inside the cut of the weight sum of v against ``target``."""
    inv_t, n = float(np.float32(1.0 / t)), v.shape[dim]
    pad = [0, 0] * (-dim)
    pad[-1] = pad[-2] = band
    vp = torch.nn.functional.pad(v, pad, value=float("-inf"))
    cnt = torch.zeros((), dtype=torch.int64, device=v.device)
    for d in range(-band, band + 1):
        cnt += ((((vp.narrow(dim, band + d, n) - float(d * d)) - target) * inv_t) >= -27.0).sum()
    return int(cnt)


def b2_loop_taps(d2: torch.Tensor, s1: torch.Tensor, band: int, t: float) -> dict:
    """soft_b2's taps on one image's memos and S1 (2, H, W), summed over
    pixels and fields: ``live`` (inside the cut), ``loop`` (the staged
    kernel's tap loop: the whole reach where every lane of the warp has a
    reach of at most 16, else the taps of the segments it does not skip) and ``tile_loop``
    (the loop of the design before it, 2 reach + 1 with the reach from one
    max of d2 over a 32-column x (64 + 2 band)-row tile). The torch form of
    tests/test_torch_skip_bounds.py's mirror."""
    inv_t = float(np.float32(1.0 / t))
    h, w = d2.shape[-2:]
    dev, ninf = d2.device, float("-inf")
    o = torch.arange(h, device=dev)
    out = {"live": 0, "loop": 0, "tile_loop": 0}
    for f in range(2):
        v, tgt = d2[f], s1[f]
        n_seg = -(-(h + 2 * band) // 16)
        ring = torch.full((n_seg * 16, w), ninf, device=dev)
        ring[band : band + h] = v
        segmax = ring.view(n_seg, 16, w).amax(1)
        g0 = (o // 4) * 4
        bnd = torch.full((h, w), ninf, device=dev)
        for k in range((3 + 2 * band) // 16 + 2):
            j = g0 // 16 + k
            ok = (j <= (g0 + 3 + 2 * band) // 16)[:, None]
            bnd = torch.where(ok, torch.maximum(bnd, segmax[j.clamp(max=n_seg - 1)]), bnd)
        reach = torch.zeros((h, w), dtype=torch.int64, device=dev)
        for r in range(1, band + 1):
            reach += ((bnd - float(r * r)) - tgt) * inv_t >= -27.0
        seg_steps = torch.zeros_like(reach)
        vp = torch.nn.functional.pad(v, (0, 0, band, band), value=ninf)
        for d in range(-band, band + 1):
            out["live"] += int(((((vp[band + d : band + d + h] - float(d * d)) - tgt) * inv_t) >= -27.0).sum())
            j = (o + band + d) // 16
            lo = torch.maximum((j * 16 - o - band)[:, None], -reach)
            hi = torch.minimum((j * 16 + 15 - o - band)[:, None], reach)
            dm = torch.where((lo <= 0) & (hi >= 0), 0, torch.minimum(lo.abs(), hi.abs()))
            seg_live = ((segmax[j] - (dm * dm).float()) - tgt) * inv_t >= -27.0
            seg_steps += (abs(d) <= reach) & seg_live
        # a warp (a row of 32 columns) runs every tap only where all its lanes' reaches are short
        cols = -(-w // 32) * 32
        short = torch.nn.functional.pad((reach <= 16).to(torch.uint8), (0, cols - w), value=1)
        short = short.view(h, -1, 32).amin(2).repeat_interleave(32, 1)[:, :w].bool()
        out["loop"] += int(torch.where(short, 2 * reach + 1, seg_steps).sum())
        ty, tx = -(-h // 64), -(-w // 32)
        hi_tile = torch.empty((ty, tx), device=dev)
        vx = torch.nn.functional.pad(v, (0, tx * 32 - w), value=ninf)
        for i in range(ty):
            hi_tile[i] = vx[max(0, 64 * i - band) : 64 * i + 64 + band].view(-1, tx, 32).amax((0, 2))
        hi_px = hi_tile.repeat_interleave(64, 0)[:h].repeat_interleave(32, 1)[:, :w]
        old = torch.zeros_like(reach)
        for r in range(1, band + 1):
            old += ((hi_px - float(r * r)) - tgt) * inv_t >= -27.0
        out["tile_loop"] += int((2 * old + 1).sum())
    return out


def f1_loop_taps(g: torch.Tensor, band: int, tau: float, t: float) -> dict:
    """soft_f1's taps on one (H, W) gray image (W <= 4096: one row tile),
    summed over pixels and fields: ``live`` (inside the cut), ``loop`` (the
    kernel's tap loop: 2 reach + 1 where all 32 reaches of a warp are at most
    16, the reach from the least of the warp's taps; else the taps of each
    segment out to its own reach from its least height) and ``block_loop``
    (the design before it: 2 reach + 1 with the reach from the least height
    over a 256-pixel block's span). The torch form of
    tests/test_torch_scan_bounds.py's mirror."""
    inv_t = float(np.float32(1.0 / t))
    h, w = g.shape
    pad = -(-band // 32) * 32
    nch = -(-w // 32)
    nst = nch * 32 + 2 * pad
    dev = g.device

    def reach_of(gap, top):
        ok = lambda r: ((gap - (r * r).to(torch.float32)) * inv_t) >= -27.0
        r = torch.sqrt((gap.double() + 27.0 * t).clamp(0, top * top)).floor().long()
        while bool((down := (r > 0) & ~ok(r)).any()):
            r -= down.long()
        while bool((up := (r < top) & ok(r + 1)).any()):
            r += up.long()
        return r

    out = {"live": 0, "loop": 0, "block_loop": 0}
    for v in soft_fused._heights(soft_fused._logits(g, soft_fused._scalars(tau, t)[0]), t):
        st = torch.full((h, nst), float("inf"), device=dev)
        st[:, pad : pad + w] = v
        segm = st.view(h, nst // 32, 32).amin(2)
        j = pad + torch.arange(w, device=dev)
        vmin = torch.stack([st[:, pad + k - band : pad + k + 32 + band].amin(1) for k in range(0, w, 32)], 1)
        vmin = vmin.repeat_interleave(32, 1)[:, :w]
        m = v.clone()
        for d in range(1, band + 1):
            m = torch.minimum(m, torch.minimum(st[:, pad - d : pad - d + w], st[:, pad + d : pad + d + w]) + float(d * d))
        reach = reach_of(m - vmin, band)
        short = torch.nn.functional.pad((reach <= 16).to(torch.uint8), (0, nch * 32 - w), value=1)
        short = short.view(h, nch, 32).amin(2).repeat_interleave(32, 1)[:, :w].bool()
        seg_steps = torch.zeros_like(reach)
        for d in range(-band, band + 1):
            z = ((m - st[:, pad + d : pad + d + w]) - float(d * d)) * inv_t
            out["live"] += int((z >= -27.0).sum())
            rs = reach_of(m - segm[:, (j + d) // 32], band)
            seg_steps += (abs(d) <= torch.minimum(reach, rs)).long()
        out["loop"] += int(torch.where(short, 2 * reach + 1, seg_steps).sum())
        old = torch.stack([v[:, max(0, b0 - band) : b0 + 256 + band].amin(1) for b0 in range(0, w, 256)], 1)
        old = old.repeat_interleave(256, 1)[:, :w]
        out["block_loop"] += int((2 * reach_of(m - old, band) + 1).sum())
    return out


def f2_loop_taps(s1: torch.Tensor, band: int, t: float) -> dict:
    """soft_f2's taps on one image's S1 (2, H, W), summed over pixels and
    fields: ``live`` (inside the cut), ``loop`` (the kernel's sum: 2 R + 1,
    R the longest reach of the pixel's warp, 32 columns of one row, each
    lane's reach from the least S1 over its taps for the warp's 12 rows),
    ``walk`` (the hard-min walk's steps), and ``block_loop`` and
    ``block_walk`` (the design before it: from the least S1 over a 32-column
    x (64 + 2 band)-row window, a warp stepping to its longest reach). The
    torch form of tests/test_torch_f2_bounds.py's mirror."""
    inv_t = float(np.float32(1.0 / t))
    _, h, w = s1.shape
    dev, inf = s1.device, float("inf")
    nch, groups = -(-w // 32), -(-h // 12)

    def reach_of(gap):
        ok = lambda r: ((gap - (r * r).to(torch.float32)) * inv_t) >= -27.0  # noqa: E731
        r = torch.sqrt((gap.double().nan_to_num(0.0, 1e9, 0.0) + 27.0 * t).clamp(0, 1e9)).floor().long()
        r = r.clamp(max=band)
        while bool((down := (r > 0) & ~ok(r)).any()):
            r -= down.long()
        while bool((up := (r < band) & ok(r + 1)).any()):
            r += up.long()
        return r

    def per_warp(a):  # each pixel's warp's longest
        a = torch.nn.functional.pad(a, (0, nch * 32 - w))
        return a.view(h, nch, 32).amax(2).repeat_interleave(32, 1)[:, :w]

    out = {"live": 0, "loop": 0, "walk": 0, "block_loop": 0, "block_walk": 0}
    for v in s1:
        vp = torch.full((12 * groups + 2 * band + 12, w), inf, device=dev)  # row y at y + band
        vp[band : band + h] = v
        # a lane's bound: the least over rows [12 g - band, 12 g + 11 + band] of its warp's rows 12 g ..
        vmin = -torch.nn.functional.max_pool1d(-vp.t()[None], 2 * band + 12, 12)[0].t()[:groups]
        vmin = vmin.repeat_interleave(12, 0)[:h]
        vx = torch.nn.functional.pad(v, (0, nch * 32 - w), value=inf)
        lo = torch.stack([vx[max(0, y0 - band) : y0 + 64 + band].view(-1, nch, 32).amin((0, 2))
                          for y0 in range(0, h, 64)])
        lo = lo.repeat_interleave(64, 0)[:h].repeat_interleave(32, 1)[:, :w]
        m = v.clone()
        for d in range(1, band + 1):
            side = torch.minimum(vp[band - d : band - d + h], vp[band + d : band + d + h])
            m = torch.minimum(m, side + float(d * d))
        for d in range(-band, band + 1):
            z = ((m - vp[band + d : band + d + h]) - float(d * d)) * inv_t
            out["live"] += int((z >= -27.0).sum())
            if d > 0:
                out["walk"] += int((vmin + float(d * d) < m).sum())
                out["block_walk"] += int((lo + float(d * d) < m).sum())
        out["loop"] += int((2 * per_warp(reach_of(m - vmin)) + 1).sum())
        out["block_loop"] += int((2 * per_warp(reach_of(m - lo)) + 1).sum())
    return out


def b1_loop_taps(s1: torch.Tensor, h: torch.Tensor, band: int, t: float) -> dict:
    """soft_b1's taps on one image's S1 and heights (2, H, W), summed over
    pixels and fields: ``live`` (inside the cut), ``loop`` (the kernel's
    taps a pixel: 2 reach + 1 per field, the warp's reach from the greatest
    S1 over its taps against its least height, no taps where tap 0 fails),
    ``warp_steps`` (32 x the sum over warps of their steps: the lanes of a
    warp step together) and ``parent_warp_steps`` (the design before it: each
    lane's reach from the greatest S1 over its 256-pixel block's span
    against its own height, its warp stepping the longest). The torch form of
    tests/test_torch_b1_bounds.py's mirror."""
    inv_t = float(np.float32(1.0 / t))
    _, hh, w = s1.shape
    nch = -(-w // 32)
    dev = s1.device

    def reach_of(top, target):
        ok = lambda r: (((top - (r * r).to(torch.float32)) - target) * inv_t) >= -27.0
        gap = (top.double() - target.double()).nan_to_num(0.0, 1e9, 0.0)
        r = torch.sqrt((gap + 27.0 * t).clamp(0, 1e9)).floor().long().clamp(max=band)
        while bool((down := (r > 0) & ~ok(r)).any()):
            r -= down.long()
        while bool((up := (r < band) & ok(r + 1)).any()):
            r += up.long()
        return torch.where(ok(torch.zeros_like(r)), r, -1)

    def per_warp(a, fill, fn):
        a = torch.nn.functional.pad(a, (0, nch * 32 - w), value=fill)
        return fn(a.view(hh, nch, 32), 2)

    out = {"live": 0, "loop": 0, "warp_steps": 0, "parent_warp_steps": 0}
    for v, tg in zip(s1, h):
        vp = torch.nn.functional.pad(v, (band, band + 32), value=float("-inf"))
        vmax = torch.stack([vp[:, k : k + 32 + 2 * band].amax(1) for k in range(0, w, 32)], 1)
        reach = reach_of(vmax, per_warp(tg, float("inf"), torch.amin))  # (H, warps)
        steps = (2 * reach + 1).clamp(min=0)
        out["warp_steps"] += 32 * int(steps.sum())
        out["loop"] += int(steps.repeat_interleave(32, 1)[:, :w].sum())
        for d in range(-band, band + 1):
            z = ((vp[:, band + d : band + d + w] - float(d * d)) - tg) * inv_t
            out["live"] += int((z >= -27.0).sum())
        hi = torch.stack([v[:, max(0, b0 - band) : b0 + 256 + band].amax(1) for b0 in range(0, w, 256)], 1)
        parent = reach_of(hi.repeat_interleave(256, 1)[:, :w], tg).clamp(min=0)
        out["parent_warp_steps"] += 32 * int(per_warp(2 * parent + 1, 0, torch.amax).sum())
    return out


def fused_bounds(g, band, tau, t, npix):
    """The four kernels' bounds on these inputs: bytes (each input read once,
    each output written once: 12, 20, 28, 24 per pixel) and float
    operations, transcendentals counted as one: per pixel and field ~15
    for a lower envelope's hard min and ~5 per live tap of a soft-min (or
    ~6 of a weight sum), plus the heights (~10 per pixel), the tails (~8)
    and their VJPs (~8 and ~6 per pixel and field)."""
    l = threshold.soft_logits(g, tau)
    h = torch.stack([t * softplus(-l), t * softplus(l)])
    s1 = soft_fused.f1_pass(g, band, tau, t)
    _, d2 = soft_fused.f2_pass(s1, band, t, EPS)
    taps = {
        "soft_f1": softmin_taps(h, band, t, -1),
        "soft_f2": softmin_taps(s1, band, t, -2),
        "soft_b2": weight_taps(d2, s1, band, t, -2),
        "soft_b1": weight_taps(s1, h, band, t, -1),
    }
    flops = {
        "soft_f1": npix * (10 + 2 * 18) + 5 * taps["soft_f1"],
        "soft_f2": npix * (8 + 2 * 18) + 5 * taps["soft_f2"],
        "soft_b2": npix * 2 * 8 + 6 * taps["soft_b2"],
        "soft_b1": npix * (10 + 2 * 6) + 6 * taps["soft_b1"],
    }
    nbytes = {"soft_f1": 12, "soft_f2": 20, "soft_b2": 28, "soft_b1": 24}
    for k, n in taps.items():
        log(f"bound inputs {k}: {n} live taps ({n / (2 * npix):.2f} per pixel and field)")
    return {k: bound(nbytes[k] * npix, flops[k]) for k in nbytes}


def b2_times_and_taps(inputs: dict, band: int, tau: float, t: float, count: bool = True) -> None:
    """soft_b2 on each input (CUDA events; a summed loss's cotangent) and,
    with ``count``, its taps a pixel and field (b2_loop_taps): live, the
    staged loop and the tile-bound loop of the design before it."""
    for name, g in inputs.items():
        s1 = soft_fused.f1_pass(g, band, tau, t)
        _, d2 = soft_fused.f2_pass(s1, band, t, EPS)
        ones = torch.ones_like(g)
        ms = cuda_ms(lambda: soft_fused.b2_pass(ones, d2, s1, band, t, EPS))
        line = f"time adaptive {name} soft_b2: {ms:.4f} ms"
        if count:
            per = {k: v / (2 * g.numel()) for k, v in b2_loop_taps(d2, s1, band, t).items()}
            line += (f"; taps a pixel and field: live {per['live']:.3f}, staged loop {per['loop']:.3f}, "
                     f"tile-bound loop {per['tile_loop']:.3f}")
        log(line)
        del s1, d2, ones


def f1_times_and_taps(inputs: dict, band: int, tau: float, t: float, count: bool = True) -> None:
    """soft_f1 on each input (CUDA events) and, with ``count``, its taps a
    pixel and field (f1_loop_taps): live, the loop, and the loop of the
    design before it (a block-wide bound)."""
    for name, g in inputs.items():
        ms = cuda_ms(lambda: soft_fused.f1_pass(g, band, tau, t))
        line = f"time adaptive {name} soft_f1: {ms:.4f} ms"
        if count:
            per = {k: v / (2 * g.numel()) for k, v in f1_loop_taps(g, band, tau, t).items()}
            line += (f"; taps a pixel and field: live {per['live']:.3f}, loop {per['loop']:.3f}, "
                     f"block-bound loop {per['block_loop']:.3f}")
        log(line)


def f2_times_and_taps(inputs: dict, band: int, tau: float, t: float, count: bool = True) -> None:
    """soft_f2 on each input (CUDA events; S1 from F1, the memos written, as
    the training step runs it), digests of its field and memos (turns on two
    trees compare them) and, with ``count``, its taps a pixel and field
    (f2_loop_taps: live, the loop and the hard-min walk's steps, and those
    of the design before it, whose bound was block-wide)."""
    for name, g in inputs.items():
        s1 = soft_fused.f1_pass(g, band, tau, t)
        ms = cuda_ms(lambda: soft_fused.f2_pass(s1, band, t, EPS))
        field, d2 = soft_fused.f2_pass(s1, band, t, EPS)
        line = f"time adaptive {name} soft_f2: {ms:.4f} ms; digest field {digest(field)} memos {digest(d2)}"
        if count:
            per = {k: v / (2 * g.numel()) for k, v in f2_loop_taps(s1, band, t).items()}
            line += (f"; taps a pixel and field: live {per['live']:.3f}, loop {per['loop']:.3f}, walk steps "
                     f"{per['walk']:.3f}; block-bound loop {per['block_loop']:.3f}, walk {per['block_walk']:.3f}")
        log(line)
        del s1, field, d2


def b1_times_and_taps(inputs: dict, band: int, tau: float, t: float, count: bool = True) -> None:
    """soft_b1 on each input (CUDA events; S1 from F1, dS1 from B2 under a
    summed loss's cotangent), a digest of its output (turns on two trees
    compare it), and, with ``count``, its taps a pixel and field
    (b1_loop_taps: live, the loop, its warp steps and those of the design
    before it)."""
    scale = soft_fused._scalars(tau, t)[0]
    for name, g in inputs.items():
        s1 = soft_fused.f1_pass(g, band, tau, t)
        _, d2 = soft_fused.f2_pass(s1, band, t, EPS)
        ds1 = soft_fused.b2_pass(torch.ones_like(g), d2, s1, band, t, EPS)
        del d2
        ms = cuda_ms(lambda: soft_fused.b1_pass(g, s1, ds1, band, tau, t))
        line = f"time adaptive {name} soft_b1: {ms:.4f} ms; digest {digest(soft_fused.b1_pass(g, s1, ds1, band, tau, t))}"
        if count:
            hts = soft_fused._heights(soft_fused._logits(g, scale), t)
            per = {k: v / (2 * g.numel()) for k, v in b1_loop_taps(s1, hts, band, t).items()}
            line += (f"; taps a pixel and field: live {per['live']:.3f}, loop {per['loop']:.3f}, warp steps "
                     f"{per['warp_steps']:.3f}, parent's warp steps {per['parent_warp_steps']:.3f}")
        log(line)
        del s1, ds1


def digest(x: torch.Tensor) -> str:
    """The first 16 hex digits of the SHA-1 of a tensor's bytes: two trees'
    outputs on the same inputs are bit for bit equal when these are."""
    import hashlib

    return hashlib.sha1(x.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def fused_phases(dev, glyph):
    """Phases 12-15. Returns (errors, launches, times, bounds)."""
    err = {k: 0.0 for k in soft_fused.LAUNCHES}
    rng = np.random.default_rng(SEED + 5)
    big = {
        "noise": torch.from_numpy((rng.random((SIZE, SIZE)) * 255).astype(np.float32)).to(dev),
        "pm2000": torch.from_numpy(pm_noise((SIZE, SIZE), SEED + 6)).to(dev),
        "glyph+-2040": torch.from_numpy(glyph[..., 1].astype(np.float32) / 255 * 4080 - 2040).to(dev),
    }
    corner = (slice(0, 1024), slice(0, 1024))
    cases = []
    for name, g in big.items():
        for spread in FUSED_SPREADS:
            for tau, t in SOFT_PARAMS:
                for above in (True, False):
                    sparse = name.startswith("glyph")
                    cases.append((f"{name} {SIZE}x{SIZE}", g, spread + 2, tau, t, above,
                                  corner if sparse else None, 1e-3 if sparse else 1e-4))
    for shape in ((1, 17), (17, 1), (129, 130), (384, 260), (3, 256, 256)):
        for kind, band, tau, t, above in (("noise", 66, 2.0, 1.0, True), ("pm2000", 112, 1.0, 0.5, False)):
            g = rng.random(shape) * 255 if kind == "noise" else pm_noise(shape, int(rng.integers(1 << 30)))
            cases.append((f"{kind} {shape}", torch.from_numpy(g.astype(np.float32)).to(dev), band, tau, t, above,
                          None, 1e-4))
    for name, g, band, tau, t, above, crop, tol in cases:
        ct = torch.from_numpy(rng.standard_normal(tuple(g.shape)).astype(np.float32)).to(dev)
        errs, chain, scale = fused_check(g, band, tau, t, above, ct, crop)
        for k, e in errs.items():
            err[k] = max(err[k], e)
        log(f"check adaptive {name} band {band} tau {tau} T {t}{'' if above else ' inverted'}: "
            + ", ".join(f"{k} err {e:.3e}" for k, e in errs.items())
            + f"; chain vs autograd{' (1024x1024 corner)' if crop else ''} {chain:.3e} ({chain / max(scale, 1e-30):.3e} of scale {scale:.3e})")
        require(all(e == 0 for e in errs.values()), f"an adaptive kernel differs from its plain version on {name}")
        require(chain <= tol * scale + 1e-7, f"the adaptive chain disagrees with autograd of the plain forward on {name}")

    # phase 13: the undeclared path through its entry points
    band, tau, t = SPREAD + 2, TRAIN_TAU, TRAIN_T

    def step_with(field_fn):
        def step(g):
            x = g.detach().requires_grad_()
            value = field_fn(x).sum()
            value.backward()
            with torch.no_grad():
                return x - TRAIN_LR * x.grad, value.detach(), x.grad
        return step

    gated_step = step_with(lambda x: softsdf.soft_sdf_field(x, SPREAD, tau=tau, temperature=t))
    forced_step = step_with(lambda x: soft_fused.soft_sdf_field_fused(x, band, tau, t, EPS))
    plain_forced_step = step_with(
        lambda x: soft_fused.f2_plain(soft_fused.f1_plain(x, band, tau, t), band, t, EPS, memos=False))

    def plain_gated_step(g):
        shift = softsdf.runtime_gate(g, band, tau, t)
        if shift is None:
            return plain_forced_step(g)
        return step_with(lambda x: soft_mxu.soft_field_collapsed(x, 16, 16, shift, tau, t, EPS)[0])(g)

    def reset_counts():
        torch.cuda.synchronize()
        for counts in (cuda_soft_mm.LAUNCHES, soft_fused.LAUNCHES):
            for k in counts:
                counts[k] = 0

    launches = None
    for name, branch in (("noise", "mm"), ("pm2000", "fused")):
        g0 = big[name]
        reset_counts()
        g, values, first = g0, [], None
        for _ in range(3):
            g, value, grad = gated_step(g)
            values.append(float(value))
            first = first if first is not None else grad
        torch.cuda.synchronize()
        mm, fused = dict(cuda_soft_mm.LAUNCHES), dict(soft_fused.LAUNCHES)
        log(f"main path adaptive: gated training {name} {SIZE}x{SIZE} 3 steps, losses {values}, "
            f"launches {mm} {fused}")
        require(all(v == (3 if branch == "mm" else 0) for v in mm.values())
                and all(v == (3 if branch == "fused" else 0) for v in fused.values()),
                f"the gate did not take the {branch} kernels on {name}")
        require(all(math.isfinite(v) for v in values) and bool(torch.isfinite(g).all()),
                "gated training step is not finite")
        if branch == "fused":
            launches = fused
        _, p_value, p_grad = plain_gated_step(g0)
        rel_v = abs(values[0] - float(p_value)) / abs(float(p_value))
        rel_g = float((first - p_grad).abs().max()) / float(p_grad.abs().max())
        log(f"main path adaptive: {name} step 1 vs plain: loss rel err {rel_v:.3e}, gradient {rel_g:.3e} of scale")
        require(rel_v < 1e-5 and rel_g < 1e-4, f"gated training step differs from the plain version on {name}")
        del g, first, grad, p_grad

    # the trainer: SoftSDFModel on a (4096, 4096, 2) image out of gamut
    img = torch.from_numpy(np.stack([pm_noise((SIZE, SIZE), SEED + 7), pm_noise((SIZE, SIZE), SEED + 8)], -1)).to(dev)
    d_in, d_out = edt.dual_edt_banded(img[..., 1] > 127, band)
    target = merge.signed_merge(d_out, d_in)
    model = SoftSDFModel(SPREAD, SoftConfig(tau=tau, temperature=t))
    require(model.log_tau.device.type == "cuda", "SoftSDFModel did not default to the card")

    def plain_model_loss():
        mix = torch.softmax(model.channel_mix, 0)
        v = (img * mix).sum(-1) - model.threshold_bias
        v = (v - 127.5) / torch.exp(model.log_tau) * tau + 127.5
        require(softsdf.runtime_gate(v, band, tau, t) is None, "the trainer's input is in gamut")
        f = soft_fused.f2_plain(soft_fused.f1_plain(v, band, tau, t), band, t, EPS, memos=False)
        return torch.mean((f - target) ** 2)

    k_loss = torch.mean((model(img) - target) ** 2)
    k_grads = torch.autograd.grad(k_loss, list(model.parameters()))
    p_loss = plain_model_loss()
    p_grads = torch.autograd.grad(p_loss, list(model.parameters()))
    rel_v = abs(float(k_loss.detach()) - float(p_loss.detach())) / abs(float(p_loss.detach()))
    rel_g = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(k_grads, p_grads))
    log(f"main path adaptive: SoftSDFModel step 1 vs plain twin: loss rel err {rel_v:.3e}, "
        f"parameter gradients {rel_g:.3e} of their size")
    require(rel_v < 1e-5 and rel_g < 1e-3, "SoftSDFModel differs from its plain twin")
    train = make_train_step(model, create_train_state(model, img, lr=ADAM_LR))
    reset_counts()
    losses = [float(train(img, target)) for _ in range(3)]
    torch.cuda.synchronize()
    log(f"main path adaptive: SoftSDFModel {tuple(img.shape)} 3 Adam steps, losses {losses}, "
        f"launches {dict(cuda_soft_mm.LAUNCHES)} {dict(soft_fused.LAUNCHES)}")
    require(all(math.isfinite(v) for v in losses), "SoftSDFModel loss is not finite")
    require(all(v == 3 for v in soft_fused.LAUNCHES.values()) and not any(cuda_soft_mm.LAUNCHES.values()),
            "SoftSDFModel did not run the adaptive kernels")

    # the CLI: out-of-gamut tau on the glyph PNG
    cli_out, cli_log, cli_field = run_cli(glyph, ["--soft", "--soft-tau", "0.25", "-s", str(SPREAD)],
                                          "soft adaptive", soft_field=True)
    gray = torch.from_numpy(glyph[..., 1].astype(np.float32)).to(dev)
    require(softsdf.runtime_gate(gray, band, 0.25, 0.5) is None, "the CLI's input is in gamut")
    plain_field = soft_fused.f2_plain(soft_fused.f1_plain(gray, band, 0.25, 0.5), band, 0.5, EPS, memos=False)
    plain_bytes = torch.clamp(merge.soft_remap(plain_field, SPREAD, False, "hard"), 0, 255)
    plain_bytes = plain_bytes.to(torch.int32).cpu().numpy()
    plain_field = plain_field.cpu().numpy()
    require(cli_out.shape == (SIZE, SIZE) and cli_field.shape == (SIZE, SIZE), "adaptive CLI output shapes")
    require(bool(np.isfinite(cli_field).all()), "adaptive CLI field is not finite")
    e_bytes = int(np.abs(cli_out.astype(np.int32) - plain_bytes).max())
    e_field = float(np.abs(cli_field - plain_field).max())
    log(f"main path adaptive: CLI vs plain pipeline: bytes max abs err {e_bytes}, field max abs err {e_field:.3e}")
    require(e_bytes <= 1 and e_field <= 1e-4, "adaptive CLI differs from the plain pipeline")
    cli_launches = json.loads(next(l for l in cli_log if "kernel launches" in l).split("launches ", 1)[1])
    require(cli_launches["soft_f1"] > 0 and cli_launches["soft_f2"] > 0 and cli_launches["soft_mm_fwd"] == 0,
            "the adaptive CLI did not launch soft_f1 and soft_f2")
    del gray, plain_field

    # phase 14: times at 4096x4096 spread 64, tau 2, T 1
    times = {}
    for name in ("pm2000", "noise"):
        g = big[name]
        ones = torch.ones_like(g)  # the cotangent of a summed loss
        args = (band, tau, t, True)
        s1 = soft_fused.f1_pass(g, *args)
        _, d2 = soft_fused.f2_pass(s1, band, t, EPS)
        ds1 = soft_fused.b2_pass(ones, d2, s1, band, t, EPS)
        tk = {
            "soft_f1": cuda_ms(lambda: soft_fused.f1_pass(g, *args)),
            "soft_f1_plain": cuda_ms(lambda: soft_fused.f1_plain(g, *args), 2, 3),
            "soft_f2": cuda_ms(lambda: soft_fused.f2_pass(s1, band, t, EPS)),
            "soft_f2_plain": cuda_ms(lambda: soft_fused.f2_plain(s1, band, t, EPS), 2, 3),
            "soft_b2": cuda_ms(lambda: soft_fused.b2_pass(ones, d2, s1, band, t, EPS)),
            "soft_b2_plain": cuda_ms(lambda: soft_fused.b2_plain(ones, d2, s1, band, t, EPS), 2, 3),
            "soft_b1": cuda_ms(lambda: soft_fused.b1_pass(g, s1, ds1, *args)),
            "soft_b1_plain": cuda_ms(lambda: soft_fused.b1_plain(g, s1, ds1, *args), 2, 3),
            "gated_step": cuda_ms(lambda: gated_step(g)),
            "forced_step": cuda_ms(lambda: forced_step(g)),
            "forced_step_plain": cuda_ms(lambda: plain_forced_step(g), 2, 3),
        }
        for k, ms in tk.items():
            log(f"time adaptive {name} {k}: {ms:.4f} ms  {SIZE * SIZE / ms / 1e6:.3f} Gpix/s")
        if name == "pm2000":
            times = tk
        del s1, d2, ds1, ones
    ms = cuda_ms(lambda: train(img, target), 5, 3)
    log(f"time adaptive SoftSDFModel step {tuple(img.shape)}: {ms:.4f} ms  {SIZE * SIZE / ms / 1e6:.3f} Gpix/s")
    b2_times_and_taps(big, band, tau, t)
    f1_times_and_taps(big, band, tau, t)
    f2_times_and_taps(big, band, tau, t)
    b1_times_and_taps(big, band, tau, t)

    npix = SIZE * SIZE
    bounds = fused_bounds(big["pm2000"], band, tau, t, npix)
    for k, (b_ms, by) in bounds.items():
        log(f"bound adaptive {k}: {b_ms:.4f} ms ({by}); measured {times[k]:.4f} ms, "
            f"roofline share {100 * b_ms / times[k]:.1f}%")

    # phase 15: device time by kernel over the adaptive steps
    profile_device("adaptive step forced, noise", lambda: forced_step(big["noise"]))
    profile_device("gated out-of-gamut step", lambda: gated_step(big["pm2000"]))
    return err, launches, times, bounds


# ------------------------------------------------- BRUTE, JFA, exact distance


def bits_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Number of float32 values whose bits differ."""
    require(a.shape == b.shape and a.dtype == b.dtype == torch.float32, "float32 fields of one shape")
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def walk_taps(dist: torch.Tensor, reach: int) -> int:
    """Taps of the outward walks over all pixels: a pixel whose nearest
    candidate lies at distance d stops at the first |dy| >= d, reading its
    own row and two rows per step before that (at most ``reach`` steps)."""
    steps = torch.clamp(torch.ceil(dist.to(torch.float64)) - 1, 0, reach)
    return int((1 + 2 * steps).sum())


def scan_walk_taps(b: torch.Tensor, frame: torch.Tensor, spread: int, row_off: int, cap: int = 8,
                   pixel: bool = False) -> tuple:
    """(rows read, blocks staged, blocks) of the scan kernel
    (brute_scan_staged, csrc/brute.cu) over all pixels of one (H, W) mask on
    its frame (2, 4, Hs, W): a block of 32 columns x 128 rows with between
    1/8 and 7/8 of its pixels set walks |dy| <= cap per pixel and stages its
    window only if a pixel is left; any other block stages at once. Staged
    pixels go on by the frame's 16-row segments outward within the spread,
    skipping one whose least plane value m gives a^2 + m^2 >= best and ending
    a side at a^2 >= best. The torch form of tests/test_torch_scan_bounds.py's
    mirror. ``pixel``: the per-pixel walk instead (brute_scan_pixel_kernel,
    every pixel walks until dy^2 >= best)."""
    h, w = b.shape
    hs = frame.shape[-2]
    planes = frame.to(torch.int32)
    pol = b.to(torch.bool)
    n_seg = -(-hs // 16)
    least = torch.full((2, n_seg * 16, w), 1 << 30, dtype=torch.int32, device=b.device)
    least[:, :hs] = planes.amin(1)
    segm = least.view(2, n_seg, 16, w).amin(2)
    c = (torch.arange(h, device=b.device) + row_off)[:, None].expand(h, w)
    bh, bw = -(-h // 128), -(-w // 32)
    pad = (0, bw * 32 - w, 0, bh * 128 - h)
    ones = torch.nn.functional.pad(pol.to(torch.int32), pad).view(bh, 128, bw, 32).sum((1, 3))
    npix = torch.nn.functional.pad(torch.ones_like(pol, dtype=torch.int32), pad).view(bh, 128, bw, 32).sum((1, 3))
    dense = (8 * ones >= npix) & (8 * ones <= 7 * npix)
    if pixel:
        dense, cap = torch.ones_like(dense), spread
    k = torch.where(dense.repeat_interleave(128, 0).repeat_interleave(32, 1)[:h, :w], cap, 0)

    def tap(r, a):
        r = r.clamp(0, hs - 1)
        p = [torch.where(pol, planes[1, q].gather(0, r), planes[0, q].gather(0, r)) for q in range(4)]
        dl = torch.where(p[0] != a, p[0], p[1])
        dr = torch.where(p[2] != a, p[2], p[3])
        return torch.minimum(dl, dr) ** 2 + a * a

    def seg_min(s):
        s = s.clamp(0, n_seg - 1)
        return torch.where(pol, segm[1].gather(0, s), segm[0].gather(0, s))

    best = tap(c, torch.zeros_like(c))
    taps = torch.ones_like(c)
    reach = torch.minimum(torch.full_like(c, spread), torch.maximum(c, hs - 1 - c))
    open_ = torch.ones_like(pol)
    for a in range(1, cap + 2):
        open_ &= ~((a * a >= best) | (a > reach))
        walking = open_ & (a <= k)
        if not bool(walking.any()):
            break
        for r in (c - a, c + a):
            on = walking & (r >= 0) & (r < hs)
            best = torch.where(on, torch.minimum(best, tap(r, torch.full_like(c, a))), best)
            taps += on
    left = torch.nn.functional.pad(open_.to(torch.int32), pad).view(bh, 128, bw, 32).amax((1, 3)) > 0
    staged = ~dense | left
    lo, hi = (c - spread).clamp(min=0), (c + spread).clamp(max=hs - 1)
    ub, db = c - k - 1, c + k + 1
    su, sd = ub.clamp(min=0) // 16, db // 16
    up, dn = open_ & (ub >= lo), open_ & (db <= hi)
    while bool((up | dn).any()):
        for side in ("up", "dn"):
            on, s = (up, su) if side == "up" else (dn, sd)
            if side == "up":
                top, bot = torch.maximum(s * 16, lo), torch.minimum(s * 16 + 15, ub)
                a0 = c - bot
            else:
                top, bot = torch.maximum(s * 16, db), torch.minimum(s * 16 + 15, hi)
                a0 = top - c
            m = seg_min(s)
            stop = on & (a0 * a0 >= best)
            on = on & ~stop
            live = on & (a0 * a0 + m * m < best)
            for i in range(16):
                if not bool(live.any()):
                    break
                r = bot - i if side == "up" else top + i
                act = live & ((r >= top) if side == "up" else (r <= bot))
                a = (c - r).abs()
                brk = act & (a * a >= best)
                on, live, act = on & ~brk, live & ~brk, act & ~brk
                best = torch.where(act, torch.minimum(best, tap(r, a)), best)
                taps += act
            if side == "up":
                up, su = on & (s * 16 > lo), su - 1
            else:
                dn, sd = on & (s * 16 + 15 < hi), sd + 1
    return int(taps.sum()), int(staged.sum()), staged.numel()


def _blocks(mask: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """(n, blocks down, blocks across) sums (or "any") of an (n, rows, w)
    mask over blocks of 128 rows x 32 columns."""
    n, h, w = mask.shape
    bh, bw = -(-h // 128), -(-w // 32)
    padded = torch.nn.functional.pad(mask.to(torch.int32), (0, bw * 32 - w, 0, bh * 128 - h))
    out = padded.view(n, bh, 128, bw, 32).sum((2, 4))
    return out > 0 if op == "any" else out


def _spread_blocks(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return blocks.repeat_interleave(128, 1).repeat_interleave(32, 2)[:, :h, :w]


def _segment_walk(gather, seg_bound, c, best, start, walk, lo, hi, counts, staged=None):
    """The segment walk of csrc/edt.cu (band_walk, dist_walk) over all
    pixels in ``walk``: rows [lo, c - start] above and [c + start, hi] below,
    nearest first, by 16-row segments; a segment is tested (seg_bound(s, a0)
    < best) unless a0's square alone ends its side, its rows read in chunks
    of 4 while a chunk's first a^2 < best. gather(r, a): the taps at rows r;
    the square of an |a| comes from best's dtype. counts: [rows, tests, rows
    from device memory], each per pixel; staged(s): whether segment s lies
    in the block's window. Returns the minima."""
    sq = (lambda a: a.float() * a.float()) if best.dtype == torch.float32 else (lambda a: a * a)
    ub, db = c - start, c + start
    up, dn = walk & (ub >= lo), walk & (db <= hi)
    su, sd = ub.clamp(min=0) // 16, db // 16
    while bool((up | dn).any()):
        for side in ("up", "dn"):
            on, s = (up, su) if side == "up" else (dn, sd)
            if side == "up":
                top, bot = torch.maximum(s * 16, lo), torch.minimum(s * 16 + 15, ub)
                a0 = c - bot
            else:
                top, bot = torch.maximum(s * 16, db), torch.minimum(s * 16 + 15, hi)
                a0 = top - c
            on = on & (sq(a0) < best)
            counts[1] += on
            live = on & (seg_bound(s, a0) < best)
            far = ~staged(s) if staged is not None else None
            for k in range(0, 16, 4):  # chunks of 4 rows, as kChunk
                if not bool(live.any()):
                    break
                first = bot - k if side == "up" else top + k
                chunk = live & ((first >= top) if side == "up" else (first <= bot))
                brk = chunk & (sq((c - first).abs()) >= best)
                on, live, chunk = on & ~brk, live & ~brk, chunk & ~brk
                m = best
                for j in range(4):
                    r = first - j if side == "up" else first + j
                    act = chunk & ((r >= top) if side == "up" else (r <= bot))
                    m = torch.where(act, torch.minimum(m, gather(r, (c - r).abs())), m)
                    counts[0] += act
                    if far is not None:
                        counts[2] += act & far
                best = m
            if side == "up":
                up, su = on & (s * 16 > lo), su - 1
            else:
                dn, sd = on & (s * 16 + 15 < hi), sd + 1
    return best


def _dense_capped(g, best, dense, c, lim, cap, h, counts):
    """The capped walk of a dense block's pixels (|dy| = 1 .. cap while a^2 <
    best and |dy| <= lim, rows within [0, h)): (minima, done), done where
    no row past cap can lower the minimum. g(r): the taps' g at rows r."""
    sq = (lambda a: float(a) * float(a)) if best.dtype == torch.float32 else (lambda a: a * a)
    running = dense.clone()
    for a in range(1, cap + 1):
        running &= (a <= lim) & (sq(a) < best)
        for r in (c - a, c + a):
            step = running & (r >= 0) & (r < h)
            best = torch.where(step, torch.minimum(best, g(r) + sq(a)), best)
            counts[0] += step
    return best, dense & ((lim <= cap) | (sq(cap + 1) >= best))


def band_walk_counts(din: torch.Tensor, dout: torch.Tensor, band: int, row_off: int = 0, out_rows=None,
                     cap: int = 8) -> dict:
    """What edt_band_bytes (csrc/edt.cu) does on strips (h, W) or (n, h,
    W): the path its launcher takes (cuda_edt.pass2_staged), the blocks of
    32 columns x 128 rows on each of the staged kernel's paths (dense and
    done within cap, dense and staged for pixels left, staged at once), the
    rows a pixel reads over both fields (its own too) and the segments it
    tests; and the rows of the per-pixel walk (the
    parent's design) on the same strips. The minima of both walks must be
    equal (require). The torch form of tests/test_torch_edt_bounds.py's
    band_mirror."""
    din, dout = din.reshape((-1,) + din.shape[-2:]), dout.reshape((-1,) + dout.shape[-2:])
    n, h, w = din.shape
    out_rows = h - 2 * row_off if out_rows is None else out_rows
    clip = band + 1
    c = (torch.arange(out_rows, device=din.device) + row_off).view(1, -1, 1).expand(n, out_rows, w).contiguous()
    lim = torch.clamp(torch.maximum(c, h - 1 - c), max=band)
    strips = [s.to(torch.int32) for s in (din, dout)]

    def g(s, r):
        d = torch.clamp(s.gather(1, r.clamp(0, h - 1)), max=clip).float()
        return d * d

    def pixel_walk(s, counts):
        best = g(s, c)
        counts[0] += 1
        on = torch.ones_like(c, dtype=torch.bool)
        for a in range(1, min(band, h - 1) + 1):
            a2 = float(a) * float(a)
            on &= (a <= lim) & (a2 < best)
            if not bool(on.any()):
                break
            for r in (c - a, c + a):
                step = on & (r >= 0) & (r < h)
                best = torch.where(step, torch.minimum(best, g(s, r) + a2), best)
                counts[0] += step
        return best

    pix = [torch.zeros_like(c)]
    pixel_best = [pixel_walk(s, pix) for s in strips]
    out = {"pixel_rows": float(pix[0].float().mean()), "staged": cuda_edt.pass2_staged(h, band, din.element_size())}
    if not out["staged"]:
        out.update(rows=out["pixel_rows"], tests=0.0, blocks=None)
        return out
    counts = [torch.zeros_like(c), torch.zeros_like(c)]
    own = [g(s, c) for s in strips]
    counts[0] += 2
    near = torch.maximum(own[0], own[1]) <= cap * cap
    dense_b = 8 * _blocks(near) >= 7 * _blocks(torch.ones_like(near))
    dense = _spread_blocks(dense_b, out_rows, w)
    capr = min(cap, band)
    nseg = -(-h // 16)
    lo, hi = (c - band).clamp(min=0), (c + band).clamp(max=h - 1)
    start = torch.where(dense, capr + 1, 1)
    best, done = [], []
    for s, o in zip(strips, own):
        b, dn = _dense_capped(lambda r, s=s: g(s, r), o, dense, c, lim, capr, h, counts)
        best.append(b)
        done.append(dn)
    left = _blocks(dense & ~(done[0] & done[1]), "any")
    for f, s in enumerate(strips):
        key = torch.nn.functional.pad(s.abs(), (0, 0, 0, nseg * 16 - h), value=1 << 30)
        m = torch.clamp(key.view(n, nseg, 16, w).amin(2), max=clip).float()
        gmin = m * m
        best[f] = _segment_walk(lambda r, d, s=s: g(s, r) + d.float() * d.float(),
                                lambda sg, a0, gmin=gmin: gmin.gather(1, sg.clamp(0, nseg - 1)) + a0.float() * a0.float(),
                                c, best[f], start, ~done[f], lo, hi, counts)
    for a, b in zip(best, pixel_best):
        require(bool(torch.equal(a, b)), "band_walk_counts: the staged walk's minima differ from the per-pixel walk's")
    out.update(rows=float(counts[0].float().mean()), tests=float(counts[1].float().mean()),
               blocks={"dense, done within K": int((dense_b & ~left).sum()), "dense, staged": int((dense_b & left).sum()),
                       "staged at once": int((~dense_b).sum())})
    return out


def dist_walk_counts(d: torch.Tensor, sat: int, cap: int = 8, halo: int = 64) -> dict:
    """What exact_dist's kernels (csrc/edt.cu: edt_dist_core, then
    edt_dist_staged) do on one uint16 strip (h, W) or (n, h, W): the blocks
    on each path (dense and done within cap, dense and staged, staged at
    once), and per pixel the rows read (its own too), the segments tested and the rows read from device memory (beyond the
    block's window of ``halo`` rows each side); and the minima (int). The
    torch form of tests/test_torch_edt_bounds.py's dist_mirror."""
    d = d.reshape((-1,) + d.shape[-2:]).to(torch.int32).clamp(max=sat)
    n, h, w = d.shape
    y = torch.arange(h, device=d.device).view(1, -1, 1).expand(n, h, w).contiguous()
    gsq = d * d

    def g(r):
        return gsq.gather(1, r.clamp(0, h - 1))

    counts = [torch.ones_like(y), torch.zeros_like(y), torch.zeros_like(y)]
    dense_b = 8 * _blocks(d <= cap) >= 7 * _blocks(torch.ones_like(y, dtype=torch.bool))
    dense = _spread_blocks(dense_b, h, w)
    best, done = _dense_capped(g, gsq, dense, y, torch.maximum(y, h - 1 - y), cap, h, counts)
    left = _blocks(dense & ~done, "any")
    nseg = -(-h // 16)
    table = cuda_edt.dist_table_plain(d, sat).to(torch.int32)
    y0 = y // 128 * 128
    wlo, whi = (y0 - halo).clamp(min=0), (torch.clamp(y0 + 128, max=h) + halo).clamp(max=h)
    start = torch.where(dense, cap + 1, 1)

    best = _segment_walk(lambda r, dd: g(r) + dd * dd,
                         lambda s, a0: table.gather(1, s.clamp(0, nseg - 1)) ** 2 + a0 * a0,
                         y, best, start, ~done, torch.zeros_like(y), torch.full_like(y, h - 1), counts,
                         staged=lambda s: (s * 16 >= wlo) & (s * 16 < whi))
    return {"rows": float(counts[0].float().mean()), "tests": float(counts[1].float().mean()),
            "far_rows": float(counts[2].float().mean()), "best": best,
            "blocks": {"dense, done within K": int((dense_b & ~left).sum()),
                       "dense, staged": int((dense_b & left).sum()), "staged at once": int((~dense_b).sum())}}


def shard_frames(planes: torch.Tensor, spread: int, shards: int) -> list:
    """The halo'd frames of sharded BRUTE's scan (parallel/sharded.py): per
    shard of rows, its planes with ``spread`` rows of each neighbour, the
    fill spread + 1 beyond the image, the shard's rows from row ``spread``
    on. planes: (2, 4, H, W)."""
    h = planes.shape[-2] // shards
    frames = []
    for i in range(shards):
        ext = torch.full(planes.shape[:-2] + (h + 2 * spread, planes.shape[-1]), spread + 1,
                         dtype=planes.dtype, device=planes.device)
        lo, hi = max(0, i * h - spread), min(planes.shape[-2], (i + 1) * h + spread)
        ext[..., lo - (i * h - spread) : hi - (i * h - spread), :] = planes[..., lo:hi, :]
        frames.append(ext)
    return frames


def brute_dist_phases(dev, noise, glyph):
    """Phases 16-19. Returns (errors, launches, glyph times, bounds)."""
    err = {"brute_rows": 0, "brute_scan_bytes": 0, "edt_dist": 0, "edt_dist_core": 0}
    masks = {
        "noise": threshold.hard_threshold(torch.from_numpy(noise).to(dev)),
        "glyph": threshold.hard_threshold(torch.from_numpy(glyph).to(dev)),
    }

    def check_brute(name, b, spread, asymmetric=False, invert=False):
        strips = cuda_brute.seed_strips(b, spread)
        plain = cuda_brute.seed_strips_plain(b, spread)
        e1 = max_abs_err(strips, plain)
        got = cuda_brute.brute_scan_bytes(b, plain, spread, asymmetric, invert)
        want = cuda_brute.brute_scan_bytes_plain(b, plain, spread, asymmetric, invert)
        e2 = max_abs_err(got, want)
        torch.cuda.synchronize()
        err["brute_rows"] = max(err["brute_rows"], e1)
        err["brute_scan_bytes"] = max(err["brute_scan_bytes"], e2)
        log(f"check brute {name} {tuple(b.shape)} spread {spread}{' asym' if asymmetric else ''}"
            f"{' invert' if invert else ''}: brute_rows err {e1}, brute_scan_bytes err {e2}")
        require(e1 == 0 and e2 == 0, f"a BRUTE kernel disagrees with its plain version on {name}")

    def check_dist(name, b, want=None):
        sat = cuda_edt.dist_sat(max(b.shape[-2:]))
        din, dout = cuda_edt.row_distances_u8(b, sat - 1)
        e = et = 0
        for d in (din, dout):
            want_d = cuda_edt.exact_dist_plain(d, sat)
            got = cuda_edt.exact_dist(d, sat)
            e = max(e, bits_err(got, want_d))
            out, table, left = cuda_edt.dist_core(d, sat)
            done = (left == 0).repeat_interleave(128, -2).repeat_interleave(32, -1)[..., : d.shape[-2], : d.shape[-1]]
            et = max(et, max_abs_err(table.to(torch.int32), cuda_edt.dist_table_plain(d, sat).to(torch.int32)),
                     max_abs_err(left, cuda_edt.dist_left_plain(d, sat)),
                     bits_err(out[done], want_d[done]) if bool(done.any()) else 0)
        if want is not None:
            e = max(e, bits_err(cuda_edt.exact_dist(din, sat).cpu(), torch.from_numpy(want)))
        torch.cuda.synchronize()
        err["edt_dist"] = max(err["edt_dist"], e)
        err["edt_dist_core"] = max(err["edt_dist_core"], et)
        log(f"check edt_dist {name} {tuple(b.shape)} sat {sat}: {e} values differ"
            f"{' (and from NumPy brute force)' if want is not None else ''}; edt_dist_core (table, flags, the "
            f"values of the tiles done) err {et}")
        require(e == 0 and et == 0, f"edt_dist or edt_dist_core disagrees with its plain version on {name}")

    for name, b in masks.items():
        for spread in (1, SPREAD):
            check_brute(name, b, spread)
        check_dist(name, b)
    check_brute("glyph", masks["glyph"], SPREAD, asymmetric=True, invert=True)
    for name, b in masks.items():
        for spread in (254, 300):
            check_brute(f"{name} 1024 corner", b[:1024, :1024].contiguous(), spread)
        # uint16 planes short enough to stage (from 440 rows: the per-pixel walk)
        check_brute(f"{name} 300 rows", b[:300, :1100].contiguous(), 300)
    rng = np.random.default_rng(SEED + 9)
    for shape in ((1, 17), (17, 1), (139, 131), (3, 256, 256)):
        b = torch.from_numpy(rng.random(shape) < 0.3).to(dev)
        for spread in (1, SPREAD):
            check_brute("random", b, spread)
        check_dist("random", torch.from_numpy(rng.random(shape) < 0.01).to(dev))
    for fill in (False, True):
        check_brute(f"uniform-{fill}", torch.full((512, 384), fill, device=dev), SPREAD)
        check_dist(f"uniform-{fill}", torch.full((512, 384), fill, device=dev))
    b255 = (masks["glyph"][:512, :512].to(torch.uint8) * 255).contiguous()
    e = max_abs_err(cuda_brute.brute_sdf_bytes(b255, SPREAD), cuda_brute.brute_sdf_bytes_plain(b255 != 0, SPREAD))
    log(f"check brute 0/255 mask (512, 512): pipeline err {e}")
    require(e == 0, "BRUTE disagrees on a 0/255 mask")
    for shape, seeds in (((2048, 2048), [(0, 0)]), ((4104, 128), [(2, 5), (4100, 100)])):
        b = np.zeros(shape, bool)
        for y, x in seeds:
            b[y, x] = True
        ys, xs = np.nonzero(b)
        yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
        d2 = np.min([(yy - y) ** 2 + (xx - x) ** 2 for y, x in zip(ys, xs)], axis=0)
        check_dist(f"{len(seeds)} far seed(s)", torch.from_numpy(b).to(dev), np.sqrt(d2.astype(np.float32)))

    # phase 17: the BRUTE and JFA paths through their entry points
    for algorithm in ("brute", "jfa"):
        cli_out, cli_log, _ = run_cli(glyph, ["--algorithm", algorithm, "-s", str(SPREAD)], algorithm)
        require(cli_out.shape == (SIZE, SIZE), f"CLI {algorithm} output shape {cli_out.shape}")
        if algorithm == "brute":
            want = cuda_brute.brute_sdf_bytes_plain(masks["glyph"], SPREAD)
            cli_launches = json.loads(next(l for l in cli_log if "kernel launches" in l).split("launches ", 1)[1])
            require(cli_launches["brute_rows"] == 1 and cli_launches["brute_scan_bytes"] == 1,
                    "the BRUTE CLI did not launch its kernels")
        else:  # JFA has no kernel: its plain pipeline is the torch ops themselves
            want = SDFGenerator(SdfConfig(spread=SPREAD, algorithm="jfa"), device=dev).generate(
                torch.from_numpy(glyph).to(dev))
        e = int(np.abs(cli_out.astype(np.int32) - want.cpu().numpy().astype(np.int32)).max())
        log(f"main path {algorithm}: CLI max abs err vs plain pipeline {e}")
        require(e == 0, f"the {algorithm} CLI differs from the plain pipeline")

    from sdfref import oracle

    small = glyph[:256, :256]
    got = SDFGenerator(SdfConfig(spread=SPREAD, algorithm="brute"), device=dev).generate(small).cpu().numpy()
    e = int(np.abs(got.astype(np.int32) - oracle.sdf_pipeline_opencl(small, spread=SPREAD)).max())
    log(f"main path brute: SDFGenerator 256x256 vs the OpenCL oracle: max abs err {e}")
    require(e == 0, "SDFGenerator BRUTE differs from the oracle of the OpenCL binary")
    got = SDFGenerator(SdfConfig(spread=SPREAD, algorithm="jfa"), device=dev).generate(small).cpu().numpy()
    cpu = SDFGenerator(SdfConfig(spread=SPREAD, algorithm="jfa"), device="cpu").generate(small).numpy()
    exact = oracle.sdf_pipeline_openmp(small, spread=SPREAD).astype(np.int32)
    diff = np.abs(got.astype(np.int32) - exact)
    log(f"main path jfa: SDFGenerator 256x256 card vs CPU equal {bool((got == cpu).all())}; vs the OpenMP "
        f"oracle {float((diff == 0).mean()):.5f} of bytes equal, max abs err {int(diff.max())}")
    require(bool((got == cpu).all()) and (diff == 0).mean() >= 0.999 and diff.max() <= 11,
            "SDFGenerator JFA differs from the port on the CPU or strays from the exact oracle")

    img = torch.from_numpy(glyph).to(dev)
    gen = SDFGenerator(SdfConfig(spread=SPREAD, algorithm="brute"), device=dev)
    torch.cuda.synchronize()
    for k in cuda_brute.LAUNCHES:
        cuda_brute.LAUNCHES[k] = 0
    out = gen.generate(img)
    torch.cuda.synchronize()
    launches = dict(cuda_brute.LAUNCHES)
    log(f"main path brute: SDFGenerator {SIZE}x{SIZE} launches {launches}")
    require(out.shape == (SIZE, SIZE) and out.dtype == torch.uint8, "BRUTE output shape/dtype")
    b = masks["glyph"]
    for k in cuda_edt.LAUNCHES:
        cuda_edt.LAUNCHES[k] = 0
    field = signed_distance_field_exact(b)
    torch.cuda.synchronize()
    launches.update({k: cuda_edt.LAUNCHES[k] for k in ("edt_dist", "edt_dist_core")})
    log(f"main path exact distance: signed_distance_field_exact {SIZE}x{SIZE} launches {dict(cuda_edt.LAUNCHES)}")
    for k in ("brute_rows", "brute_scan_bytes", "edt_dist", "edt_dist_core"):
        require(launches[k] > 0, f"kernel {k} was not launched on its path")
    want = merge.signed_merge(*reversed(cuda_edt.exact_distance_fields_plain(b)))
    e = bits_err(field, want)
    log(f"main path exact distance: field vs plain {e} values differ; finite {bool(torch.isfinite(field).all())}, "
        f"range [{float(field.min()):.1f}, {float(field.max()):.1f}]")
    require(e == 0 and bool(torch.isfinite(field).all()), "signed_distance_field_exact differs from its plain version")

    # phase 18: times at 4096x4096 spread 64
    jfa_gen = SDFGenerator(SdfConfig(spread=SPREAD, algorithm="jfa"), device=dev)
    times = {}
    for name, b in masks.items():
        img = torch.from_numpy(noise if name == "noise" else glyph).to(dev)
        strips = cuda_brute.seed_strips(b, SPREAD)
        sat = cuda_edt.dist_sat(SIZE)
        din, dout = cuda_edt.row_distances_u8(b, sat - 1)
        core = cuda_edt.dist_core(din, sat)
        t = {
            "brute_rows": cuda_ms(lambda: cuda_brute.seed_strips(b, SPREAD)),
            "brute_rows_plain": cuda_ms(lambda: cuda_brute.seed_strips_plain(b, SPREAD), 2, 3),
            "brute_scan_bytes": cuda_ms(lambda: cuda_brute.brute_scan_bytes(b, strips, SPREAD)),
            "brute_scan_bytes_plain": cuda_ms(lambda: cuda_brute.brute_scan_bytes_plain(b, strips, SPREAD), 2, 3),
            # the halo scan on the whole image (row_off 0): the same kernel through the other wrapper
            "brute_scan_halo_row_off_0": cuda_ms(lambda: cuda_brute.brute_scan_bytes_halo(b, strips, SPREAD, 0)),
            # exact_dist's two launches alone on the "in" strip: the first, then the
            # second from the first's table and flags (it rewrites the same pixels)
            "edt_dist_core": cuda_ms(lambda: cuda_edt.dist_core(din, sat)),
            "edt_dist_core_plain": cuda_ms(lambda: cuda_edt.dist_core_plain(din, sat), 2, 3),
            "edt_dist": cuda_ms(lambda: cuda_edt.dist_walk(din, sat, *core)),
            "edt_dist_plain": cuda_ms(lambda: cuda_edt.exact_dist_plain(din, sat), 2, 3),
            # exact_dist (both launches) on the "in" strip, on the "out" strip, and the two together
            "exact_dist": cuda_ms(lambda: cuda_edt.exact_dist(din, sat)),
            "edt_dist_out": cuda_ms(lambda: cuda_edt.exact_dist(dout, sat)),
            "edt_dist_both": cuda_ms(lambda: (cuda_edt.exact_dist(din, sat), cuda_edt.exact_dist(dout, sat))),
            "brute_pipeline": cuda_ms(lambda: gen.generate(img)),
            "brute_pipeline_plain": cuda_ms(
                lambda: cuda_brute.brute_sdf_bytes_plain(threshold.hard_threshold(img), SPREAD), 2, 3),
            "jfa_pipeline": cuda_ms(lambda: jfa_gen.generate(img), 2, 3),
            "exact_field": cuda_ms(lambda: signed_distance_field_exact(b)),
            "exact_field_plain": cuda_ms(
                lambda: merge.signed_merge(*reversed(cuda_edt.exact_distance_fields_plain(b))), 2, 3),
        }
        times[name] = t
        for k, ms in t.items():
            log(f"time {name} {k}: {ms:.4f} ms  {SIZE * SIZE / ms / 1e6:.3f} Gpix/s")
        rows_time(f"{name} brute_rows spread {SPREAD}", lambda: cuda_brute.seed_strips(b, SPREAD))
        e = max_abs_err(cuda_brute.brute_scan_bytes_halo(b, strips, SPREAD, 0),
                        cuda_brute.brute_scan_bytes(b, strips, SPREAD))
        old_taps = scan_walk_taps(b, strips, SPREAD, 0, pixel=True)[0]
        new_taps, staged, blocks = scan_walk_taps(b, strips, SPREAD, 0)
        log(f"check brute_scan_bytes_halo row_off 0 {name}: {e} bytes differ from brute_scan_bytes; rows read a "
            f"pixel: the scan {new_taps / b.numel():.3f}, per-pixel walk {old_taps / b.numel():.3f}; blocks "
            f"staged {staged} of {blocks}")
        require(e == 0, f"the halo scan at row_off 0 differs from brute_scan_bytes on {name}")
        for strip, d in (("in", din), ("out", dout)):
            r = dist_walk_counts(d, sat)
            want = torch.where(r["best"] >= sat * sat, cuda_edt.NO_SEED, refined_sqrt(r["best"].float()))
            require(bits_err(cuda_edt.exact_dist(d, sat), want.reshape(d.shape)) == 0,
                    "dist_walk_counts' minima differ from edt_dist")
            log(f"walk of edt_dist {name} '{strip}' strip: blocks {r['blocks']}; rows read a pixel {r['rows']:.3f} "
                f"({r['far_rows']:.3f} from device memory), segment tests {r['tests']:.3f}; the per-pixel walk "
                f"{walk_taps(cuda_edt.exact_dist(d, sat), SIZE - 1) / d.numel():.3f} rows")

    # bounds on the glyph input; the walks' taps are logged, not counted in the bounds
    npix = SIZE * SIZE
    b = masks["glyph"]
    strips = cuda_brute.seed_strips(b, SPREAD)
    sat = cuda_edt.dist_sat(SIZE)
    din, _ = cuda_edt.row_distances_u8(b, sat - 1)
    left = cuda_edt.dist_core(din, sat)[2]
    left_px = int((left != 0).repeat_interleave(128, 0).repeat_interleave(32, 1)[:SIZE, :SIZE].sum())
    table_bytes = -(-SIZE // cuda_edt.SEG) * SIZE * 2
    n = scan_walk_taps(b, strips, SPREAD, 0)[0]
    log(f"walk of brute_scan_bytes: {n} rows read ({n / npix:.2f} per pixel)")
    bounds = {
        # 1 B/px in, 8 strips out; ~4 operations per pixel and scan direction and polarity
        "brute_rows": bound(npix * (1 + 8 * strips.element_size()), 16 * npix),
        # mask and 8 strips in, bytes out
        "brute_scan_bytes": bound(npix * (1 + 8 * strips.element_size() + 1), brute_scan_flops(npix)),
        # the first launch: the uint16 strip in; the table, the flags and the
        # float32 values of the tiles it finishes out; a min per value and the
        # field's operations on those pixels
        "edt_dist_core": bound(npix * 2 + table_bytes + left.numel() + 4 * (npix - left_px),
                               npix + dist_flops(npix - left_px)),
        # the second: the strip, the table and the flags in, the float32
        # values of the tiles left out
        "edt_dist": bound(npix * 2 + table_bytes + left.numel() + 4 * left_px, dist_flops(left_px)),
    }
    for k, (ms, by) in bounds.items():
        log(f"bound {k}: {ms:.4f} ms ({by}); measured {times['glyph'][k]:.4f} ms, "
            f"roofline share {100 * ms / times['glyph'][k]:.1f}%")

    # phase 19: device time by kernel over the BRUTE pipeline and the exact field
    img = torch.from_numpy(glyph).to(dev)
    profile_device("brute", lambda: gen.generate(img))
    profile_device("signed_distance_field_exact", lambda: signed_distance_field_exact(b))
    return err, launches, times["glyph"], bounds


# ------------------------------------------------------ composed soft phases

COMPOSED_SPREAD = 128  # band 130: past the adaptive kernels' 112
WIDE_T = 8.0  # tau 2, T 8 on (0, 255): tap radii 28 and 29


@contextlib.contextmanager
def plain_softmin():
    """The column soft-min's plain versions in the kernels' place, for the
    plain twin of a path through its entry points (ops/softmin.py's
    autograd function looks its two wrappers up at each call)."""
    fwd, bwd = softmin.softmin_col_fwd, softmin.softmin_col_bwd
    softmin.softmin_col_fwd, softmin.softmin_col_bwd = softmin.softmin_col_fwd_plain, softmin.softmin_col_bwd_plain
    try:
        yield
    finally:
        softmin.softmin_col_fwd, softmin.softmin_col_bwd = fwd, bwd


def composed_strips(gray: torch.Tensor, band: int, tau: float, t: float) -> list:
    """The three (label, gext) strips that the composed path gives the
    column soft-min on ``gray`` (ops/softsdf.soft_field_cols): pass 1 per
    field on the transposed heights, pass 2 on both fields side by side,
    its input from the plain forward."""
    big = edt.big_sentinel(band)
    logits_t = threshold.soft_logits(gray.transpose(-1, -2).contiguous(), tau)
    strips, s1 = [], []
    for on in (True, False):
        gext = torch.nn.functional.pad(threshold.soft_log_indicator_from_logits(logits_t, t, on, big),
                                       (0, 0, band, band), value=1e30)
        strips.append((f"pass 1 {'in' if on else 'out'}", gext))
        s1.append(softmin.softmin_col_fwd_plain(gext, band, t).transpose(-1, -2))
    strips.append(("pass 2", torch.nn.functional.pad(torch.cat(s1, -1), (0, 0, band, band), value=1e30)))
    return strips


def col_taps(gext: torch.Tensor, s: torch.Tensor, band: int, t: float) -> tuple:
    """Taps inside the cut (exponent >= -27) over all pixels: of the
    forward's soft-min on gext and of the backward's weight sums against S."""
    inv_t, h, hext = float(np.float32(1.0 / t)), s.shape[-2], gext.shape[-2]
    m = gext.narrow(-2, band, h)
    for d in range(1, band + 1):
        m = torch.minimum(m, torch.minimum(gext.narrow(-2, band - d, h), gext.narrow(-2, band + d, h)) + float(d * d))
    sp = torch.nn.functional.pad(s, (0, 0, 2 * band, 2 * band), value=float("-inf"))
    fwd = torch.zeros((), dtype=torch.int64, device=s.device)
    bwd = torch.zeros((), dtype=torch.int64, device=s.device)
    for d in range(-band, band + 1):
        fwd += ((((m - gext.narrow(-2, band + d, h)) - float(d * d)) * inv_t) >= -27.0).sum()
        bwd += ((((sp.narrow(-2, band - d, hext) - float(d * d)) - gext) * inv_t) >= -27.0).sum()
    return int(fwd), int(bwd)


def composed_heights(gray: torch.Tensor, band: int, tau: float, t: float) -> tuple:
    """Both fields' heights of ``gray`` as the composed path forms them
    (ops/softsdf.cols_pass1), untransposed."""
    big = edt.big_sentinel(band)
    logits = threshold.soft_logits(gray, tau)
    return tuple(threshold.soft_log_indicator_from_logits(logits, t, on, big) for on in (True, False))


def check_forms(label, gray, band, tau, t, gen, impl="auto") -> dict:
    """The forms the composed path runs, each kernel against its plain
    version on the card, bit for bit: pass 1 along x on both fields'
    heights with implicit sentinels, written at a column offset into S1 (a
    pitch wider than 2W) and its VJP reading the halves in place; pass 2
    along y with implicit sentinels on S1. Pass 1 is also held against the
    explicit column form on the transposed, padded heights and torch.cat
    (composed_strips), bit for bit. Returns each kernel's max abs error."""
    fields = composed_heights(gray, band, tau, t)
    rows, w = gray.shape[-2:]
    shape = tuple(gray.shape[:-2]) + (rows, 2 * w + 3)
    out, outp = torch.zeros(shape, device=gray.device), torch.zeros(shape, device=gray.device)
    x1 = dict(axis=-1, implicit=True)
    softmin.softmin_col_fwd(fields, band, t, out=out, out_col=1, impl=impl, **x1)
    softmin.softmin_col_fwd_plain(fields, band, t, out=outp, out_col=1, **x1)
    ct = torch.randn(shape, generator=gen, device=gray.device)
    dg = softmin.softmin_col_bwd(fields, outp, ct, band, t, s_col=1, impl=impl, **x1)
    dgp = softmin.softmin_col_bwd_plain(fields, outp, ct, band, t, s_col=1, **x1)
    s1 = outp[..., 1:1 + 2 * w].contiguous()
    s2 = softmin.softmin_col_fwd(s1, band, t, implicit=True, impl=impl)
    s2p = softmin.softmin_col_fwd_plain(s1, band, t, implicit=True)
    ct2 = torch.randn(s2p.shape, generator=gen, device=gray.device)
    dg2 = softmin.softmin_col_bwd(s1, s2p, ct2, band, t, implicit=True, impl=impl)
    dg2p = softmin.softmin_col_bwd_plain(s1, s2p, ct2, band, t, implicit=True)
    torch.cuda.synchronize()
    bits = {"pass 1 along x fwd": bits_err(out, outp),
            "pass 1 along x bwd": max(bits_err(a, b) for a, b in zip(dg, dgp)),
            "pass 2 implicit fwd": bits_err(s2, s2p), "pass 2 implicit bwd": bits_err(dg2, dg2p)}
    if band <= 300:  # the column form's plain pass costs band-long loops on the transposed strips
        old = [softmin.softmin_col_fwd_plain(gext, band, t).transpose(-1, -2)
               for _, gext in composed_strips(gray, band, tau, t)[:2]]
        bits["pass 1 vs the column form + cat"] = bits_err(s1, torch.cat(old, -1))
    log(f"check composed forms {label} band {band} T {t} impl {impl}: "
        + ", ".join(f"{k} {v} values differ" for k, v in bits.items())
        + f"; finite {bool(torch.isfinite(s2).all())}")
    require(not any(bits.values()) and bool(torch.isfinite(s2).all()) and bool(torch.isfinite(dg2).all()),
            f"a soft-min form differs from its plain version on {label}")
    return {"softmin_col_fwd": max(abs_err(out, outp), abs_err(s2, s2p)),
            "softmin_col_bwd": max(max(abs_err(a, b) for a, b in zip(dg, dgp)), abs_err(dg2, dg2p))}


def composed_phases(dev, glyph):
    """Phases 20-22. Returns (errors, launches, times, bounds)."""
    err = {k: 0.0 for k in softmin.LAUNCHES}
    band, tau, t = COMPOSED_SPREAD + 2, TRAIN_TAU, TRAIN_T
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    rng = np.random.default_rng(SEED + 10)

    def check(label, gext, band, t):
        s = softmin.softmin_col_fwd(gext, band, t)
        sp = softmin.softmin_col_fwd_plain(gext, band, t)
        ct = torch.randn(sp.shape, generator=gen, device=dev)
        dg = softmin.softmin_col_bwd(gext, sp, ct, band, t)
        dgp = softmin.softmin_col_bwd_plain(gext, sp, ct, band, t)
        torch.cuda.synchronize()
        bits = (bits_err(s, sp), bits_err(dg, dgp))
        errs = {"softmin_col_fwd": abs_err(s, sp), "softmin_col_bwd": abs_err(dg, dgp)}
        for k, e in errs.items():
            err[k] = max(err[k], e)
        log(f"check composed {label} gext {tuple(gext.shape)} band {band} T {t}: softmin_col_fwd {bits[0]} "
            f"values differ, softmin_col_bwd {bits[1]}; finite {bool(torch.isfinite(s).all())}")
        require(bits == (0, 0) and bool(torch.isfinite(s).all()) and bool(torch.isfinite(dg).all()),
                f"a column soft-min kernel differs from its plain version on {label}")

    big = {
        "noise": torch.from_numpy((rng.random((SIZE, SIZE)) * 255).astype(np.float32)).to(dev),
        "pm2000": torch.from_numpy(pm_noise((SIZE, SIZE), SEED + 12)).to(dev),
        "glyph+-2040": torch.from_numpy(glyph[..., 1].astype(np.float32) / 255 * 4080 - 2040).to(dev),
    }
    # phase 20: both kernels against their plain versions, tolerance 0
    for name, g in big.items():
        for label, gext in composed_strips(g, band, tau, t):
            check(f"{name} {SIZE}x{SIZE} {label}", gext, band, t)
    small = torch.from_numpy(pm_noise((2048, 2048), SEED + 13)).to(dev)
    for label, gext in composed_strips(small, 258, 1.0, 0.5):
        check(f"pm2000 2048x2048 {label}", gext, 258, 0.5)
    for b in (0, 1, 113):
        for label, gext in composed_strips(big["pm2000"][:512, :512], b, tau, t):
            check(f"pm2000 512x512 {label}", gext, b, t)
    for shape in ((1, SIZE), (SIZE, 1), (139, 131), (3, 256, 256)):
        g = torch.from_numpy(pm_noise(shape, int(rng.integers(1 << 30)))).to(dev)
        for label, gext in composed_strips(g, band, 1.0, 0.5):
            check(f"pm2000 {shape} {label}", gext, band, 0.5)
        check(f"heights {shape}", torch.nn.functional.pad(g.abs(), (0, 0, band, band), value=1e30), band, t)
    # the forms the composed path runs (pass 1 along x on both fields' heights, written into the
    # halves of S1; pass 2 along y, both with implicit sentinels) and the global-load instance
    forms = [(f"{name} {SIZE}x{SIZE}", g, band, tau, t, "auto") for name, g in big.items()]
    forms += [("pm2000 4096x4096 global-load instance", big["pm2000"], band, tau, t, "global"),
              ("pm2000 2048x2048", small, 258, 1.0, 0.5, "auto"),
              ("pm2000 2048x2048 band 1000 (past the staged strip along y)", small, 1000, 1.0, 0.5, "auto")]
    forms += [("pm2000 512x512", big["pm2000"][:512, :512].contiguous(), b, tau, t, "auto") for b in (0, 1, 113)]
    for shape in ((1, SIZE), (SIZE, 1), (139, 131), (3, 256, 256)):
        g = torch.from_numpy(pm_noise(shape, int(rng.integers(1 << 30)))).to(dev)
        forms.append((f"pm2000 {shape}", g, band, 1.0, 0.5, "auto"))
    for label, g, b, tau_, t_, impl in forms:
        for k, e in check_forms(label, g, b, tau_, t_, gen, impl).items():
            err[k] = max(err[k], e)
    sat = softmin.softmin_col_fwd(torch.full((64 + 2 * band, 256), 1e30, device=dev), band, 0.5)
    log(f"check composed all-1e30 strip: finite {bool(torch.isfinite(sat).all())}, min {float(sat.min()):.3e}")
    require(bool(torch.isfinite(sat).all()) and bool((sat > 1e29).all()), "the all-1e30 strip left (1e29, inf)")

    # phase 21: the composed path through its entry points
    def reset_counts():
        torch.cuda.synchronize()
        for counts in (cuda_soft_mm.LAUNCHES, soft_fused.LAUNCHES, softmin.LAUNCHES):
            for k in counts:
                counts[k] = 0

    def counts():
        torch.cuda.synchronize()
        return {**cuda_soft_mm.LAUNCHES, **soft_fused.LAUNCHES, **softmin.LAUNCHES}

    def step_with(field_fn):
        def step(g):
            x = g.detach().requires_grad_()
            value = field_fn(x).sum()
            value.backward()
            with torch.no_grad():
                return x - TRAIN_LR * x.grad, value.detach(), x.grad
        return step

    def held(label, step, g0, steps=3):
        """``steps`` steps with the counts read over them; the first step's
        value and gradient against the plain twin."""
        reset_counts()
        g, values, first = g0, [], None
        for _ in range(steps):
            g, value, grad = step(g)
            values.append(float(value))
            first = first if first is not None else grad
        c = counts()
        require(all(math.isfinite(v) for v in values) and bool(torch.isfinite(g).all()),
                f"{label}: the training step is not finite")
        with plain_softmin():
            _, p_value, p_grad = step(g0)
        rel_v = abs(values[0] - float(p_value)) / max(abs(float(p_value)), 1e-30)
        rel_g = float((first - p_grad).abs().max()) / max(float(p_grad.abs().max()), 1e-30)
        log(f"main path composed: {label} {steps} steps, losses {values}, launches "
            f"{ {k: v for k, v in c.items() if v} }; step 1 vs plain twin: loss rel err {rel_v:.3e}, "
            f"gradient {rel_g:.3e} of scale")
        require(rel_v < 1e-5 and rel_g < 1e-4, f"{label}: the step differs from its plain twin")
        return c

    composed_step = step_with(lambda x: softsdf.soft_sdf_field(x, COMPOSED_SPREAD, tau=tau, temperature=t))
    launches = None
    for name in ("noise", "pm2000"):
        c = held(f"training {name} {SIZE}x{SIZE} spread {COMPOSED_SPREAD}", composed_step, big[name])
        require(c["softmin_col_fwd"] == 6 and c["softmin_col_bwd"] == 6
                and not any(v for k, v in c.items() if not k.startswith("softmin")),
                f"the composed step on {name} did not launch 2 + 2 soft-mins and nothing else")
        if name == "pm2000":
            launches = {k: c[k] for k in softmin.LAUNCHES}
    row = torch.from_numpy(pm_noise((1, SIZE), SEED + 14)).to(dev)
    c = held(f"one row (1, {SIZE}) spread {SPREAD}",
             step_with(lambda x: softsdf.soft_sdf_field(x, SPREAD, tau=tau, temperature=t)), row)
    require(c["softmin_col_fwd"] == 6 and c["softmin_col_bwd"] == 6, "the one-row step did not run 2 + 2")

    # the glyph's 1024x1024 corner, blurred (5x5 box) so that its stroke edges hold gradients, in
    # +-2040: the kernels' chain against the independent scan oracle
    a = torch.from_numpy(glyph[:1024, :1024, 1].astype(np.float32)).to(dev)[None, None]
    a = torch.nn.functional.avg_pool2d(a, 5, stride=1, padding=2, count_include_pad=False)[0, 0]
    corner = (a / 255 * 4080 - 2040).contiguous()
    ct = torch.randn(corner.shape, generator=gen, device=dev)
    x = corner.clone().requires_grad_()
    f_k = softsdf.soft_sdf_field(x, COMPOSED_SPREAD, tau=tau, temperature=t)
    (f_k * ct).sum().backward()
    y = corner.clone().requires_grad_()
    f_s = softsdf.soft_sdf_field_composed(y, COMPOSED_SPREAD, tau=tau, temperature=t)
    (f_s * ct).sum().backward()
    e_f, e_g = abs_err(f_k.detach(), f_s.detach()), abs_err(x.grad, y.grad) / float(y.grad.abs().max())
    log(f"main path composed: blurred glyph+-2040 1024x1024 vs the scan oracle: field max abs err {e_f:.3e}, "
        f"gradient {e_g:.3e} of scale")
    require(e_f <= 1e-4 and e_g <= 1e-3, "the composed path differs from the scan oracle on the glyph")
    del x, y, f_k, f_s, ct

    # the trainer past band 112
    img = torch.from_numpy(np.stack([pm_noise((SIZE, SIZE), SEED + 15), pm_noise((SIZE, SIZE), SEED + 16)], -1)).to(dev)
    d_in, d_out = edt.dual_edt_banded(img[..., 1] > 127, band)
    target = merge.signed_merge(d_out, d_in)
    model = SoftSDFModel(COMPOSED_SPREAD, SoftConfig(tau=tau, temperature=t), device=dev)

    def model_grads():
        loss = torch.mean((model(img) - target) ** 2)
        return [loss.detach()] + list(torch.autograd.grad(loss, list(model.parameters())))

    k_out = model_grads()
    with plain_softmin():
        p_out = model_grads()
    rel_v = abs(float(k_out[0]) - float(p_out[0])) / abs(float(p_out[0]))
    rel_g = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(k_out[1:], p_out[1:]))
    log(f"main path composed: SoftSDFModel spread {COMPOSED_SPREAD} step 1 vs plain twin: loss rel err "
        f"{rel_v:.3e}, parameter gradients {rel_g:.3e} of their size")
    require(rel_v < 1e-5 and rel_g < 1e-3, "SoftSDFModel past band 112 differs from its plain twin")
    train = make_train_step(model, create_train_state(model, img, lr=ADAM_LR))
    reset_counts()
    losses = [float(train(img, target)) for _ in range(3)]
    c = counts()
    log(f"main path composed: SoftSDFModel {tuple(img.shape)} 3 Adam steps, losses {losses}, launches "
        f"{ {k: v for k, v in c.items() if v} }")
    require(all(math.isfinite(v) for v in losses) and c["softmin_col_fwd"] == 6 and c["softmin_col_bwd"] == 6
            and not any(v for k, v in c.items() if not k.startswith("softmin")),
            "SoftSDFModel past band 112 did not run the column soft-mins alone")

    # the CLI: an undeclared range past band 112 on the glyph PNG
    flags = ["--soft", "-s", str(COMPOSED_SPREAD), "--gray-range", "-1000000000", "1000000000"]
    cli_out, cli_log, cli_field = run_cli(glyph, flags, "soft composed", soft_field=True)
    gray = torch.from_numpy(glyph[..., 1].astype(np.float32)).to(dev)
    soft_cfg = SoftConfig()
    with plain_softmin():
        plain_field = softsdf.soft_sdf_field(gray, COMPOSED_SPREAD, tau=soft_cfg.tau, temperature=soft_cfg.temperature,
                                             eps=soft_cfg.eps)
    plain_bytes = torch.clamp(merge.soft_remap(plain_field, COMPOSED_SPREAD, False, "hard"), 0, 255)
    plain_bytes = plain_bytes.to(torch.int32).cpu().numpy()
    e_bytes = int(np.abs(cli_out.astype(np.int32) - plain_bytes).max())
    e_field = float(np.abs(cli_field - plain_field.cpu().numpy()).max())
    log(f"main path composed: CLI vs plain twin: bytes max abs err {e_bytes}, field max abs err {e_field:.3e}")
    require(bool(np.isfinite(cli_field).all()) and e_bytes <= 1 and e_field <= 1e-4,
            "the composed CLI differs from its plain twin")
    cli_launches = json.loads(next(l for l in cli_log if "kernel launches" in l).split("launches ", 1)[1])
    require(cli_launches["softmin_col_fwd"] > 0 and cli_launches["soft_mm_fwd"] == 0
            and cli_launches["soft_f1"] == 0, "the composed CLI did not launch the column soft-min alone")
    del gray, plain_field

    # the declared wide-tap step: float32 matrix products, no kernel
    glyph_u8 = torch.from_numpy(glyph[..., 1].astype(np.float32)).to(dev)
    wide_step = step_with(lambda x: softsdf.soft_sdf_field(x, SPREAD, tau=tau, temperature=WIDE_T, gray_range=U8))
    k1, k2, c_shift = soft_mxu.range_stats(SPREAD + 2, tau, WIDE_T, U8)
    reset_counts()
    g, values = glyph_u8, []
    for _ in range(3):
        g, value, _ = wide_step(g)
        values.append(float(value))
    c = counts()
    log(f"main path wide taps: tau {tau} T {WIDE_T} k = ({k1}, {k2}) {SIZE}x{SIZE} 3 steps, losses {values}, "
        f"launches {c}")
    require(not any(c.values()) and all(math.isfinite(v) for v in values), "the wide-tap step launched a kernel")
    wcorner = glyph_u8[:1024, :1024].contiguous()
    _, w_value, w_grad = wide_step(wcorner)
    _, p_value, p_grad = step_with(
        lambda x: soft_mxu.soft_field_collapsed(x, k1, k2, c_shift, tau, WIDE_T, EPS)[0])(wcorner)
    rel_v = abs(float(w_value) - float(p_value)) / abs(float(p_value))
    rel_g = float((w_grad - p_grad).abs().max()) / float(p_grad.abs().max())
    field_err = abs_err(softsdf.soft_sdf_field(wcorner, SPREAD, tau=tau, temperature=WIDE_T, gray_range=U8),
                        soft_mxu.soft_field_collapsed(wcorner, k1, k2, c_shift, tau, WIDE_T, EPS)[0])
    log(f"main path wide taps: 1024x1024 corner vs soft_field_collapsed: field max abs err {field_err:.3e}, "
        f"loss rel err {rel_v:.3e}, gradient {rel_g:.3e} of scale")
    require(field_err <= 1e-4 and rel_g < 1e-4, "the wide-tap step differs from its plain twin")

    # phase 22: times with CUDA events, per step (its 2 launches each way), on pm2000 and the glyph
    times, bounds = softmin_step_times(big["pm2000"], band, tau, t, "pm2000")
    softmin_step_times(big["glyph+-2040"], band, tau, t, "glyph+-2040")
    for name in ("pm2000", "noise"):
        times[f"composed_step_{name}"] = cuda_ms(lambda: composed_step(big[name]))
        with plain_softmin():
            times[f"composed_step_{name}_plain"] = cuda_ms(lambda: composed_step(big[name]), 2, 3)
    times["soft_model_step"] = cuda_ms(lambda: train(img, target), 5, 3)
    times["wide_step"] = cuda_ms(lambda: wide_step(glyph_u8))
    times["wide_step_plain_1024"] = cuda_ms(lambda: step_with(
        lambda x: soft_mxu.soft_field_collapsed(x, k1, k2, c_shift, tau, WIDE_T, EPS)[0])(wcorner), 2, 3)
    times["wide_step_1024"] = cuda_ms(lambda: wide_step(wcorner))
    for k in ("composed_step_pm2000", "composed_step_pm2000_plain", "composed_step_noise",
              "composed_step_noise_plain", "soft_model_step", "wide_step", "wide_step_plain_1024", "wide_step_1024"):
        log(f"time composed {k}: {times[k]:.4f} ms")
    profile_device("composed step, pm2000", lambda: composed_step(big["pm2000"]))
    return err, launches, times, bounds


def softmin_step_times(g: torch.Tensor, band: int, tau: float, t: float, label: str) -> tuple:
    """Both kernels per composed step on ``g`` (CUDA events): the forms the
    composed path runs (pass 1 along x on both fields into S1, pass 2 along
    y; 2 launches each way) and their plain versions, and the column form it
    ran before (3 explicit strips, composed_strips: 3 launches each way), and
    the forms through the global-load instance; the
    bound of each (bytes: inputs read once, outputs written once; operations:
    5 per live forward tap, 6 per live backward tap) and the live taps.
    Prints each; returns (times, bounds). On a tree without the forms (the
    parent of the redesign) only the column form is timed."""
    strips = composed_strips(g, band, tau, t)
    fwd_in = [(gext, band, t) for _, gext in strips]
    s_out = [softmin.softmin_col_fwd(*a) for a in fwd_in]
    bwd_in = [(gext, s, torch.ones_like(s), band, t) for (gext, _, _), s in zip(fwd_in, s_out)]
    times = {
        "softmin_col_fwd_column_form": cuda_ms(lambda: [softmin.softmin_col_fwd(*a) for a in fwd_in]),
        "softmin_col_bwd_column_form": cuda_ms(lambda: [softmin.softmin_col_bwd(*a) for a in bwd_in]),
    }
    taps = {"softmin_col_fwd": 0, "softmin_col_bwd": 0}
    col_bytes = {"softmin_col_fwd": 0, "softmin_col_bwd": 0}
    for (gext, _, _), s in zip(fwd_in, s_out):
        col_bytes["softmin_col_fwd"] += 4 * (gext.numel() + s.numel())
        col_bytes["softmin_col_bwd"] += 4 * 2 * (gext.numel() + s.numel())
        tf, tb = col_taps(gext, s, band, t)
        taps["softmin_col_fwd"] += tf
        taps["softmin_col_bwd"] += tb
    ops = {"softmin_col_fwd": 5 * taps["softmin_col_fwd"], "softmin_col_bwd": 6 * taps["softmin_col_bwd"]}
    bounds = {f"{k}_column_form": bound(col_bytes[k], ops[k]) for k in taps}
    if hasattr(softmin, "band_softmin_fields"):
        fields = composed_heights(g, band, tau, t)
        x1 = dict(axis=-1, implicit=True)
        s1 = softmin.softmin_col_fwd(fields, band, t, **x1)
        s2 = softmin.softmin_col_fwd(s1, band, t, implicit=True)
        ct1, ct2 = torch.ones_like(s1), torch.ones_like(s2)

        def fwd(f, **kw):
            return lambda: (f(fields, band, t, out=s1, **x1, **kw), f(s1, band, t, implicit=True, **kw))

        def bwd(f, **kw):
            return lambda: (f(fields, s1, ct1, band, t, **x1, **kw), f(s1, s2, ct2, band, t, implicit=True, **kw))

        times["softmin_col_fwd"] = cuda_ms(fwd(softmin.softmin_col_fwd))
        times["softmin_col_fwd_plain"] = cuda_ms(fwd(softmin.softmin_col_fwd_plain), 2, 3)
        times["softmin_col_fwd_global"] = cuda_ms(fwd(softmin.softmin_col_fwd, impl="global"))
        times["softmin_col_bwd"] = cuda_ms(bwd(softmin.softmin_col_bwd))
        times["softmin_col_bwd_plain"] = cuda_ms(bwd(softmin.softmin_col_bwd_plain), 2, 3)
        times["softmin_col_bwd_global"] = cuda_ms(bwd(softmin.softmin_col_bwd, impl="global"))
        nbytes = 4 * (sum(f.numel() for f in fields) + 2 * s1.numel() + s2.numel())
        bounds["softmin_col_fwd"] = bound(nbytes, ops["softmin_col_fwd"])
        bounds["softmin_col_bwd"] = bound(2 * nbytes, ops["softmin_col_bwd"])
    npix = g.numel()
    for k, n in taps.items():
        log(f"bound inputs {k} {label}: {n} live taps per step ({n / (4 * npix):.2f} per pixel and pass)")
    for k, ms in times.items():
        log(f"time composed {k} {label}: {ms:.4f} ms per step")
    for k, (b_ms, by) in bounds.items():
        log(f"bound composed {k} {label}: {b_ms:.4f} ms ({by}); measured {times[k]:.4f} ms, "
            f"roofline share {100 * b_ms / times[k]:.1f}%")
    return times, bounds


def composed_turn(dev, glyph) -> None:
    """Phase 22's measurements alone, on any tree that has the composed path
    (this one or its parent, for turns in one call): both kernels per step
    on pm2000 and the glyph in +-2040, the composed step on pm2000, the
    SoftSDFModel(spread=128) step, and the composed step's profile."""
    band, tau, t = COMPOSED_SPREAD + 2, TRAIN_TAU, TRAIN_T
    inputs = {
        "pm2000": torch.from_numpy(pm_noise((SIZE, SIZE), SEED + 12)).to(dev),
        "glyph+-2040": torch.from_numpy(glyph[..., 1].astype(np.float32) / 255 * 4080 - 2040).to(dev),
    }
    for name, g in inputs.items():
        softmin_step_times(g, band, tau, t, name)

    def composed_step(g):
        x = g.detach().requires_grad_()
        value = softsdf.soft_sdf_field(x, COMPOSED_SPREAD, tau=tau, temperature=t).sum()
        value.backward()
        with torch.no_grad():
            return x - TRAIN_LR * x.grad

    log(f"time composed composed_step_pm2000: {cuda_ms(lambda: composed_step(inputs['pm2000'])):.4f} ms")
    img = torch.from_numpy(np.stack([pm_noise((SIZE, SIZE), SEED + 15), pm_noise((SIZE, SIZE), SEED + 16)],
                                    -1)).to(dev)
    d_in, d_out = edt.dual_edt_banded(img[..., 1] > 127, band)
    target = merge.signed_merge(d_out, d_in)
    model = SoftSDFModel(COMPOSED_SPREAD, SoftConfig(tau=tau, temperature=t), device=dev)
    train = make_train_step(model, create_train_state(model, img, lr=ADAM_LR))
    log(f"time composed soft_model_step: {cuda_ms(lambda: train(img, target), 5, 3):.4f} ms")
    profile_device("composed step, pm2000", lambda: composed_step(inputs["pm2000"]))


def rows_time(label: str, fn) -> None:
    """A row pass's time (rows 1, 3, 14): CUDA events (cuda_ms, the kernels
    line's ms), a CUDA graph of 10 calls (graph_ms: the wrapper's host cost
    nears the device time) and the host's time a call (host_us), with a
    digest of each output."""
    out = fn()
    digests = " ".join(digest(o) for o in (out if isinstance(out, tuple) else (out,)))
    log(f"time {label}: {cuda_ms(fn):.4f} ms, graph {graph_ms(fn):.4f} ms, host {host_us(fn):.1f} us a call; "
        f"digest {digests}")


def edt_turn(dev, noise, glyph) -> None:
    """Rows 1-5 and what they serve, on the glyph and the noise at 4096^2:
    edt_rows at bands 66 (uint8 strips), 302 and the exact field's
    dist_sat(4096) - 1 (uint16; rows_time: CUDA events, graph, host),
    edt_band_bytes at spreads 64 (uint8 strips) and 300 (uint16), edt_dist
    on both strips of the signed field, the EXACT pipeline
    (SDFGenerator.generate), signed_distance_field_exact and sharded EXACT
    over (4,) logical shards under rdma; each time with a digest of the
    output, so that turns of two trees in one call can be compared."""
    m4 = logical_mesh(dev, (SHARDS,))
    for name, img2ch in (("glyph", glyph), ("noise", noise)):
        img = torch.from_numpy(img2ch).to(dev)
        b = threshold.hard_threshold(img)
        for band in (SPREAD + 2, 302, cuda_edt.dist_sat(SIZE) - 1):
            rows_time(f"{name} edt_rows band {band} ({cuda_edt.strip_dtype(band)})",
                      lambda: cuda_edt.row_distances_u8(b, band))
        for spread in (SPREAD, 300):
            band = spread + 2
            din, dout = cuda_edt.row_distances_u8(b, band)
            ms = cuda_ms(lambda: cuda_edt.fused_pass2_bytes(din, dout, spread, False, band))
            path = "?"  # a parent tree without the launcher's query
            if hasattr(cuda_edt, "pass2_staged"):
                path = "staged" if cuda_edt.pass2_staged(SIZE, band, din.element_size()) else "per-pixel walk"
            log(f"time {name} edt_band_bytes spread {spread} ({din.dtype}): {ms:.4f} ms ({path}); digest "
                f"{digest(cuda_edt.fused_pass2_bytes(din, dout, spread, False, band))}")
        sat = cuda_edt.dist_sat(SIZE)
        din, dout = cuda_edt.row_distances_u8(b, sat - 1)
        for strip, d in (("in", din), ("out", dout)):
            ms = cuda_ms(lambda: cuda_edt.exact_dist(d, sat))
            paths = "?"  # a parent tree without edt_dist_core
            if hasattr(cuda_edt, "dist_core"):
                n = torch.bincount(cuda_edt.dist_core(d, sat)[2].flatten().long(), minlength=3).tolist()
                paths = f"tiles done {n[0]}, sparse {n[1]}, dense with pixels left {n[2]}"
            log(f"time {name} edt_dist '{strip}' strip: {ms:.4f} ms ({paths}); digest "
                f"{digest(cuda_edt.exact_dist(d, sat))}")
        gen = SDFGenerator(SdfConfig(spread=SPREAD), device=dev)
        log(f"time {name} exact_pipeline: {cuda_ms(lambda: gen.generate(img)):.4f} ms; digest "
            f"{digest(gen.generate(img))}")
        log(f"time {name} signed_distance_field_exact: {cuda_ms(lambda: signed_distance_field_exact(b)):.4f} ms; "
            f"digest {digest(signed_distance_field_exact(b))}")
        run = lambda: sharded.sharded_hard_sdf_bytes(b, SPREAD, m4, halo="rdma")  # noqa: E731
        log(f"time {name} sharded_exact_rdma (4,): {cuda_ms(run):.4f} ms; digest {digest(run())}")


def kernel_turn(dev, noise, glyph) -> None:
    """Rows 1-11 and 14-19 and what they serve, alone, on any tree that has
    these kernels (this one or its parent, for turns in one call): first
    edt_turn; then soft_b2, soft_f1,
    soft_f2 (row 9) and soft_b1 on the bench's noise, pm2000 and the glyph
    in +-2040, soft_mm_bwd on the bench's noise at tap radii 10 and 16, and
    soft_mm_fwd (row 6) there at 10 and 16 with and without memos (with
    digests of soft_f2's, soft_b1's and both declared kernels' outputs),
    the declared training step, the forced and gated adaptive steps and
    SoftSDFModel's step; brute_rows at spread 64 on the glyph and the noise
    (rows_time); brute_scan_bytes_halo on each shard of the glyph
    and the noise over 4 shards and at row_off 0 on the whole image beside
    brute_scan_bytes; the cols-conv kernels on phase 26's inputs
    (band_conv_turn); and sharded BRUTE over (4,)."""
    edt_turn(dev, noise, glyph)
    band, tau, t = SPREAD + 2, TRAIN_TAU, TRAIN_T
    rng = np.random.default_rng(SEED + 5)
    inputs = {
        "noise": torch.from_numpy((rng.random((SIZE, SIZE)) * 255).astype(np.float32)).to(dev),
        "pm2000": torch.from_numpy(pm_noise((SIZE, SIZE), SEED + 6)).to(dev),
        "glyph+-2040": torch.from_numpy(glyph[..., 1].astype(np.float32) / 255 * 4080 - 2040).to(dev),
    }
    b2_times_and_taps(inputs, band, tau, t, count=False)
    f1_times_and_taps(inputs, band, tau, t, count=False)
    f2_times_and_taps(inputs, band, tau, t, count=False)
    b1_times_and_taps(inputs, band, tau, t, count=False)
    mm_bwd_times(inputs["noise"])
    mm_fwd_times(inputs["noise"])

    def step_with(field_fn):
        def step(g):
            x = g.detach().requires_grad_()
            value = field_fn(x).sum()
            value.backward()
            with torch.no_grad():
                return x - TRAIN_LR * x.grad
        return step

    gated_step = step_with(lambda x: softsdf.soft_sdf_field(x, SPREAD, tau=tau, temperature=t))
    forced_step = step_with(lambda x: soft_fused.soft_sdf_field_fused(x, band, tau, t, EPS))
    declared_step = step_with(lambda x: softsdf.soft_sdf_field(x, SPREAD, tau=tau, temperature=t, gray_range=U8))
    log(f"time soft training_step (declared, noise): {cuda_ms(lambda: declared_step(inputs['noise'])):.4f} ms")
    for name in ("pm2000", "noise"):
        log(f"time adaptive {name} forced_step: {cuda_ms(lambda: forced_step(inputs[name])):.4f} ms")
        log(f"time adaptive {name} gated_step: {cuda_ms(lambda: gated_step(inputs[name])):.4f} ms")
    img = torch.from_numpy(np.stack([pm_noise((SIZE, SIZE), SEED + 7), pm_noise((SIZE, SIZE), SEED + 8)], -1)).to(dev)
    d_in, d_out = edt.dual_edt_banded(img[..., 1] > 127, band)
    target = merge.signed_merge(d_out, d_in)
    model = SoftSDFModel(SPREAD, SoftConfig(tau=tau, temperature=t), device=dev)
    train = make_train_step(model, create_train_state(model, img, lr=ADAM_LR))
    log(f"time adaptive SoftSDFModel step: {cuda_ms(lambda: train(img, target), 5, 3):.4f} ms")
    del inputs, img, target, d_in, d_out

    masks = {
        "glyph": threshold.hard_threshold(torch.from_numpy(glyph).to(dev)),
        "noise": threshold.hard_threshold(torch.from_numpy(noise).to(dev)),
    }
    for name, b in masks.items():
        rows_time(f"{name} brute_rows spread {SPREAD}", lambda: cuda_brute.seed_strips(b, SPREAD))
    halo_scan_shard_times(masks, count=False)
    band_conv_turn(dev, noise, glyph)
    m4 = logical_mesh(dev, (SHARDS,))
    for name, b in masks.items():
        strips = cuda_brute.seed_strips(b, SPREAD)
        log(f"time {name} brute_scan_bytes: {cuda_ms(lambda: cuda_brute.brute_scan_bytes(b, strips, SPREAD)):.4f} ms; "
            f"brute_scan_bytes_halo row_off 0: "
            f"{cuda_ms(lambda: cuda_brute.brute_scan_bytes_halo(b, strips, SPREAD, 0)):.4f} ms")
        for impl in ("ppermute", "rdma"):
            ms = cuda_ms(lambda: sharded.sharded_brute_sdf_bytes(b, SPREAD, m4, halo=impl))
            log(f"time {name} sharded_brute_{impl} (4,): {ms:.4f} ms")
        log(f"time {name} brute_one_device: {cuda_ms(lambda: cuda_brute.brute_sdf_bytes(b, SPREAD)):.4f} ms")


# ------------------------------------------------------------ sharded phases

SHARDS = 4
SPREAD_MULTI = 100  # the 16-shard 1024² run: band 102 over 64-row shards, 2 hops
HALO_FILLS = {torch.uint8: 255, torch.uint16: 65535, torch.int32: -1, torch.float32: -7.25}


def logical_mesh(dev, shape, names=("y",)):
    """A mesh of logical shards, all on ``dev``."""
    return make_mesh(shape, names, devices=[dev] * int(np.prod(shape)))


def differing_bytes(got: list, want: list) -> int:
    """Bytes that differ between two lists of same-shape tensors (any dtype)."""
    n = 0
    for a, b in zip(got, want):
        require(a.shape == b.shape and a.dtype == b.dtype, f"halo block {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        n += int((a.contiguous().view(torch.uint8) != b.contiguous().view(torch.uint8)).sum())
    return n


def to_slabs(blocks, band):
    """The ppermute form's peer copies of halo_slab's rows (its library
    yardstick): each neighbour's boundary rows copied by Tensor.to."""
    return ([b[..., -band:, :].to(g.device, copy=True) for b, g in zip(blocks[:-1], blocks[1:])]
            + [b[..., :band, :].to(g.device, copy=True) for b, g in zip(blocks[1:], blocks[:-1])])


def host_split(label: str, fn, entries=(), reps: int = 50) -> None:
    """Where one call of ``fn`` (one halo exchange) spends its time, the card
    idle before each call: the host's wall time of the call, the part of it
    inside _build.launch and, within that, inside the launchers' ctypes
    calls (``entries``: the CUDA launch itself), and the device time that
    torch.profiler traces for the call; then ``reps`` calls back to back,
    the host's time and the time to the card's end. Microseconds per call,
    the mean of ``reps`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    lib = _build.load()
    spent = {"launch": 0.0, "ctypes": 0.0, "launches": 0}
    real_launch, real_entries = _build.launch, {e: getattr(lib, e) for e in entries}

    def timed_launch(*args):
        t = time.perf_counter()
        real_launch(*args)
        spent["launch"] += time.perf_counter() - t

    def timed_entry(entry):
        def call(*args):
            t = time.perf_counter()
            rc = entry(*args)
            spent["ctypes"] += time.perf_counter() - t
            spent["launches"] += 1
            return rc
        return call

    fn()
    torch.cuda.synchronize()
    _build.launch = timed_launch
    for e, f in real_entries.items():
        setattr(lib, e, timed_entry(f))
    try:
        wall = 0.0
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            wall += time.perf_counter() - t
        torch.cuda.synchronize()
        iso = dict(spent)
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        b2b_host = time.perf_counter() - t
        torch.cuda.synchronize()
        b2b_end = time.perf_counter() - t
    finally:
        _build.launch = real_launch
        for e, f in real_entries.items():
            setattr(lib, e, f)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = sum(e.self_device_time_total for e in prof.key_averages() if e.self_device_time_total > 0)
    split = {k: 1e6 * iso[k] / reps for k in ("launch", "ctypes")}
    split.update(wall=1e6 * wall / reps, device=device / reps, launches=iso["launches"] / reps,
                 b2b_host=1e6 * b2b_host / reps, b2b_end=1e6 * b2b_end / reps)
    log(f"host split {label}: wall {split['wall']:.1f} us per exchange, of which _build.launch {split['launch']:.1f} "
        f"({split['launches']:g} launches), the ctypes launch calls {split['ctypes']:.1f}, the wrapper's own "
        f"{split['wall'] - split['launch']:.1f}; device {split['device']:.1f} us (torch.profiler); back to back "
        f"without a sync: host {split['b2b_host']:.1f} us per exchange, {split['b2b_end']:.1f} to the card's end")


def halo_host_splits(dev) -> None:
    """The host-time split of one exchange of each halo kernel and of its
    Tensor.to form, at phase 23's timing shapes (4x(1024, 4096) u8 at band
    66; 16x(64, 1024) u8 for the ring step)."""
    rng = np.random.default_rng(SEED + 23)
    b4 = [torch.from_numpy(rng.integers(0, 256, size=(SIZE // SHARDS, SIZE), dtype=np.uint8)).to(dev)
          for _ in range(SHARDS)]
    b16 = [torch.from_numpy(rng.integers(0, 256, size=(64, 1024), dtype=np.uint8)).to(dev) for _ in range(16)]
    band = SPREAD + 2
    host_split("halo_slab 4x(1024, 4096) u8 band 66", lambda: cuda_halo.halo_slab(b4, band, 255),
               ("chaq_halo_slab",))
    host_split("halo_slab's Tensor.to form", lambda: to_slabs(b4, band))
    host_split("halo_ring_shift 16x(64, 1024) u8", lambda: cuda_halo.halo_ring_shift(b16, b16),
               ("chaq_halo_ring_shift",))
    host_split("halo_ring_shift's Tensor.to form", lambda: [b.to(dev, copy=True) for b in b16 + b16])
    host_split("rdma frames 4x(1024, 4096) u8 band 66", lambda: cuda_halo.exchange_row_halo_rdma(b4, band, 255),
               ("chaq_halo_slab",))
    host_split("ppermute frames (halo.exchange_row_halo)", lambda: halo.exchange_row_halo(b4, band, 255))


def reset_launches():
    torch.cuda.synchronize()
    for counts in (cuda_edt.LAUNCHES, cuda_brute.LAUNCHES, cuda_halo.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {**cuda_edt.LAUNCHES, **cuda_brute.LAUNCHES, **cuda_halo.LAUNCHES}


def halo_scan_shard_times(masks: dict, count: bool = True) -> dict:
    """brute_scan_bytes_halo on each shard's frame of each (4096, 4096) mask
    over 4 shards at spread 64 (CUDA events, as in phase 6), their sum and
    the four back to back, with ``count`` the rows a pixel reads and the
    blocks that staged (scan_walk_taps); returns {name: [ms per shard]}."""
    out = {}
    h4 = SIZE // SHARDS
    for name, b in masks.items():
        frames = shard_frames(cuda_brute.seed_strips(b, SPREAD), SPREAD, SHARDS)
        locals_ = [b[i * h4 : (i + 1) * h4].contiguous() for i in range(SHARDS)]
        calls = [functools.partial(cuda_brute.brute_scan_bytes_halo, lb, ext, SPREAD, SPREAD)
                 for lb, ext in zip(locals_, frames)]
        out[name] = [cuda_ms(fn) for fn in calls]
        all4 = cuda_ms(lambda: [fn() for fn in calls])
        line = (f"time halo scan {name} shards " + ", ".join(f"{ms:.4f}" for ms in out[name])
                + f" ms, sum {sum(out[name]):.4f} ms, the four back to back {all4:.4f} ms")
        if count:
            stats = [scan_walk_taps(lb, ext, SPREAD, SPREAD) for lb, ext in zip(locals_, frames)]
            line += (f"; {sum(x[0] for x in stats) / b.numel():.3f} rows read a pixel, blocks staged "
                     f"{sum(x[1] for x in stats)} of {sum(x[2] for x in stats)}")
        log(line)
        del frames, locals_, calls
    return out


def sharded_phases(dev, noise, glyph):
    """Phases 23-25. Returns (errors, launches, glyph times, bounds)."""
    err = {"brute_scan_bytes_halo": 0, "halo_slab": 0, "halo_ring_shift": 0}
    rng = np.random.default_rng(SEED + 23)
    h4 = SIZE // SHARDS

    def rand_blocks(n, h, dtype):
        x = torch.from_numpy(rng.integers(0, 1 << 16, size=(n, h, SIZE), dtype=np.int32)).to(dev)
        return [x[i].to(dtype).contiguous() for i in range(n)]

    # phase 23: the halo kernels against their plain versions, bit for bit
    for dtype, fill in HALO_FILLS.items():
        blocks = rand_blocks(SHARDS, h4, dtype)
        for band in (SPREAD + 2, 72):
            e = differing_bytes(sum(cuda_halo.halo_slab(blocks, band, fill), []),
                                sum(cuda_halo.halo_slab_plain(blocks, band, fill), []))
            err["halo_slab"] = max(err["halo_slab"], e)
            log(f"check halo_slab {dtype} {SHARDS}x({h4}, {SIZE}) band {band} fill {fill}: {e} bytes differ")
            e = differing_bytes(cuda_halo.exchange_row_halo_rdma(blocks, band, fill),
                                halo.exchange_row_halo(blocks, band, fill))
            err["halo_slab"] = max(err["halo_slab"], e)
            log(f"check rdma frames {dtype} {SHARDS}x({h4}, {SIZE}) band {band} vs ppermute: {e} bytes differ")
        e = differing_bytes(sum(cuda_halo.halo_ring_shift(blocks, blocks[::-1]), []),
                            sum(cuda_halo.halo_ring_shift_plain(blocks, blocks[::-1]), []))
        err["halo_ring_shift"] = max(err["halo_ring_shift"], e)
        log(f"check halo_ring_shift {dtype} {SHARDS}x({h4}, {SIZE}): {e} bytes differ")
        short = rand_blocks(8, 64, dtype)
        e = differing_bytes(cuda_halo.exchange_row_halo_rdma(short, 150, fill),
                            halo.exchange_row_halo(short, 150, fill))
        err["halo_ring_shift"] = max(err["halo_ring_shift"], e)
        log(f"check rdma exchange {dtype} 8x(64, {SIZE}) band 150 (3 hops) vs ppermute: {e} bytes differ")
        del blocks, short
    # the ring shift at the main path's shape: u8 strips of the 16-shard
    # multi-hop run (1024², spread 100: band 102 over 64-row shards, 2 hops)
    b16 = [t[:, :1024].contiguous() for t in rand_blocks(16, 64, torch.uint8)]
    e = differing_bytes(cuda_halo.exchange_row_halo_rdma(b16, SPREAD_MULTI + 2, 255),
                        halo.exchange_row_halo(b16, SPREAD_MULTI + 2, 255))
    err["halo_ring_shift"] = max(err["halo_ring_shift"], e)
    log(f"check rdma exchange u8 16x(64, 1024) band {SPREAD_MULTI + 2} (2 hops) vs ppermute: {e} bytes differ")
    require(err["halo_slab"] == 0 and err["halo_ring_shift"] == 0, "a halo kernel differs from its plain version")

    # the shapes the main path gives them: a 4096-wide u8 strip over 4 shards
    # at band 66 (halo_slab, and the frames of the sharded pipelines), and
    # 1024-wide 64-row shards (the ring shift of the 16-shard multi-hop run)
    band = SPREAD + 2
    b4 = rand_blocks(SHARDS, h4, torch.uint8)
    exchanges = {
        "halo_slab": lambda: cuda_halo.halo_slab(b4, band, 255),
        "halo_ring_shift": lambda: cuda_halo.halo_ring_shift(b16, b16),
        "halo_frames": lambda: cuda_halo.exchange_row_halo_rdma(b4, band, 255),
    }
    per_exchange = {}
    for k, fn in exchanges.items():
        reset_launches()
        fn()
        per_exchange[k] = sum(read_launches()[name] for name in ("halo_slab", "halo_ring_shift"))
    times = {
        "halo_slab": cuda_ms(exchanges["halo_slab"]),
        "halo_slab_plain": cuda_ms(lambda: cuda_halo.halo_slab_plain(b4, band, 255)),
        "halo_slab_library": cuda_ms(lambda: to_slabs(b4, band)),
        "halo_ring_shift": cuda_ms(exchanges["halo_ring_shift"]),
        "halo_ring_shift_plain": cuda_ms(lambda: cuda_halo.halo_ring_shift_plain(b16, b16)),
        "halo_ring_shift_library": cuda_ms(lambda: [b.to(dev, copy=True) for b in b16 + b16]),
        "halo_frames": cuda_ms(exchanges["halo_frames"]),
        "halo_frames_ppermute": cuda_ms(lambda: halo.exchange_row_halo(b4, band, 255)),
    }
    bounds = {
        # each neighbour's halo rows read once, each shard's two slabs written
        # once: the first shard's up and the last one's down are fill, not read
        "halo_slab": bound(((2 * SHARDS - 2) + 2 * SHARDS) * band * SIZE, 0),
        "halo_ring_shift": bound(2 * 16 * 2 * 64 * 1024, 0),
        # the frames written once, each shard's centre rows and its
        # neighbours' halo rows read once
        "halo_frames": bound((SHARDS * (h4 + 2 * band) + SHARDS * h4 + (2 * SHARDS - 2) * band) * SIZE, 0),
    }
    for k, lib in (("halo_slab", "_library"), ("halo_ring_shift", "_library"), ("halo_frames", "_ppermute")):
        plain = f", plain {times[k + '_plain']:.4f}" if k + "_plain" in times else ""
        log(f"time {k}: {times[k]:.4f} ms per exchange ({per_exchange[k]} launch(es)){plain}, "
            f"{'Tensor.to' if lib == '_library' else 'halo.exchange_row_halo'} {times[k + lib]:.4f}; bound "
            f"{bounds[k][0]:.5f} ms ({bounds[k][1]})")
    require(per_exchange == {"halo_slab": 1, "halo_ring_shift": 1, "halo_frames": 1},
            f"a halo exchange over logical shards of one card took other than one launch: {per_exchange}")
    del b4, b16
    halo_host_splits(dev)

    # phase 24: sharded EXACT and BRUTE at full width, byte for byte one device
    masks = {
        "noise": threshold.hard_threshold(torch.from_numpy(noise).to(dev)),
        "glyph": threshold.hard_threshold(torch.from_numpy(glyph).to(dev)),
    }
    layouts = (("(4,)", logical_mesh(dev, (SHARDS,)), None),
               ("(2, 2)", logical_mesh(dev, (2, 2), ("y", "x")), "x"))

    def check_sharded(label, b, spread, m, x_axis=None, batch_axis=None, algos=("exact", "brute")):
        for algo in algos:
            if algo == "exact":
                want = cuda_edt.fused_sdf_bytes(b, spread)
                run = lambda impl: sharded.sharded_hard_sdf_bytes(  # noqa: E731
                    b, spread, m, halo=impl, x_axis=x_axis, batch_axis=batch_axis)
            else:
                want = cuda_brute.brute_sdf_bytes(b, spread)
                run = lambda impl: sharded.sharded_brute_sdf_bytes(  # noqa: E731
                    b, spread, m, halo=impl, x_axis=x_axis, batch_axis=batch_axis)
            for impl in ("ppermute", "rdma"):
                e = max_abs_err(run(impl), want)
                log(f"check sharded {algo} {label} {tuple(b.shape)} spread {spread} {impl}: max abs err {e} "
                    f"vs one device")
                require(e == 0, f"sharded {algo} {label} {impl} differs from the single-device pipeline")

    for name, b in masks.items():
        for label, m, x_axis in layouts:
            check_sharded(f"{name} {label}", b, SPREAD, m, x_axis)
    half = SIZE // 2
    stack = torch.stack([masks[k][y:y + half, x:x + half] for k in masks for y in (0, half) for x in (0, half)])
    check_sharded(f"(8, {half}, {half}) on ('data', 'y') (2, 2)", stack, SPREAD,
                  logical_mesh(dev, (2, 2), ("data", "y")), batch_axis="data")
    del stack
    g = masks["glyph"]
    check_sharded("glyph (4,) u16 strips", g, 300, layouts[0][1], algos=("exact",))
    corner = g[:1024, :1024].contiguous()
    check_sharded("glyph 1024x1024 over 16 shards (multi-hop)", corner, SPREAD_MULTI, logical_mesh(dev, (16,)))

    # row 16 against its plain version, on shard 1's halo'd planes; and
    # halo_slab on the plane stacks BRUTE's rdma run exchanges (8 images a block)
    for name, b in masks.items():
        planes = cuda_brute.seed_strips(b, SPREAD)
        stacks = [planes[..., i * h4 : (i + 1) * h4, :].contiguous() for i in range(SHARDS)]
        e = differing_bytes(sum(cuda_halo.halo_slab(stacks, SPREAD, SPREAD + 1), []),
                            sum(cuda_halo.halo_slab_plain(stacks, SPREAD, SPREAD + 1), []))
        err["halo_slab"] = max(err["halo_slab"], e)
        log(f"check halo_slab {name} planes {SHARDS}x{tuple(stacks[0].shape)} band {SPREAD} fill {SPREAD + 1}: "
            f"{e} bytes differ")
        require(e == 0, "halo_slab differs from its plain version on BRUTE's plane stacks")
        del stacks
        # every shard's frame, uint8 planes at spread 64 and uint16 at 300
        # (past the staged kernel's shared memory: the per-pixel walk)
        for spread in (SPREAD, 300):
            planes = cuda_brute.seed_strips(b, spread)
            one = cuda_brute.brute_sdf_bytes(b, spread)
            for i, ext in enumerate(shard_frames(planes, spread, SHARDS)):
                local = b[i * h4 : (i + 1) * h4].contiguous()
                got = cuda_brute.brute_scan_bytes_halo(local, ext, spread, spread)
                e = max_abs_err(got, cuda_brute.brute_scan_bytes_halo_plain(local, ext, spread, spread))
                e2 = max_abs_err(got, one[i * h4 : (i + 1) * h4])
                err["brute_scan_bytes_halo"] = max(err["brute_scan_bytes_halo"], e, e2)
                log(f"check brute_scan_bytes_halo {name} spread {spread} shard {i} of {SHARDS}, planes "
                    f"{tuple(ext.shape)} {ext.dtype}: err {e} vs plain, {e2} vs one device")
                require(e == 0 and e2 == 0, "brute_scan_bytes_halo differs from its plain version or one device")
            del planes, one
    del ext

    # the int32 strips (band above 65534) against their plain versions
    din, dout = cuda_edt.row_distances_u8(corner, 65602)
    pin, pout = cuda_edt.row_distances_u8_plain(corner, 65602)
    e1 = max(max_abs_err(din, pin), max_abs_err(dout, pout))
    e2 = max_abs_err(cuda_edt.fused_pass2_bytes(din, dout, 65600, False, 65602),
                     cuda_edt.fused_pass2_bytes_plain(pin, pout, 65600, False, 65602))
    log(f"check int32 strips glyph 1024x1024 spread 65600: edt_rows err {e1}, edt_band_bytes err {e2}")
    require(din.dtype == torch.int32 and e1 == 0 and e2 == 0, "the int32 strips differ from their plain versions")

    # the launch counters: the sharded main path under rdma (4 shards at 4096²,
    # and the 16-shard multi-hop run), then under ppermute, then unsharded
    m4 = layouts[0][1]
    reset_launches()
    sharded.sharded_hard_sdf_bytes(g, SPREAD, m4, halo="rdma")
    sharded.sharded_brute_sdf_bytes(g, SPREAD, m4, halo="rdma")
    sharded.sharded_hard_sdf_bytes(corner, SPREAD_MULTI, logical_mesh(dev, (16,)), halo="rdma")
    launches = read_launches()
    log(f"main path sharded rdma: launches {launches}")
    for k in err:
        require(launches[k] > 0, f"kernel {k} was not launched on the sharded rdma path")
    # one launch per exchange and device: EXACT's two exchanges and BRUTE's
    # one over 4 shards; EXACT's two over 16 shards, 2 hops each
    require(launches["halo_slab"] == 3 and launches["halo_ring_shift"] == 4,
            "the rdma exchanges took other than one launch per exchange (and hop) and device")
    reset_launches()
    sharded.sharded_hard_sdf_bytes(g, SPREAD, m4)
    sharded.sharded_brute_sdf_bytes(g, SPREAD, m4)
    pp = read_launches()
    log(f"main path sharded ppermute: launches {pp}")
    require(pp["halo_slab"] == pp["halo_ring_shift"] == 0 and pp["brute_scan_bytes_halo"] == SHARDS,
            "the ppermute path launched a halo kernel, or the halo scan did not run once per shard")
    reset_launches()
    cuda_edt.fused_sdf_bytes(g, SPREAD)
    cuda_brute.brute_sdf_bytes(g, SPREAD)
    one = read_launches()
    require(one["brute_scan_bytes_halo"] == one["halo_slab"] == one["halo_ring_shift"] == 0,
            "the single-device path launched a sharded kernel")

    # times: 4 shards against one device, the glyph at 4096², spread 64
    for impl in ("ppermute", "rdma"):
        times[f"sharded_exact_{impl}"] = cuda_ms(lambda: sharded.sharded_hard_sdf_bytes(g, SPREAD, m4, halo=impl))
        times[f"sharded_brute_{impl}"] = cuda_ms(lambda: sharded.sharded_brute_sdf_bytes(g, SPREAD, m4, halo=impl))
    times["exact_one_device"] = cuda_ms(lambda: cuda_edt.fused_sdf_bytes(g, SPREAD))
    times["brute_one_device"] = cuda_ms(lambda: cuda_brute.brute_sdf_bytes(g, SPREAD))
    shard_times = halo_scan_shard_times(masks)
    times["brute_scan_bytes_halo"] = shard_times["glyph"][1]
    local = g[h4 : 2 * h4].contiguous()
    ext = shard_frames(cuda_brute.seed_strips(g, SPREAD), SPREAD, SHARDS)[1]
    times["brute_scan_bytes_halo_plain"] = cuda_ms(
        lambda: cuda_brute.brute_scan_bytes_halo_plain(local, ext, SPREAD, SPREAD), 2, 3)
    npix = h4 * SIZE
    # the shard's mask and its halo'd planes in, its bytes out
    bounds["brute_scan_bytes_halo"] = bound(npix + ext.numel() * ext.element_size() + npix, brute_scan_flops(npix))
    for k in ("sharded_exact_ppermute", "sharded_exact_rdma", "exact_one_device", "sharded_brute_ppermute",
              "sharded_brute_rdma", "brute_one_device", "brute_scan_bytes_halo", "brute_scan_bytes_halo_plain"):
        log(f"time glyph {k}: {times[k]:.4f} ms")
    log(f"bound brute_scan_bytes_halo (shard 1 of 4): {bounds['brute_scan_bytes_halo'][0]:.4f} ms "
        f"({bounds['brute_scan_bytes_halo'][1]})")
    del ext

    # phase 25: JFA over both layouts, bit for bit, and real cards where present
    want = jfa.jfa_distance(corner)
    for label, m, x_axis in layouts:
        e = bits_err(sharded.sharded_jfa_distance(corner, m, x_axis=x_axis), want)
        log(f"check sharded jfa {label} 1024x1024: {e} values differ from one device")
        require(e == 0, f"sharded JFA {label} differs from jfa_distance")
    times["sharded_jfa_4"] = cuda_ms(lambda: sharded.sharded_jfa_distance(g, m4), 2, 3)
    log(f"time glyph sharded_jfa (4,) {SIZE}x{SIZE}: {times['sharded_jfa_4']:.4f} ms")

    n = torch.cuda.device_count()
    if n < 2:
        log(f"multi-card: not run ({n} CUDA device visible); the sharded tier ran on logical shards of one card")
    else:
        cards = make_mesh((n,))
        for name, b in masks.items():
            check_sharded(f"{name} over {n} cards", b, SPREAD, cards)
        img = torch.from_numpy(glyph).to(dev)
        for algorithm in ("exact", "brute", "jfa"):
            cfg = SdfConfig(spread=SPREAD, algorithm=algorithm)
            want = SDFGenerator(cfg, device=dev).generate(img)
            got = SDFGenerator(cfg, sharding=ShardingConfig((n,), ("y",), halo_impl="rdma"), device=dev).generate(img)
            log(f"check SDFGenerator {algorithm} over {n} cards rdma: equal {bool(torch.equal(got, want))}")
            require(torch.equal(got, want), f"SDFGenerator {algorithm} over {n} cards differs from one card")
        cli_out, _, _ = run_cli(glyph, ["-s", str(SPREAD), "--shard-y", str(n), "--halo-impl", "rdma"], "sharded")
        want = cuda_edt.fused_sdf_bytes(masks["glyph"], SPREAD).cpu().numpy().astype(np.int32)
        e = int(np.abs(cli_out.astype(np.int32) - want).max())
        log(f"main path sharded: CLI --shard-y {n} --halo-impl rdma max abs err vs one card {e}")
        require(e == 0, "the sharded CLI differs from one card")
    return err, launches, times, bounds


# ------------------------------------------------------- sharded soft phases

SOFT_ROWS_1B = 4000  # 1000-row shards over 4: not a multiple of 128, tier 1b
WIDE_T = 8.0  # tap radii 28 and 29: the wide-tap tier 1b (cols_conv)


def shard_slab(e: torch.Tensor, k: int, i: int, h: int) -> torch.Tensor:
    """Shard i's k-row halo'd slab (rows i h - k .. (i + 1) h + k, zero
    beyond the image) of a whole-image array: what the halo exchange gives
    that shard."""
    return torch.nn.functional.pad(e, (0, 0, k, k))[..., i * h : (i + 1) * h + 2 * k, :].contiguous()


def soft_rows_sums(gray: torch.Tensor, tau: float, t: float):
    """Tier 1b's pass-1 sums of both fields (the rows conv of the shifted
    occupancy), as parallel/sharded.py forms them."""
    k1, k2, c = soft_mxu.range_stats(SPREAD + 2, tau, t, U8)
    _, e_in, e_out = soft_mxu.occupancy(gray, tau, t, c, True)
    return [soft_mxu.conv_rows_sym(e, k1, t) for e in (e_in, e_out)], (k1, k2, c)


def band_conv_bounds(h: int, k: int, w: int = SIZE) -> dict:
    """Bounds of rows 17-19 for one launch on one shard: h output rows of a
    k-row halo'd slab, w columns, float32. Bytes: each operand read once,
    each output written once. Operations as FP32 issue slots (lane
    instructions): the sums must stay bit for bit the plain versions', so
    each tap and field is an unfused _rn multiply and an _rn add, two slots,
    plus the tails (22 a pixel) or their VJP (35). The 67 T/s rate counts an
    FMA, one slot, as two operations, so each slot counts as two of them."""
    hx, conv = h + 2 * k, 2 * (2 * k + 1)
    return {
        "p2_fused_fwd": bound(4 * w * (2 * hx + 3 * h), 2 * w * h * (2 * conv + 22)),
        "p2_fused_bwd": bound(4 * w * (3 * h + 2 * hx), 2 * w * (hx * 2 * conv + h * 35)),
        "cols_conv": bound(4 * w * (hx + h), 2 * w * h * conv),
    }


def band_conv_inputs(dev, u8, alpha, rng) -> dict:
    """Phase 26's inputs of rows 17-19: shard 1 of the 4000x4096 tier-1b
    image (``u8``, the noise) over 4, the 1020-row slabs of both pass-1
    sums (k2 10), a cotangent of its 1000 rows and the pair's arguments;
    shard 1 of the 4096² glyph's alpha (``alpha``) at T 8, the 1082-row
    slab of the in-field's pass-1 sums (k2 29) and a cotangent of its 1024
    rows. The cotangents come from ``rng``."""
    hb, h4 = SOFT_ROWS_1B // SHARDS, SIZE // SHARDS
    (a_in, a_out), (k1, k2, c) = soft_rows_sums(u8[:SOFT_ROWS_1B], TRAIN_TAU, TRAIN_T)
    s_in, s_out = shard_slab(a_in, k2, 1, hb), shard_slab(a_out, k2, 1, hb)
    del a_in, a_out
    ct = torch.from_numpy(rng.standard_normal((hb, SIZE)).astype(np.float32)).to(dev)
    (w_in, _), (_, wk2, _) = soft_rows_sums(alpha, TRAIN_TAU, WIDE_T)
    e = shard_slab(w_in, wk2, 1, h4)
    ctw = torch.from_numpy(rng.standard_normal((h4, SIZE)).astype(np.float32)).to(dev)
    return dict(s_in=s_in, s_out=s_out, ct=ct, p2=(k2, TRAIN_T, c, EPS), k1=k1, e=e, ctw=ctw, wk2=wk2)


def cols_library(name, stack, k, t, row_off, h_out) -> float:
    """A cols conv of a (n, H, W) stack as F.conv2d (cuDNN, TF32 off), the
    one PyTorch call that computes cols_conv's function and the two convs
    of p2_fused_fwd/bwd: the (2k + 1) x 1 taps (symmetric, so
    cross-correlation is the conv), k - row_off zero rows each side (0 to
    a halo'd slab's interior, 2k back onto it). ms, after a check against
    cols_conv_plain within 1e-5 of the scale (2k + 1 float32 terms summed in
    another order: (2k + 1) u = 3.5e-6 at k 29)."""
    taps = torch.tensor(soft_mxu.tap_weights(k, t), dtype=torch.float32, device=stack.device).view(1, 1, -1, 1)
    pad = k - row_off
    conv = lambda: torch.nn.functional.conv2d(stack.unsqueeze(1), taps, padding=(pad, 0)).squeeze(1)  # noqa: E731
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = band_conv.cols_conv_plain(stack, k, t, row_off, h_out)
        e_lib = float((conv() - want).abs().max()) / float(want.abs().max())
        ms = cuda_ms(conv)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    log(f"check {name}'s cols conv against F.conv2d (cuDNN, no TF32) on the {tuple(stack.shape)} stack, k {k}, "
        f"row_off {row_off}: max abs err {e_lib:.3e} of the scale {float(want.abs().max()):.4e}; F.conv2d "
        f"{ms:.4f} ms")
    require(e_lib <= 1e-5, f"{name}: the plain cols conv differs from F.conv2d")
    return ms


def band_conv_turn(dev, noise, glyph) -> None:
    """Rows 17-19 alone on phase 26's inputs (band_conv_inputs), on any tree
    that has these kernels (this one or its parent, for turns in one call):
    p2_fused_fwd with and without memos, p2_fused_bwd from the forward's
    memos, cols_conv to the slab's interior and back onto the slab; each
    timed with CUDA events (cuda_ms) and as a CUDA graph of back-to-back
    calls (graph_ms, out of the host's launch cost's reach), with the
    host's time a call (host_us) and a digest of its outputs."""
    u8 = torch.from_numpy(noise[..., 1].astype(np.float32)).to(dev)
    alpha = torch.from_numpy(glyph[..., 1].astype(np.float32)).to(dev)
    x = band_conv_inputs(dev, u8, alpha, np.random.default_rng(SEED + 26))
    s_in, s_out, p2, ct, e, ctw, wk2 = (x[k] for k in ("s_in", "s_out", "p2", "ct", "e", "ctw", "wk2"))
    _, d2i, d2o = band_conv.p2_fused_fwd(s_in, s_out, *p2)
    h4 = SIZE // SHARDS
    runs = {
        f"p2_fused_fwd k {p2[0]}": lambda: band_conv.p2_fused_fwd(s_in, s_out, *p2),
        f"p2_fused_fwd k {p2[0]} serving": lambda: band_conv.p2_fused_fwd(s_in, s_out, *p2, memos=False),
        f"p2_fused_bwd k {p2[0]}": lambda: band_conv.p2_fused_bwd(ct, d2i, d2o, *p2),
        f"cols_conv k {wk2}": lambda: band_conv.cols_conv(e, wk2, WIDE_T),
        f"cols_conv k {wk2} backward": lambda: band_conv.cols_conv(ctw, wk2, WIDE_T, -wk2, h4 + 2 * wk2),
    }
    for name, fn in runs.items():
        out = fn()
        dig = " ".join(digest(t) for t in (out if isinstance(out, tuple) else (out,)))
        log(f"time band {name}: {cuda_ms(fn):.4f} ms, graph {graph_ms(fn):.4f} ms, host {host_us(fn):.1f} us a "
            f"call; digest {dig}")


def bits_equal(name: str, got, want) -> int:
    """Elements that differ bit for bit between two (tuples of) tensors."""
    got, want = (got, want) if isinstance(got, (tuple, list)) else ((got,), (want,))
    n = 0
    for a, b in zip(got, want):
        require(a.shape == b.shape, f"{name}: shapes {tuple(a.shape)} and {tuple(b.shape)}")
        n += int((a.view(torch.int32) != b.view(torch.int32)).sum())
    return n


def soft_step(fn, g, ct=None):
    """The training step: the summed field (weighted by ``ct``), its
    gradient, an SGD update."""
    x = g.detach().requires_grad_()
    value = fn(x).sum() if ct is None else (fn(x) * ct).sum()
    value.backward()
    with torch.no_grad():
        return x - TRAIN_LR * x.grad, value.detach(), x.grad


def knee_cotangent(g: torch.Tensor, t: float) -> torch.Tensor:
    """The summed loss's cotangent (ones) zeroed at the sigmoid-knee outputs,
    where |d2| < 1e-3 in the single-device memos (ROADMAP Queue 3 item 1):
    there the gate 0.5 / sqrt(d2 + eps) turns last-ulp differences of the
    sums into percents of the gradient."""
    k1, k2, c = soft_mxu.range_stats(SPREAD + 2, TRAIN_TAU, t, U8)
    _, d2i, d2o = soft_mxu.soft_field_collapsed(g, k1, k2, c, TRAIN_TAU, t, EPS)
    return ((d2i.abs() >= 1e-3) & (d2o.abs() >= 1e-3)).to(torch.float32)


def reset_soft_launches():
    torch.cuda.synchronize()
    for counts in (cuda_soft_mm.LAUNCHES, band_conv.LAUNCHES, soft_fused.LAUNCHES, softmin.LAUNCHES,
                   cuda_halo.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_soft_launches() -> dict:
    torch.cuda.synchronize()
    return {k: v for counts in (cuda_soft_mm.LAUNCHES, band_conv.LAUNCHES, soft_fused.LAUNCHES, softmin.LAUNCHES,
                                cuda_halo.LAUNCHES) for k, v in counts.items() if v}


def sharded_soft_phases(dev, noise, glyph):
    """Phases 26-28. Returns (errors, launches, times, bounds)."""
    err = {"p2_fused_fwd": 0, "p2_fused_bwd": 0, "cols_conv": 0}
    rng = np.random.default_rng(SEED + 26)
    u8 = torch.from_numpy(noise[..., 1].astype(np.float32)).to(dev)
    alpha = torch.from_numpy(glyph[..., 1].astype(np.float32)).to(dev)
    pm = torch.from_numpy(pm_noise((SIZE, SIZE), SEED + 27)).to(dev)
    h4, hb = SIZE // SHARDS, SOFT_ROWS_1B // SHARDS
    times = {}

    # phase 26: rows 17-18 on shard 1 of the 4000x4096 tier-1b image, row 19
    # both ways on shard 1 of the 4096² glyph at T 8 (k2 = 29)
    x = band_conv_inputs(dev, u8, alpha, rng)
    s_in, s_out, p2_args, ct, k2 = x["s_in"], x["s_out"], x["p2"], x["ct"], x["p2"][0]
    k1, c = x["k1"], x["p2"][2]
    fwd = band_conv.p2_fused_fwd(s_in, s_out, *p2_args)
    err["p2_fused_fwd"] = bits_equal("p2_fused_fwd", fwd, band_conv.p2_fused_fwd_plain(s_in, s_out, *p2_args))
    bwd = band_conv.p2_fused_bwd(ct, fwd[1], fwd[2], *p2_args)
    err["p2_fused_bwd"] = bits_equal("p2_fused_bwd", bwd, band_conv.p2_fused_bwd_plain(ct, fwd[1], fwd[2], *p2_args))
    log(f"check p2_fused_fwd/bwd shard 1 of {SOFT_ROWS_1B}x{SIZE} over {SHARDS}, slab {tuple(s_in.shape)} k2 {k2}: "
        f"{err['p2_fused_fwd']} / {err['p2_fused_bwd']} values differ from the plain versions; "
        f"{int((fwd[1] >= 1e29).sum())} dead windows")
    # rows 17-19 with CUDA events (ms, as every row) and as CUDA graphs of
    # back-to-back calls (logged apart: their wrappers' host cost nears
    # their device time, and a graph leaves it out)
    runs = {"p2_fused_fwd": lambda: band_conv.p2_fused_fwd(s_in, s_out, *p2_args),
            "p2_fused_bwd": lambda: band_conv.p2_fused_bwd(ct, fwd[1], fwd[2], *p2_args)}
    for k, fn in runs.items():
        times[k], times[k + "_graph"] = cuda_ms(fn), graph_ms(fn)
    times["p2_fused_fwd_plain"] = cuda_ms(lambda: band_conv.p2_fused_fwd_plain(s_in, s_out, *p2_args))
    times["p2_fused_bwd_plain"] = cuda_ms(lambda: band_conv.p2_fused_bwd_plain(ct, fwd[1], fwd[2], *p2_args))
    # the library's form of the pair's two convs (no PyTorch call computes
    # the tails or their VJP around them): the pass-1 sums' stack to the
    # interior, the tails' VJP's stack back onto the slab
    t, eps = p2_args[1], p2_args[3]
    times["p2_fused_fwd_library"] = cols_library("p2_fused_fwd", torch.stack([s_in, s_out]), k2, t, k2, hb)
    ds = torch.stack(soft_mxu.tails_vjp(ct, fwd[1], fwd[2], t, c, eps))
    times["p2_fused_bwd_library"] = cols_library("p2_fused_bwd", ds, k2, t, -k2, hb + 2 * k2)
    bounds = {k: v for k, v in band_conv_bounds(hb, k2).items() if k != "cols_conv"}
    del s_in, s_out, fwd, bwd, ds

    e, ctw, wk2 = x["e"], x["ctw"], x["wk2"]
    e_f = bits_equal("cols_conv", band_conv.cols_conv(e, wk2, WIDE_T),
                     band_conv.cols_conv_plain(e, wk2, WIDE_T, wk2, h4))
    e_b = bits_equal("cols_conv", band_conv.cols_conv(ctw, wk2, WIDE_T, -wk2, h4 + 2 * wk2),
                     band_conv.cols_conv_plain(ctw, wk2, WIDE_T, -wk2, h4 + 2 * wk2))
    err["cols_conv"] = e_f + e_b
    log(f"check cols_conv shard 1 of {SIZE}x{SIZE} T {WIDE_T} k2 {wk2}, slab {tuple(e.shape)}: forward {e_f}, "
        f"backward {e_b} values differ from the plain version")
    fn = lambda: band_conv.cols_conv(e, wk2, WIDE_T)  # noqa: E731
    times["cols_conv"], times["cols_conv_graph"] = cuda_ms(fn), graph_ms(fn)
    times["cols_conv_plain"] = cuda_ms(lambda: band_conv.cols_conv_plain(e, wk2, WIDE_T, wk2, h4))
    times["cols_conv_library"] = cols_library("cols_conv", e.unsqueeze(0), wk2, WIDE_T, wk2, h4)
    bounds["cols_conv"] = band_conv_bounds(h4, wk2)["cols_conv"]
    del x, e, ctw
    for k in err:
        log(f"time {k} (one shard): {times[k]:.4f} ms (CUDA events; a CUDA graph of back-to-back calls "
            f"{times[k + '_graph']:.4f}), plain {times[k + '_plain']:.4f} ms, F.conv2d {times[k + '_library']:.4f} ms; "
            f"bound {bounds[k][0]:.4f} ms ({bounds[k][1]}), roofline share {100 * bounds[k][0] / times[k]:.1f}%")
    require(all(v == 0 for v in err.values()), "a cols-conv kernel differs from its plain version")

    # the declared kernels on halo'd blocks: shard 0 of (4,) (its top halo
    # beyond the image) and tile (0, 1) of (2, 2) (top and right beyond)
    half = SIZE // 2
    blocks = {
        "shard 0 of (4,)": (torch.nn.functional.pad(u8[: h4 + k2], (0, 0, k2, 0)), h4, (k2, h4 + 2 * k2, 0, SIZE)),
        "tile (0, 1) of (2, 2)": (torch.nn.functional.pad(u8[: half + k2, half - k1 :], (0, k1, k2, 0)), half,
                                  (k2, half + 2 * k2, 0, half + k1)),
    }
    for name, (gext, h, win) in blocks.items():
        gext = gext.contiguous()
        mm = (c, k1, k2, TRAIN_TAU, TRAIN_T, EPS)
        got = cuda_soft_mm.mm_fused_fwd(gext, *mm, row_off=k2, h_out=h, window=win)
        want = cuda_soft_mm.mm_fused_fwd_plain(gext, *mm, row_off=k2, h_out=h, window=win)
        dead = all(bool(torch.equal(a >= 1e29, b >= 1e29)) for a, b in zip(got[1:], want[1:]))
        live = (want[1] < 1e29) & (want[2] < 1e29)
        e_f = max(float((a - b).abs()[live].max()) for a, b in zip(got, want))
        ctx = torch.from_numpy(rng.standard_normal(tuple(gext.shape)).astype(np.float32)).to(dev)
        d2 = [torch.nn.functional.pad(m, (0, 0, k2, k2), value=1e30) for m in got[1:]]
        local = gext[k2 : k2 + h].contiguous()
        bwin = (0, h + 2 * k2) + win[2:]
        db = cuda_soft_mm.mm_fused_bwd(ctx, *d2, local, *mm, row_off=k2, window=bwin)
        dp = cuda_soft_mm.mm_fused_bwd_plain(ctx, *d2, local, *mm, row_off=k2, window=bwin)
        rel = float((db - dp).abs().max()) / float(dp.abs().max())
        log(f"check soft_mm_fwd/bwd on the halo'd {name} {tuple(gext.shape)} window {win}: forward err {e_f:.3e} "
            f"(dead windows equal: {dead}), backward {rel:.3e} of scale")
        require(dead and e_f <= 1e-4 and rel < 1e-4, f"soft_mm_fwd/bwd on the halo'd {name} differ from plain")
    # F1 and B1 with the live-row window of shard 0 in the adaptive 'window' form
    band = SPREAD + 2
    gext = torch.nn.functional.pad(pm[: h4 + band], (0, 0, band, 0)).contiguous()
    win = (band, h4 + 2 * band)
    s1 = soft_fused.f1_pass(gext, band, TRAIN_TAU, TRAIN_T, window=win)
    e1 = bits_equal("soft_f1", s1, soft_fused.f1_plain(gext, band, TRAIN_TAU, TRAIN_T, window=win))
    ds1 = torch.from_numpy(rng.standard_normal(tuple(s1.shape)).astype(np.float32)).to(dev)
    e2 = bits_equal("soft_b1", soft_fused.b1_pass(gext, s1, ds1, band, TRAIN_TAU, TRAIN_T, window=win),
                    soft_fused.b1_plain(gext, s1, ds1, band, TRAIN_TAU, TRAIN_T, window=win))
    log(f"check soft_f1/soft_b1 with the live rows {win} of {tuple(gext.shape)}: {e1} / {e2} values differ")
    require(e1 == 0 and e2 == 0 and bool((s1[..., :band, :] == 1e30).all()), "F1/B1 with a window differ")
    del gext, s1, ds1

    # phase 27: sharded soft steps against one device, both halo forms
    m4 = logical_mesh(dev, (SHARDS,))
    m22 = logical_mesh(dev, (2, 2), ("y", "x"))
    mdy = logical_mesh(dev, (2, 2), ("data", "y"))
    stack = torch.stack([u8[y : y + 1024, x : x + 1024] for y in (0, 1024) for x in (0, 1024, 2048, 3072)])
    sharded_kw = dict(tau=TRAIN_TAU, temperature=TRAIN_T, eps=EPS)
    mm1 = lambda x: cuda_soft_mm.soft_field_mm_fused(x, band, TRAIN_TAU, TRAIN_T, EPS)  # noqa: E731
    cases = [
        # (label, gray, mesh, keywords, one device, forward bitwise, gradient tolerance, kernels of the tier);
        # 1b's rows conv is a matrix product where one device sums taps one by one: its field within 1e-4 and
        # its gradient within 1e-4 of the scale by the knee rule (knee_cotangent)
        ("1a (4,)", u8, m4, dict(gray_range=U8), mm1, True, 0.0, ("soft_mm_fwd", "soft_mm_bwd")),
        ("1a (2, 2)", u8, m22, dict(gray_range=U8, x_axis="x"), mm1, True, 1e-6, ("soft_mm_fwd", "soft_mm_bwd")),
        ("1b (4,)", u8[:SOFT_ROWS_1B], m4, dict(gray_range=U8), mm1, False, 1e-4, ("p2_fused_fwd", "p2_fused_bwd")),
        ("wide (4,)", alpha, m4, dict(gray_range=U8, temperature=WIDE_T),
         lambda x: softsdf.soft_sdf_field(x, SPREAD, tau=TRAIN_TAU, temperature=WIDE_T, eps=EPS, gray_range=U8),
         False, 1e-4, ("cols_conv",)),
        ("2 window (4,)", pm, m4, {}, lambda x: soft_fused.soft_sdf_field_fused(x, band, TRAIN_TAU, TRAIN_T, EPS),
         True, 1e-6, ("soft_f1", "soft_f2", "soft_b2", "soft_b1")),
        ("2 split (4,)", pm, m4, dict(fused_impl="split"),
         lambda x: soft_fused.soft_sdf_field_fused(x, band, TRAIN_TAU, TRAIN_T, EPS), True, 1e-6,
         ("soft_f1", "soft_f2", "soft_b2", "soft_b1")),
        ("3 spread 128 (4,)", pm, m4, dict(spread=128),
         lambda x: softsdf.soft_field_cols(x, 130, TRAIN_TAU, TRAIN_T, EPS), True, 1e-6,
         ("softmin_col_fwd", "softmin_col_bwd")),
        ("1a (8, 1024, 1024) ('data', 'y')", stack, mdy, dict(gray_range=U8, batch_axis="data"), mm1, True, 0.0,
         ("soft_mm_fwd", "soft_mm_bwd")),
    ]
    # 1b's second witness: the same body over a (1,) mesh of the card, with
    # the same rows-conv products and no shard boundary
    witness = {"1b (4,)": logical_mesh(dev, (1,))}
    steps = {}
    for label, g, m, kw, single, bitwise, gtol, kernels in cases:
        kw = {**sharded_kw, **kw}
        spread = kw.pop("spread", SPREAD)
        new1, v1, g1 = soft_step(single, g)
        knee = None if bitwise else knee_cotangent(g, kw["temperature"])
        if knee is not None:
            gk1 = soft_step(single, g, knee)[2]
        if label in witness:
            fw = functools.partial(sharded.sharded_soft_sdf_field, spread=spread, mesh=witness[label], **kw)
            field_w, (_, _, g_w), gk_w = fw(g), soft_step(fw, g), soft_step(fw, g, knee)[2]
        for impl in ("ppermute", "rdma"):
            fn = functools.partial(sharded.sharded_soft_sdf_field, spread=spread, mesh=m, halo=impl, **kw)
            reset_soft_launches()
            new, value, grad = soft_step(fn, g)
            counts = read_soft_launches()
            field = fn(g)
            f_err = float((field - single(g)).abs().max())
            g_err = float((grad - g1).abs().max()) / float(g1.abs().max())
            u_err = float((new - new1).abs().max())
            k_err = g_err
            if knee is not None:
                gk = soft_step(fn, g, knee)[2]
                k_err = float((gk - gk1).abs().max()) / float(gk1.abs().max())
            log(f"check sharded soft step {label} {tuple(g.shape)} {impl}: field max abs err {f_err:.3e}, gradient "
                f"{g_err:.3e} of scale ({k_err:.3e} by the knee rule, {0 if knee is None else int((knee == 0).sum())} "
                f"knee outputs), update {u_err:.3e}, loss {float(value):.6e} vs {float(v1):.6e}; launches {counts}")
            require((f_err == 0.0) if bitwise else f_err <= 1e-4, f"sharded soft {label} {impl}: field")
            require(k_err <= gtol and bool(torch.isfinite(new).all()), f"sharded soft {label} {impl}: gradient")
            if label in witness:
                w_f = float((field - field_w).abs().max())
                w_g = float((grad - g_w).abs().max()) / float(g_w.abs().max())
                w_k = float((gk - gk_w).abs().max()) / float(gk_w.abs().max())
                log(f"check sharded soft step {label} {impl} against the (1,) mesh: field max abs err {w_f:.3e}, "
                    f"gradient {w_g:.3e} of scale ({w_k:.3e} by the knee rule)")
                require(w_f <= 1e-4 and max(w_g, w_k) <= 1e-6, f"sharded soft {label} {impl}: the (1,) mesh witness")
            require(all(counts.get(k, 0) > 0 for k in kernels), f"sharded soft {label} {impl}: tier kernels {kernels}")
            require((counts.get("halo_slab", 0) + counts.get("halo_ring_shift", 0) > 0) == (impl == "rdma"),
                    f"sharded soft {label} {impl}: halo kernels")
            # 1a over one chain: one exchange forward, one for the cotangent and both memos backward
            require(label != "1a (4,)" or impl != "rdma" or counts.get("halo_slab") == 2,
                    "sharded soft 1a (4,) rdma: other than two halo_slab launches a step")
            steps[(label, impl)] = (fn, g)
        steps[(label, "one device")] = (single, g)
        del new1, g1, new, grad, knee

    # the main path's launches: one 1b step and one wide-tap step under rdma
    reset_soft_launches()
    for label in ("1b (4,)", "wide (4,)"):
        fn, g = steps[(label, "rdma")]
        soft_step(fn, g)
    launches = read_soft_launches()
    log(f"main path sharded soft rdma (1b and wide-tap steps): launches {launches}")
    for k in err:
        require(launches.get(k, 0) > 0, f"kernel {k} was not launched on the sharded soft main path")
    launches = {k: launches.get(k, 0) for k in err}

    for (label, impl), (fn, g) in steps.items():
        key = f"sharded_soft_step {label} {impl}"
        times[key] = cuda_ms(lambda: soft_step(fn, g))
        log(f"time {key}: {times[key]:.4f} ms")
    for label in dict.fromkeys(label for label, _ in steps):
        pp, rd = times[f"sharded_soft_step {label} ppermute"], times[f"sharded_soft_step {label} rdma"]
        log(f"time sharded soft step {label}: rdma {rd:.4f} ms beside ppermute {pp:.4f} ms ({rd / pp:.3f}x), "
            f"one device {times[f'sharded_soft_step {label} one device']:.4f} ms")
    profile_device("sharded soft step 1a (4,) rdma", lambda: soft_step(*steps[("1a (4,)", "rdma")]))
    profile_device("sharded soft step 1b (4,) rdma", lambda: soft_step(*steps[("1b (4,)", "rdma")]))
    del steps, stack

    # phase 28: the entry points. On a card a ShardingConfig spans distinct
    # cards (as a JAX mesh spans chips): with fewer than 4, SDFGenerator and
    # the CLI run over the cards there are (phase 27 holds the same tier over
    # 4 logical shards)
    n_cards = torch.cuda.device_count()
    n_run = SHARDS if n_cards >= SHARDS else n_cards
    img = torch.from_numpy(glyph).to(dev)
    soft = SoftConfig(tau=TRAIN_TAU, temperature=TRAIN_T)
    one = SDFGenerator(SdfConfig(spread=SPREAD), soft=soft, device=dev)
    gen = SDFGenerator(SdfConfig(spread=SPREAD), soft=soft, device=dev,
                       sharding=ShardingConfig((n_run,), ("y",), halo_impl="rdma"))
    reset_soft_launches()
    e_bytes = max_abs_err(gen.generate(img), one.generate(img))
    counts = read_soft_launches()
    e_field = float((gen.generate_field(img) - one.generate_field(img)).abs().max())
    log(f"main path sharded soft: SDFGenerator(soft, sharding ({n_run},) rdma) over {n_run} card(s), glyph: bytes "
        f"max abs err {e_bytes}, field {e_field:.3e} vs one device; launches {counts}")
    require(e_bytes == 0 and e_field == 0.0, "the sharded soft SDFGenerator differs from one device")
    times["sharded_soft_generate"] = cuda_ms(lambda: gen.generate(img))
    log(f"time sharded soft generate over {n_run} card(s): {times['sharded_soft_generate']:.4f} ms")
    times["soft_generate_one_device"] = cuda_ms(lambda: one.generate(img))
    log(f"time soft generate one device: {times['soft_generate_one_device']:.4f} ms")

    img_pm = torch.from_numpy(np.stack([pm_noise((SIZE, SIZE), SEED + 28), pm_noise((SIZE, SIZE), SEED + 29)], -1))
    img_pm = img_pm.to(dev)
    target = torch.zeros((SIZE, SIZE), device=dev)
    runs = []
    for model in (SoftSDFModel(SPREAD, soft, mesh=m4), SoftSDFModel(SPREAD, soft, device=dev)):
        opt = create_train_state(model, lr=ADAM_LR)
        step = make_train_step(model, opt)
        losses = [float(step(img_pm, target))]
        grads = [p.grad.detach().clone() for p in model.parameters()]  # the first step's
        losses += [float(step(img_pm, target)) for _ in range(2)]
        runs.append((losses, grads, [p.detach().clone() for p in model.parameters()]))
        times[f"soft_model_step_{'sharded' if model.mesh is not None else 'one_device'}"] = cuda_ms(
            lambda: step(img_pm, target), 2, 3)
    (l4, g4, p4), (l1, g1, p1) = runs
    e_l = max(abs(a - b) / abs(b) for a, b in zip(l4, l1))
    e_g = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(g4, g1))
    e_p = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1.0) for a, b in zip(p4, p1))
    log(f"main path sharded soft: SoftSDFModel(mesh (4,)) 3 Adam steps, losses {l4} vs one device {l1} (within "
        f"{e_l:.3e} relative); first step's parameter gradients within {e_g:.3e} of their scale; parameters within "
        f"{e_p:.3e}; step {times['soft_model_step_sharded']:.4f} ms, one device "
        f"{times['soft_model_step_one_device']:.4f} ms")
    # the adaptive tier ('window'): phase 27's gradient tolerance, 1e-6 of the scale
    require(e_l <= 1e-6 and e_g <= 1e-6 and e_p <= 1e-5 and all(math.isfinite(v) for v in l4),
            "SoftSDFModel(mesh) differs from one device")
    del img_pm

    cli_out, cli_log, _ = run_cli(glyph, ["--soft", "-s", str(SPREAD), "--shard-y", str(n_run), "--halo-impl",
                                          "rdma"], "soft sharded")
    want = SDFGenerator(SdfConfig(spread=SPREAD), soft=SoftConfig(), device=dev).generate(img).cpu().numpy()
    e = int(np.abs(cli_out.astype(np.int32) - want.astype(np.int32)).max())
    cli_launches = json.loads(next(l for l in cli_log if "kernel launches" in l).split("launches ", 1)[1])
    log(f"main path sharded soft: CLI --soft --shard-y {n_run} --halo-impl rdma glyph ({n_cards} card(s)): max abs "
        f"err {e} vs one device; launches soft_mm_fwd {cli_launches['soft_mm_fwd']}, halo_slab "
        f"{cli_launches['halo_slab']}")
    require(e == 0 and cli_launches["soft_mm_fwd"] > 0 and (n_run == 1 or cli_launches["halo_slab"] > 0),
            "the sharded soft CLI differs from one device or skipped its kernels")
    return err, launches, times, bounds


# ------------------------------------------------------------- atlas phases

ATLAS_SPREADS = (8, 64, 128, 300)  # the sweep: band 304, uint16 strips for every spread


# one traced atlas call on the glyph pages, in a process of its own: python -c TRACE_CHILD <dir>
TRACE_CHILD = """
import sys
import torch
import chip_smoke as cs
from chaq_sdfgen_tpu_torch.models.atlas import atlas_sdf
from chaq_sdfgen_tpu_torch.utils import profiling
x = torch.from_numpy(cs.atlas_pages(cs.glyph_image(cs.SIZE, cs.SEED + 1))).to("cuda")
atlas_sdf(x)
with profiling.kernel_timer("atlas 4x4096 traced in a fresh process"):
    with profiling.device_trace(sys.argv[1]):
        atlas_sdf(x)
"""


def atlas_pages(glyph: np.ndarray) -> np.ndarray:
    """(4, 4096, 4096, 2): the glyph page turned and mirrored, four distinct
    atlas pages (BASELINE config 5's 4K shape)."""
    return np.ascontiguousarray(np.stack([glyph, np.rot90(glyph), glyph[::-1], glyph[:, ::-1]]))


def bench_glyphs() -> np.ndarray:
    """(8, 1024, 1024, 2): the JAX bench's atlas stack (bench.py:263-271),
    six filled ellipses and a bar a glyph, in alpha."""
    glyphs = np.zeros((8, 1024, 1024), dtype=bool)
    yy, xx = np.mgrid[0:1024, 0:1024]
    for gi in range(8):
        grng = np.random.default_rng(gi)
        for _ in range(6):
            cy, cx = grng.integers(128, 896, 2)
            ry, rx = grng.integers(30, 160, 2)
            glyphs[gi] |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        x0, w0 = grng.integers(100, 800), grng.integers(40, 90)
        glyphs[gi][:, x0 : x0 + w0] = True
    return np.stack([np.zeros(glyphs.shape, np.uint8), glyphs.astype(np.uint8) * 255], -1)


def check_passes(label: str, b: torch.Tensor, spread: int, band: int) -> None:
    """Both EXACT kernels on a stack's mask against their plain versions,
    byte for byte (checks: not counted as main-path launches)."""
    din, dout = cuda_edt.row_distances_u8(b, band)
    pin, pout = cuda_edt.row_distances_u8_plain(b, band)
    e1 = max(max_abs_err(din, pin), max_abs_err(dout, pout))
    got = cuda_edt.fused_pass2_bytes(din, dout, spread, False, band)
    e2 = max_abs_err(got, cuda_edt.fused_pass2_bytes_plain(pin, pout, spread, False, band))
    log(f"check atlas {label} {tuple(b.shape)} {din.dtype} band {band} spread {spread}: edt_rows err {e1}, "
        f"edt_band_bytes err {e2}")
    require(e1 == 0 and e2 == 0, f"an EXACT kernel disagrees with its plain version on the atlas {label}")


def atlas_phases(dev, glyph):
    """Phases 29-31. Every kernel of these paths is a row of the hard path,
    so they add no row to the kernels line: an empty path."""
    cfg = SdfConfig(spread=SPREAD)
    gen = SDFGenerator(cfg, device=dev)
    stacks = {"4x4096": torch.from_numpy(atlas_pages(glyph)).to(dev),
              "8x1024": torch.from_numpy(bench_glyphs()).to(dev)}
    # phase 29: the atlas at full width, one launch of each kernel a call
    outs = {}
    for label, x in stacks.items():
        n, npix = x.shape[0], x[..., 0].numel()
        reset_launches()
        out = atlas_sdf(x, cfg)
        c = read_launches()
        log(f"main path atlas {label}: launches { {k: v for k, v in c.items() if v} }")
        require(c["edt_rows"] == 1 and c["edt_band_bytes"] == 1 and sum(c.values()) == 2,
                f"atlas {label} did not run one edt_rows and one edt_band_bytes launch")
        require(out.shape == x.shape[:-1] and out.dtype == torch.uint8 and out.device == x.device,
                f"atlas {label} output {tuple(out.shape)} {out.dtype} {out.device}")
        bad = [i for i in range(n) if not torch.equal(out[i], gen.generate(x[i]))]
        log(f"check atlas {label}: images differing from per-image SDFGenerator.generate: {bad}")
        require(not bad, f"atlas {label} differs from per-image generate")
        check_passes(label, threshold.hard_threshold(x), SPREAD, SPREAD + 2)
        ms = cuda_ms(lambda: atlas_sdf(x, cfg))
        best = profiling.time_compiled(atlas_sdf, x, cfg, iters=5) * 1e3
        per_image = cuda_ms(lambda: [gen.generate(x[i]) for i in range(n)])
        log(f"time atlas {label} spread {SPREAD}: {ms:.4f} ms ({npix / ms / 1e6:.3f} Gpix/s; time_compiled best "
            f"of 5 {best:.4f} ms); per-image generate {per_image:.4f} ms ({npix / per_image / 1e6:.3f} Gpix/s)")
        outs[label] = out

    # phase 30: the atlas over a ('data', 'y') mesh of logical shards; the sweep
    x, want = stacks["4x4096"], outs["4x4096"]
    mesh = global_mesh(y_per_host=2, devices=[dev] * 4)
    require(mesh.shape == {"data": 2, "y": 2}, f"global_mesh shape {mesh.shape}")
    reset_launches()
    got = atlas_sdf(x, cfg, mesh=mesh)
    c = read_launches()
    e = max_abs_err(got, want)
    log(f"check atlas 4x4096 over {mesh.shape}: max abs err vs one device {e}, launches "
        f"{ {k: v for k, v in c.items() if v} }")
    require(e == 0 and c["edt_rows"] == 4 and c["edt_band_bytes"] == 4,
            "the atlas over the mesh differs from one device or skipped its kernels")
    ms = cuda_ms(lambda: atlas_sdf(x, cfg, mesh=mesh))
    log(f"time atlas 4x4096 over {mesh.shape}: {ms:.4f} ms ({x[..., 0].numel() / ms / 1e6:.3f} Gpix/s)")

    reset_launches()
    sweep = atlas_sdf_spread_sweep(x, ATLAS_SPREADS)
    c = read_launches()
    log(f"main path atlas sweep {ATLAS_SPREADS} (band {sweep_band(ATLAS_SPREADS)}): launches "
        f"{ {k: v for k, v in c.items() if v} }")
    n_s = len(ATLAS_SPREADS)
    require(c["edt_rows"] == 1 and c["edt_rows_u16"] == 1 and c["edt_band_bytes"] == n_s
            and c["edt_band_bytes_u16"] == n_s, "the sweep did not run 1 + 4 uint16 launches")
    per_spread = [lambda s=s: atlas_sdf(x, SdfConfig(spread=s)) for s in ATLAS_SPREADS]
    bad = [s for s, one, f in zip(ATLAS_SPREADS, sweep, per_spread) if not torch.equal(one, f())]
    log(f"check atlas sweep: spreads differing from per-spread atlas_sdf: {bad}")
    require(sweep.shape == (n_s,) + want.shape and not bad, "the sweep differs from per-spread atlas_sdf")
    check_passes("sweep", threshold.hard_threshold(x), max(ATLAS_SPREADS), sweep_band(ATLAS_SPREADS))
    din, dout = cuda_edt.row_distances_u8(threshold.hard_threshold(x), sweep_band(ATLAS_SPREADS))
    e = max_abs_err(cuda_edt.fused_pass2_bytes(din, dout, 64, False, 66),
                    cuda_edt.fused_pass2_bytes_plain(din, dout, 64, False, 66))
    log(f"check atlas sweep: uint16 strips at band {sweep_band(ATLAS_SPREADS)}, pass 2 at band 66: "
        f"edt_band_bytes err {e}")
    require(e == 0, "pass 2 on the sweep's wider strips disagrees with its plain version")
    band = sweep_band(ATLAS_SPREADS)
    b = threshold.hard_threshold(x)

    def shared_band():
        # JAX's form: every level's pass 2 at the shared band
        din, dout = cuda_edt.row_distances_u8(b, band)
        return [cuda_edt.fused_pass2_bytes(din, dout, s, False, band) for s in ATLAS_SPREADS]

    require(all(torch.equal(u, v) for u, v in zip(shared_band(), sweep)), "the shared-band form differs")
    ms = cuda_ms(lambda: atlas_sdf_spread_sweep(x, ATLAS_SPREADS), 3, 3)
    each = cuda_ms(lambda: [f() for f in per_spread], 3, 3)
    shared = cuda_ms(shared_band, 3, 3)
    log(f"time atlas sweep 4x4096 {ATLAS_SPREADS}: {ms:.4f} ms; per-spread atlas_sdf {each:.4f} ms; every "
        f"level at the shared band {band} {shared:.4f} ms")

    # phase 31: checkpoint and resume on the card; a trace of one atlas call
    img = torch.from_numpy(glyph[:1024, :1024]).to(dev).to(torch.float32)
    d_in, d_out = edt.dual_edt_banded(img[..., 1] > 127, SPREAD + 2)
    target = merge.signed_merge(d_out, d_in)

    def trainer():
        model = SoftSDFModel(SPREAD, SoftConfig(tau=TRAIN_TAU, temperature=TRAIN_T), device=dev)
        opt = create_train_state(model, img, lr=ADAM_LR)
        return model, opt, make_train_step(model, opt)

    model, opt, train = trainer()
    losses = [float(train(img, target)) for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.pt")
        checkpoint.save_train_state(path, model, opt, step=2)
        loss3 = train(img, target)
        model2, opt2, train2 = trainer()
        params, opt_state, step = checkpoint.restore_train_state(path, like_params=model2, like_opt=opt2)
        model2.load_state_dict(params)
        opt2.load_state_dict(opt_state)
        resumed = train2(img, target)
        same = (step == 2 and torch.equal(resumed, loss3)
                and all(torch.equal(a, b) for a, b in zip(model2.parameters(), model.parameters()))
                and all(torch.equal(opt2.state[a][k], opt.state[b][k]) for a, b in
                        zip(model2.parameters(), model.parameters()) for k in ("step", "exp_avg", "exp_avg_sq")))
        log(f"check checkpoint: SoftSDFModel (1024, 1024) losses {losses + [float(loss3)]}, the resumed third "
            f"step {'bit for bit' if same else 'DIFFERS from'} the uninterrupted one")
        require(same, "a restored train state does not step like the uninterrupted one")

        # in this process, after phases 3-28, torch.profiler loses a session's first kernel
        # records (PERF.md §7): logged here; the check runs in a fresh process
        for label, run in (("this process", None), ("a fresh process", TRACE_CHILD)):
            trace_dir = os.path.join(tmp, label.replace(" ", "_"))
            if run is None:
                with profiling.kernel_timer(f"atlas 4x4096 traced in {label}", emit=log):
                    with profiling.device_trace(trace_dir):
                        atlas_sdf(x, cfg)
            else:
                res = subprocess.run([sys.executable, "-c", run, trace_dir], cwd=ROOT, capture_output=True,
                                     text=True, timeout=300)
                require(res.returncode == 0, f"the traced atlas call failed: {res.stderr[-2000:]}")
                log(res.stdout.strip())
            files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
            require(len(files) == 1, f"device_trace wrote {files}")
            with open(os.path.join(trace_dir, files[0])) as f:
                events = json.load(f)["traceEvents"]
            kernels = {}
            for e in events:
                if e.get("cat") == "kernel":
                    kernels[e["name"]] = kernels.get(e["name"], 0.0) + e.get("dur", 0.0)
            log(f"check device_trace in {label}: kernel events (us) "
                f"{ {n[:60]: round(us, 1) for n, us in kernels.items()} }")
        require(any("edt_rows" in n for n in kernels) and any("edt_band_staged" in n for n in kernels),
                "the trace of an atlas call names no edt_rows or edt_band_staged kernel")
    return {}, {}, {}, {}



# ------------------------------------------------------------- multi-host phase

DCN_PROCS = 2  # worker processes, each a "host"
DCN_SHARDS = 2  # logical shards of the card a worker drives
DCN_TIMEOUT = 420  # seconds the parent waits for both workers


def dcn_batch(dev) -> tuple:
    """Phase 32's training batch, (2, 4096, 4096, 2) in +-2000 (phase 28's
    input, two images), and a zero target, on ``dev``."""
    x = np.stack([np.stack([pm_noise((SIZE, SIZE), SEED + 32 + 2 * i), pm_noise((SIZE, SIZE), SEED + 33 + 2 * i)],
                           -1) for i in range(2)])
    return torch.from_numpy(x).to(dev), torch.zeros((2, SIZE, SIZE), device=dev)


def dcn_steps(model, batch, target) -> tuple:
    """2 Adam steps: (losses, the first step's parameter gradients, the
    parameters after both and the launches of the adaptive kernels; the
    step function)."""
    step = make_train_step(model, create_train_state(model, lr=ADAM_LR))
    reset_soft_launches()
    losses = [float(step(batch, target))]
    grads = [p.grad.detach().cpu().reshape(-1).tolist() for p in model.parameters()]
    losses.append(float(step(batch, target)))
    launches = read_soft_launches()
    params = [p.detach().cpu().reshape(-1).tolist() for p in model.parameters()]
    return dict(losses=losses, grads=grads, params=params, launches=launches), step


def dcn_worker(pid: int, port: str, tmp: str) -> int:
    """One process of phase 32: joins the run over gloo, computes its own
    pages and rows, checks the pages against per-image generate and the
    kernels' launches, writes its results to worker<pid>.json."""
    initialize(f"127.0.0.1:{port}", DCN_PROCS, pid, backend="gloo")
    dist = torch.distributed
    require(dist.get_backend() == "gloo" and dist.get_rank() == pid, "the run did not form over gloo")
    dev = torch.device("cuda", 0)
    cfg = SdfConfig(spread=SPREAD)
    gen = SDFGenerator(cfg, device=dev)
    pages = torch.from_numpy(atlas_pages(glyph_image(SIZE, SEED + 1))).to(dev)
    res = {}
    for y in (DCN_SHARDS, 1):
        mesh = global_mesh(y_per_host=y, devices=[dev] * DCN_SHARDS)
        reset_launches()
        out = atlas_sdf(pages, cfg, mesh=mesh)
        c = {k: v for k, v in read_launches().items() if v}
        rows = local_index(pages.shape[:-1], mesh, ("data", "y", None))[0]
        bad = [i for i in range(rows.start, rows.stop) if not torch.equal(out[i - rows.start], gen.generate(pages[i]))]
        log(f"worker {pid}: atlas over {mesh.shape} (processes {mesh.processes.tolist()}): pages {rows.start}-"
            f"{rows.stop - 1}, {tuple(out.shape)}; differing from per-image generate: {bad}; launches {c}")
        require(out.shape == (rows.stop - rows.start,) + tuple(pages.shape[1:3]) and not bad,
                f"worker {pid}: the atlas over {mesh.shape} differs from per-image generate")
        require(c == {"edt_rows": DCN_SHARDS, "edt_band_bytes": DCN_SHARDS},
                f"worker {pid}: the atlas over {mesh.shape} launched {c}")
        # alone (the other process waits at the barrier), then both at once
        times = {}
        for turn in range(DCN_PROCS):
            dist.barrier()
            if turn == pid:
                times["alone"] = cuda_ms(lambda: atlas_sdf(pages, cfg, mesh=mesh))
            torch.cuda.synchronize()
        dist.barrier()
        times["together"] = cuda_ms(lambda: atlas_sdf(pages, cfg, mesh=mesh))
        res[f"atlas_y{y}"] = dict(rows=[rows.start, rows.stop], launches=c, **times)
    del pages, out

    batch, target = dcn_batch(dev)
    mesh = global_mesh(y_per_host=DCN_SHARDS, devices=[dev] * DCN_SHARDS)
    model = SoftSDFModel(SPREAD, SoftConfig(tau=TRAIN_TAU, temperature=TRAIN_T), mesh=mesh, batch_axis="data")
    run, step = dcn_steps(model, batch, target)
    log(f"worker {pid}: SoftSDFModel over {mesh.shape}: rows {model.own_rows(target.shape)[0]}, losses "
        f"{run['losses']}, launches {run['launches']}")
    require(all(run["launches"].get(k, 0) > 0 for k in ("soft_f1", "soft_f2", "soft_b2", "soft_b1")),
            f"worker {pid}: the step did not launch the four adaptive kernels: {run['launches']}")
    dist.barrier()
    run["step_ms"] = cuda_ms(lambda: step(batch, target), 2, 3)
    buf = torch.zeros(5, device=dev)
    run["all_reduce_host_us"] = host_us(lambda: dist.all_reduce(buf))
    cpu_buf = torch.zeros(5)
    run["all_reduce_cpu_host_us"] = host_us(lambda: dist.all_reduce(cpu_buf))
    res["model"] = run
    with open(os.path.join(tmp, f"worker{pid}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    log(f"DCN_OK p{pid}")
    return 0


def dcn_phases(dev, glyph):
    """Phase 32 (the parent). Its kernels are rows of the hard and adaptive
    paths, so it adds no row to the kernels line: an empty path."""
    cfg = SdfConfig(spread=SPREAD)
    pages = torch.from_numpy(atlas_pages(glyph)).to(dev)
    one_ms = cuda_ms(lambda: atlas_sdf(pages, cfg))
    logical = global_mesh(y_per_host=2, devices=[dev] * 4)
    mesh_ms = cuda_ms(lambda: atlas_sdf(pages, cfg, mesh=logical))
    log(f"time atlas 4x4096 in one process: one device {one_ms:.4f} ms, over {logical.shape} {mesh_ms:.4f} ms")
    del pages

    # the one-process reference: the same steps over a (2, 2) logical mesh
    batch, target = dcn_batch(dev)
    model = SoftSDFModel(SPREAD, SoftConfig(tau=TRAIN_TAU, temperature=TRAIN_T),
                         mesh=logical_mesh(dev, (2, 2), ("data", "y")), batch_axis="data")
    ref, step = dcn_steps(model, batch, target)
    ref_ms = cuda_ms(lambda: step(batch, target), 2, 3)
    log(f"main path multi-host reference: SoftSDFModel over (2, 2) logical shards, losses {ref['losses']}, "
        f"step {ref_ms:.4f} ms")
    del model, batch, target, step
    torch.cuda.empty_cache()

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"worker{pid}.log"), "w+") for pid in range(DCN_PROCS)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--dcn-worker", str(pid),
                                   str(port), tmp], cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, text=True)
                 for pid, f in enumerate(logs)]
        try:
            for p in procs:
                p.wait(timeout=max(DCN_TIMEOUT - (time.perf_counter() - t0), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
        for pid, (p, out) in enumerate(zip(procs, outs)):
            for line in out.strip().splitlines()[-40:]:
                log(f"  [{pid}] {line}")
            require(p.returncode == 0 and f"DCN_OK p{pid}" in out,
                    f"phase 32 worker {pid} exited {p.returncode} without its OK line")
        res = []
        for pid in range(DCN_PROCS):
            with open(os.path.join(tmp, f"worker{pid}.json")) as f:
                res.append(json.load(f))
    log(f"phase 32: both workers exited 0 in {wall:.1f} s wall")

    for pid, r in enumerate(res):
        for y in (DCN_SHARDS, 1):
            a = r[f"atlas_y{y}"]
            log(f"time atlas 2 of 4 pages in worker {pid}, global_mesh(y_per_host={y}): alone {a['alone']:.4f} ms, "
                f"with the other worker at work {a['together']:.4f} ms (one process, 4 pages: {one_ms:.4f})")
        m = r["model"]
        e_l = max(abs(a - b) / abs(b) for a, b in zip(m["losses"], ref["losses"]))
        e_g = max(float(np.abs(np.subtract(a, b)).max()) / float(np.abs(b).max())
                  for a, b in zip(m["grads"], ref["grads"]))
        e_p = max(float(np.abs(np.subtract(a, b)).max()) / max(float(np.abs(b).max()), 1.0)
                  for a, b in zip(m["params"], ref["params"]))
        log(f"main path multi-host: worker {pid} SoftSDFModel 2 Adam steps, losses {m['losses']} (within {e_l:.3e} "
            f"relative of one process), first step's gradients within {e_g:.3e} of their scale, parameters within "
            f"{e_p:.3e}; launches {m['launches']}; step {m['step_ms']:.4f} ms (one process over (2, 2) "
            f"{ref_ms:.4f}); all_reduce of the 5 floats {m['all_reduce_host_us']:.1f} us host time a call (a "
            f"CPU tensor {m['all_reduce_cpu_host_us']:.1f})")
        require(e_l <= 1e-6 and e_g <= 1e-6 and e_p <= 1e-5 and all(math.isfinite(v) for v in m["losses"]),
                f"worker {pid}'s steps differ from one process")
    require(res[0]["model"]["params"] == res[1]["model"]["params"], "the workers' parameters differ")
    return {}, {}, {}, {}


def summary(*paths) -> dict:
    """The kernels' JSON line from each path's (errors, launches, times,
    bounds). library_ms is the time of the halo kernels' Tensor.to form, of
    cols_conv's F.conv2d and of the two convs of the declared kernels and
    of p2_fused_fwd/bwd as F.conv2d (convs only); no PyTorch call computes
    any other kernel's function (null)."""
    rows = []
    for k, spec in KERNELS.items():
        err, launches, times, bounds = next(p for p in paths if k in p[0])
        rows.append(dict(
            name=k, **spec, launches=launches[k], max_abs_err=err[k], ms=times[k],
            plain_ms=times[f"{k}_plain"], bound_ms=bounds[k][0], bound_by=bounds[k][1],
            library_ms=times.get(f"{k}_library"),
        ))
    return {"kernels": rows}


def main() -> int:
    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dcn-worker"]:
        return dcn_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    smi = nvidia_smi()
    log(f"card: {smi}")
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # phase 2: build
    t0 = time.perf_counter()
    _build.load()
    log(f"build: kernels {_build.BUILD_INFO['seconds']:.2f} s -> {os.path.relpath(_build.BUILD_INFO['path'], ROOT)}")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log(f"  ptxas: {line.split(':', 1)[-1].strip()}")
    t1 = time.perf_counter()
    require(sdfio_native.available(), "native/sdfio codec did not build")
    log(f"build: native/sdfio {time.perf_counter() - t1:.2f} s; total {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", "import chaq_sdfgen_tpu_torch"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    require(res.returncode == 0, f"import failed: {res.stderr[-2000:]}")
    log(f"python start + import chaq_sdfgen_tpu_torch {time.perf_counter() - t0:.2f} s wall")

    noise = noise_image(SIZE, SEED)
    glyph = glyph_image(SIZE, SEED + 1)
    if sys.argv[1:] == ["--composed-turn"]:
        composed_turn(dev, glyph)
        return 0
    if sys.argv[1:] == ["--kernel-turn"]:
        kernel_turn(dev, noise, glyph)
        return 0
    if sys.argv[1:] == ["--atlas-turn"]:
        atlas_phases(dev, glyph)
        return 0
    if sys.argv[1:] == ["--dcn-turn"]:
        dcn_phases(dev, glyph)
        return 0
    paths = []
    for label, phases, args in (("3-7", hard_phases, (noise, glyph)), ("8-11", soft_phases, (glyph,)),
                                ("12-15", fused_phases, (glyph,)), ("16-19", brute_dist_phases, (noise, glyph)),
                                ("20-22", composed_phases, (glyph,)), ("23-25", sharded_phases, (noise, glyph)),
                                ("26-28", sharded_soft_phases, (noise, glyph)), ("29-31", atlas_phases, (glyph,)),
                                ("32", dcn_phases, (glyph,))):
        t0 = time.perf_counter()
        paths.append(phases(dev, *args))
        log(f"phases {label}: {time.perf_counter() - t0:.1f} s")
    kernels = summary(*paths)
    print(smi, flush=True)
    print(json.dumps(kernels))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
