"""Banded separable exact EDT, plain PyTorch (chaq_sdfgen_tpu/ops/edt.py).

The reference's output is clamped to [-spread, +spread] by the byte remap
(openmp/sdfgen.c:75-96), so only distances <= spread + 1 are observable:

  pass 1 (rows, binary seeds): d1(x) = distance to the nearest seed in the
      row, from two cumulative-max scans over seed indices;
  pass 2 (columns, banded):    D(y, x) = min_{|dy| <= B} dy^2 + d1^2(y+dy, x).

For any pixel whose true distance d <= B the result is exactly d^2; anything
farther saturates above B^2 and clamps to the reference's byte. All values
are small exact integers in float32, so the order of mins and adds cannot
change a result. This module is the plain version that the CUDA kernels in
ops/cuda_edt.py are held against, and the CPU path.
"""

from __future__ import annotations

import torch

from chaq_sdfgen_tpu_torch.ops.numerics import refined_sqrt

_NONE = -(1 << 30)  # "no seed yet" index for the cummax scans


def big_sentinel(band: int) -> float:
    """Finite stand-in for +inf: stays above band^2 through pass 2 and
    clamps like the reference's INFINITY (openmp/sdfgen.c:70)."""
    return float((band + 1) ** 2)


def row_nearest(seeds: torch.Tensor, clip: int) -> torch.Tensor:
    """Per-row distance along the last axis to the nearest seed, as int32
    clipped at ``clip`` (rows with no seed read ``clip``). seeds: (..., W)
    bool."""
    w = seeds.shape[-1]
    idx = torch.arange(w, dtype=torch.int32, device=seeds.device).expand(seeds.shape)
    none = torch.full((), _NONE, dtype=torch.int32, device=seeds.device)
    # forward: index of the nearest seed at or before x
    fwd = torch.cummax(torch.where(seeds, idx, none), dim=-1).values
    # backward: index of the nearest seed at or after x, via a flipped cummax
    # of negated indices
    bwd = torch.cummax(torch.where(seeds, -idx, none).flip(-1), dim=-1).values.flip(-1)
    d = torch.minimum(idx - fwd, -(idx + bwd))
    return torch.clamp(d, max=clip)


def row_nearest_sq(seeds: torch.Tensor, band: int) -> torch.Tensor:
    """Pass 1: per-row squared distance to the nearest seed along the last
    axis, float32, clipped at big_sentinel(band)."""
    d = row_nearest(seeds, band + 1)  # clip before squaring: exact in f32
    return (d * d).to(torch.float32)


def band_min_columns(g: torch.Tensor, band: int) -> torch.Tensor:
    """Pass 2: D(y, x) = min_{|dy| <= band} dy^2 + g(y+dy, x) along the
    second-to-last axis; out-of-image taps read the big sentinel. g is at
    most big (pass 1 clips), so a tap with |dy| > H - 1, outside the image
    on both sides, cannot lower D: the walk stops at H - 1."""
    big = big_sentinel(band)
    reach = min(band, g.shape[-2] - 1)
    pad = g.new_full(g.shape[:-2] + (reach, g.shape[-1]), big)
    return band_min_ext(torch.cat([pad, g, pad], dim=-2), reach)


def band_min_ext(gext: torch.Tensor, band: int) -> torch.Tensor:
    """band_min_columns on a pre-extended input carrying ``band`` extra rows
    on each side. (..., H+2B, W) -> (..., H, W)."""
    h = gext.shape[-2] - 2 * band
    acc = gext[..., band : band + h, :].clone()
    for dy in range(1, band + 1):
        pair = torch.minimum(gext[..., band - dy : band - dy + h, :],
                             gext[..., band + dy : band + dy + h, :])
        torch.minimum(acc, pair + float(dy * dy), out=acc)
    return acc


def edt_sq_banded(seeds: torch.Tensor, band: int) -> torch.Tensor:
    """Exact squared EDT of a binary seed set wherever the true distance
    <= band; saturates > band^2 elsewhere. (..., H, W) bool -> float32."""
    return band_min_columns(row_nearest_sq(seeds, band), band)


def edt_banded(seeds: torch.Tensor, band: int) -> torch.Tensor:
    """sqrt of edt_sq_banded, correctly rounded (numerics.refined_sqrt).

    Reference quirk reproduced: dist_transform_1d returns single-cell rows
    untouched (openmp/df.c:32-36), so for single-row images the second pass
    never applies sqrt and the 'distance' stays squared."""
    sq = edt_sq_banded(seeds, band)
    if seeds.shape[-2] <= 1:
        return sq
    return refined_sqrt(sq)


def dual_edt_banded(b: torch.Tensor, band: int):
    """(inside_dist, outside_dist) float32: distance to the TRUE set and to
    the FALSE set (the reference's two omp sections, openmp/sdfgen.c:277-289)."""
    return edt_banded(b, band), edt_banded(torch.logical_not(b), band)
