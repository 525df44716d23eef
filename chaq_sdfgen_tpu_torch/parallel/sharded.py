"""Sharded hard pipelines over a device mesh (chaq_sdfgen_tpu/parallel/
sharded.py): EXACT, BRUTE and JFA over a row ('y') mesh, a 2-D ('y', 'x')
tile mesh and, for EXACT and BRUTE, a 'data' batch axis.

Rows stay whole per 'y' shard, so the row passes are local; the column
passes read a halo of neighbouring shards' rows, exchanged by
``halo="ppermute"`` (parallel/halo.py, ``Tensor.to`` copies) or
``halo="rdma"`` (parallel/cuda_halo.py, one kernel launch per exchange
and device that pulls through peer pointers and writes the halo'd frames
in place), and then run the single-device kernels on the halo'd strips:
the bytes are those of the single-device pipeline. On a 2-D mesh the row
pass reads a column halo of tri-state codes (code 2, seeding neither
polarity, beyond the image) and is cropped to the tile.

Halo heights: EXACT exchanges hr = band rows of its pass-1 strips (the
kernel's walk reaches at most band rows; JAX pads to roundup(band + 8, 8)
for its looped TPU kernel, with the same bytes), BRUTE hr = spread rows of
its pass-A planes. A halo taller than a shard spans several shards
(multi-hop): hops = ceil(hr / H_local).

Each pipeline runs phase by phase, not shard by shard: every shard's row
pass, then the halos, then every shard's column pass, so that on distinct
cards the cards work at once. The result is joined onto the mesh's first
device.

On a mesh that spans processes (parallel/distributed.global_mesh: the
batch over 'data' across hosts), each function takes the global tensor,
checks its shape against the global mesh and runs the pipeline on this
process's part of it, over its part of the mesh (parallel/mesh.localize),
with no collective: the halos run along 'y' and 'x' lines, which must lie
within one process (else ValueError). It returns this process's part of
the result, at parallel/mesh.local_index.

The soft field (sharded_soft_sdf_field) is differentiable with respect to
the image: the shards, the halos and the join are autograd operations, the
ppermute halo by torch autograd and the rdma halo by its own VJP (the
kernel again, round the reverse ring), so each halo row's cotangent comes
back to the shard that owns the row. It runs the JAX function's tiers, in
its order and on its conditions as it evaluates them on its accelerator:
  1. a declared gray range in the gamut (use_mm):
     a. on shards whose height is a multiple of 128 with both tap radii
        <= 16 (and, on a 2-D mesh, tiles whose width is a multiple of 128):
        the two declared kernels (ops/cuda_soft_mm.py) on each shard with a
        k2-row gray halo, the backward pulling its neighbours' k2 edge rows
        of the cotangent and the memos, so that each shard writes the
        complete gradient of its own rows: field and gradient bit for bit
        the single device's on a 'y' mesh. A 2-D tile also reads a k1-column
        gray halo (JAX: 128 columns, for lane alignment; the same values)
        and the column exchange's VJP adds the x-boundary gradient (one add
        reordered);
     b. else, on a 'y' mesh, the shard-local two-conv split: the occupancy
        and the rows conv (row-local; float32 products, as JAX computes it
        outside any kernel), a k2-row halo of both rows-conv sums (fill 0),
        then pass 2 on the halo'd slab: for k2 <= 16 the cols conv and the
        tails in one kernel each way (ops/band_conv.py p2_fused_fwd/bwd),
        for wider taps the cols conv kernel both ways and the tails as torch
        ops;
  2. no declared range, shard heights a multiple of 8 (at least 2) and band
     <= 112 (use_fused): the four adaptive kernels (ops/soft_fused.py),
     either on each shard's block with a band-row gray halo and a live-row
     window (rows beyond the image read as no taps; 'window', JAX's choice
     where twice its 8-aligned halo fits in half a shard) or split: F1 on
     the block, a band-row halo of S1 (fill 1e30), F2 on the halo'd S1
     ('split'); JAX exchanges roundup(band, 8) rows for sublane alignment,
     the port the band rows the taps read. No runtime gate here, as in JAX;
  3. everything else: the composed scan. The heights, their soft-min along x
     (ops/softmin.py's kernels along x, both fields in one launch),
     a band-row halo of S1 (fill 1e30), the soft-min along y, the tails.
The 128-row, 128-column and 8-row conditions are TPU geometry (strips,
lanes, sublanes): the port's kernels take any shape. They are kept all the
same, because they decide only which kernels run, not what the field is,
and they are what sends a shard to rows 17-19 of the kernel table. A 2-D
mesh outside tier 1a raises XShardingRefused, a NotImplementedError with
JAX's message: the adaptive and composed tiers shard rows only, in JAX and
here (ROADMAP hazard 6). ``batch_axis`` shards the batch of a (N, H, W) image in every
tier; the kernels take the shard's images in their grid.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from chaq_sdfgen_tpu_torch.ops import (
    cuda_brute, cuda_edt, cuda_soft_mm, jfa, soft_fused, soft_mxu, softsdf, threshold,
)
from chaq_sdfgen_tpu_torch.ops.numerics import refined_sqrt
from chaq_sdfgen_tpu_torch.parallel import cuda_halo, halo
from chaq_sdfgen_tpu_torch.parallel.mesh import (
    Mesh, along, image_spec, lines, localize, per_shard, shard, unshard,
)


class XShardingRefused(NotImplementedError):
    """A soft field over a mesh with an x axis outside tier 1a (JAX's
    NotImplementedError, sharded.py:731-736, 773-777)."""


def _halo_fn(impl: str, many: bool = False):
    """The row-halo exchange of ShardingConfig.halo_impl: 'ppermute' or
    'rdma'. Both give the same frames. ``many``: the form that takes
    several chains, each with its fill (one launch for all under rdma),
    not differentiable."""
    if impl == "ppermute":
        return halo.exchange_row_halo_many if many else halo.exchange_row_halo
    if impl == "rdma":
        return cuda_halo.exchange_row_halo_rdma_many if many else cuda_halo.exchange_row_halo_rdma
    raise ValueError(f"unknown halo implementation {impl!r} (ppermute or rdma)")


def _local_height(b: torch.Tensor, mesh: Mesh, y_axis: str) -> int:
    n_y = mesh.size(y_axis)
    if b.shape[-2] % n_y:
        raise ValueError(f"{b.shape[-2]} rows are not divisible by mesh axis {y_axis!r} ({n_y})")
    return b.shape[-2] // n_y


def _codes_with_col_halo(blocks, mesh: Mesh, x_axis: Optional[str], cols: int):
    """Each shard's uint8 codes, with ``cols`` columns of its 'x'
    neighbours on each side (code 2 beyond the image) on a 2-D mesh."""
    codes = per_shard(threshold.as_codes, blocks)
    if x_axis is None:
        return codes
    return along(lambda c: halo.exchange_col_halo(c, cols, 2), codes, mesh, x_axis)


def _crop_cols(t: torch.Tensor, start: int, width: int) -> torch.Tensor:
    return t[..., start : start + width].contiguous()


def sharded_hard_sdf_bytes(
    b: torch.Tensor,
    spread: int,
    mesh: Mesh,
    asymmetric: bool = False,
    band: Optional[int] = None,
    y_axis: str = "y",
    batch_axis: Optional[str] = None,
    halo: str = "ppermute",
    x_axis: Optional[str] = None,
) -> torch.Tensor:
    """Hard EXACT pipeline over a mesh: (H, W) or (N, H, W) mask ->
    uint8 of its shape, byte for byte cuda_edt.fused_sdf_bytes. H must be
    divisible by the 'y' extent, W by the 'x' extent and N by the batch
    axis; any shard height >= 1 and any band up to cuda_edt.MAX_BAND.
    The single-row quirk (no pass-2 sqrt) follows the image's height."""
    band = band if band is not None else spread + 2
    if not 0 <= band <= cuda_edt.MAX_BAND:
        raise ValueError(f"band must be in [0, {cuda_edt.MAX_BAND}], got {band}")
    exchange = _halo_fn(halo)
    b = threshold.as_mask(b)
    spec = image_spec(b.dim(), y_axis, x_axis, batch_axis)
    b, mesh = localize(b, mesh, spec, along=(y_axis, x_axis))
    h_loc = _local_height(b, mesh, y_axis)
    blocks = shard(b, mesh, spec)
    w_loc = blocks.flat[0].shape[-1]

    # pass 1 per shard: on [band | tile | band] columns of codes on a 2-D mesh
    codes = _codes_with_col_halo(blocks, mesh, x_axis, band)
    strips = per_shard(lambda c: cuda_edt.row_distances_u8(c, band), codes)
    din = per_shard(lambda s: _crop_cols(s[0], band, w_loc) if x_axis else s[0], strips)
    dout = per_shard(lambda s: _crop_cols(s[1], band, w_loc) if x_axis else s[1], strips)

    # halos of hr = band rows; beyond the image a fill that pass 2 clips to band + 1
    fill = torch.iinfo(cuda_edt.strip_dtype(band)).max
    din = along(lambda bl: exchange(bl, band, fill), din, mesh, y_axis)
    dout = along(lambda bl: exchange(bl, band, fill), dout, mesh, y_axis)

    out = per_shard(lambda di, do: cuda_edt.fused_pass2_bytes(
        di, do, spread, asymmetric, band, apply_sqrt=b.shape[-2] > 1, row_off=band, out_rows=h_loc),
        din, dout)
    return unshard(out, mesh, spec)


def sharded_brute_sdf_bytes(
    b: torch.Tensor,
    spread: int,
    mesh: Mesh,
    asymmetric: bool = False,
    invert: bool = False,
    y_axis: str = "y",
    batch_axis: Optional[str] = None,
    x_axis: Optional[str] = None,
    halo: str = "ppermute",
) -> torch.Tensor:
    """BRUTE (OpenCL-parity) pipeline over a mesh: (H, W) or (N, H, W)
    mask -> uint8, byte for byte cuda_brute.brute_sdf_bytes. As JAX:
    spread <= 254 (uint8 planes) and an 8-aligned shard height; W must be
    divisible by the 'x' extent (which JAX does not check). ``halo`` picks
    the row-halo exchange, as for EXACT."""
    if spread + 1 > 255:
        raise ValueError(f"sharded brute needs spread <= 254, got {spread}")
    exchange = _halo_fn(halo)
    b = threshold.as_mask(b)
    spec = image_spec(b.dim(), y_axis, x_axis, batch_axis)
    b, mesh = localize(b, mesh, spec, along=(y_axis, x_axis))
    h_loc = _local_height(b, mesh, y_axis)
    if h_loc % 8 != 0 or h_loc < 2:
        raise ValueError(f"sharded brute needs an 8-aligned per-shard height >= 8, "
                         f"got {h_loc} ({b.shape[-2]} rows over {mesh.size(y_axis)} shards)")
    blocks = shard(b, mesh, spec)
    w_loc = blocks.flat[0].shape[-1]

    # pass A per shard: (2, 4, ..., H_loc, W) planes, on a 2-D mesh from
    # [spread | tile | spread] columns (distances clip at spread + 1)
    codes = _codes_with_col_halo(blocks, mesh, x_axis, spread)
    planes = per_shard(lambda c: cuda_brute.seed_strips(c, spread), codes)
    if x_axis is not None:
        planes = per_shard(lambda p: _crop_cols(p, spread, w_loc), planes)

    planes = along(lambda bl: exchange(bl, spread, spread + 1), planes, mesh, y_axis)
    out = per_shard(lambda bb, p: cuda_brute.brute_scan_bytes_halo(bb, p, spread, spread, asymmetric, invert),
                    blocks, planes)
    return unshard(out, mesh, spec)


def sharded_jfa_distance(
    seeds: torch.Tensor,
    mesh: Mesh,
    plus_one: bool = True,
    y_axis: str = "y",
    x_axis: Optional[str] = None,
) -> torch.Tensor:
    """Jump-flood distance field over a mesh: (H, W) bool -> float32,
    bit for bit jfa.jfa_distance. Every stride k reads, for each of its
    taps, the packed state (sy << xbits | sx, -1 where none) of the rows
    k above and below through fetch_row_slab, multi-hop where k exceeds a
    shard, and on a 2-D mesh the columns through fetch_col_slab (corner
    taps take both), so each pixel sees the single-device candidates in
    the single-device order."""
    if seeds.dim() != 2:
        raise ValueError(f"sharded_jfa_distance takes one (H, W) image, got shape {tuple(seeds.shape)}")
    h, w = seeds.shape
    spec = (y_axis, x_axis)
    seeds, mesh = localize(seeds, mesh, spec, along=(y_axis, x_axis))
    h_loc = _local_height(seeds, mesh, y_axis)
    blocks = shard(seeds.to(torch.bool), mesh, spec)
    w_loc = blocks.flat[0].shape[-1]
    xbits = max((w - 1).bit_length(), 1)
    mask = (1 << xbits) - 1
    ky = mesh.axis_names.index(y_axis)
    kx = mesh.axis_names.index(x_axis) if x_axis is not None else None

    coords = blocks.copy()
    for idx in np.ndindex(*blocks.shape):
        dev = blocks[idx].device
        yy = torch.arange(h_loc, dtype=torch.int32, device=dev).view(h_loc, 1) + idx[ky] * h_loc
        xx = torch.arange(w_loc, dtype=torch.int32, device=dev).view(1, w_loc)
        coords[idx] = (yy, xx + idx[kx] * w_loc if kx is not None else xx)

    def dist2(p, c):
        yy, xx = c
        dy, dx = yy - (p >> xbits), xx - (p & mask)
        return torch.where(p >= 0, dy * dy + dx * dx, torch.full_like(p, jfa.INVALID_D2))

    p = per_shard(lambda s, c: torch.where(s, (c[0] << xbits) | c[1], torch.full((), -1, dtype=torch.int32,
                                                                                device=s.device)),
                  blocks, coords)
    for k in jfa.strides(h, w, plus_one):
        sp = p  # synchronous: every candidate reads the stride's start
        d2 = per_shard(dist2, sp, coords)
        for dy in (-k, 0, k):
            # row y of the slab holds global row y + dy
            slab = sp if dy == 0 else along(lambda bl: halo.fetch_row_slab(bl, -dy, -1), sp, mesh, y_axis)
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                if x_axis is None:
                    cp = per_shard(lambda s: jfa._shift2d(s, 0, dx, -1), slab)
                else:
                    cp = slab if dx == 0 else along(lambda bl: halo.fetch_col_slab(bl, -dx, -1), slab, mesh, x_axis)
                cd2 = per_shard(dist2, cp, coords)
                p = per_shard(lambda a, b_, c, d: torch.where(c < d, b_, a), p, cp, cd2, d2)
                d2 = per_shard(torch.minimum, d2, cd2)
    return unshard(per_shard(lambda d: refined_sqrt(d.to(torch.float32)), d2), mesh, spec)


# ------------------------------------------------------------------ soft


_MM_ROWS = 128  # pallas_soft_mm._pick_rs: strips of 256 or 128 rows
_FUSED_ROWS = 8  # the adaptive kernels' sublane multiple


def _live_span(i: int, n: int, size: int, halo_rows: int) -> tuple:
    """The range of shard i of a chain of n (each ``size`` rows or
    columns) that lies inside the image, in its frame of [halo | block |
    halo]: the live window of a halo'd block (JAX's per-shard ylo, yhi)."""
    return max(0, halo_rows - i * size), min(size + 2 * halo_rows, halo_rows + (n - i) * size)


def _mm_fused_ok(h_loc: int, w_loc: int, k1: int, k2: int, two_d: bool) -> bool:
    """JAX's use_mmf (sharded.py:692-697): the shard height passes _pick_rs,
    both tap radii fit the kernels, and a 2-D tile is 128-multiple wide."""
    return (h_loc % _MM_ROWS == 0 and h_loc >= _MM_ROWS and cuda_soft_mm.mm_fused_ok(k1, k2)
            and (not two_d or w_loc % 128 == 0))


def _soft_mm_fused(blocks, mesh, y_axis, x_axis, frames, stats, tau, temperature, eps, test_above):
    """Tier 1a: the declared kernels on every chain along 'y', each shard
    with a k2-row gray halo (cuda_soft_mm.sharded_mm_fused); on a 2-D mesh
    each tile first takes k1 columns of its 'x' neighbours (fill 0, dead),
    live columns the image's, and is cropped back after."""
    k1, k2, shift = stats
    h, w_loc = blocks.flat[0].shape[-2:]
    ext = k1 if x_axis is not None else 0
    if ext:
        blocks = along(lambda c: halo.exchange_col_halo(c, k1, 0.0), blocks, mesh, x_axis)
    n = mesh.size(y_axis)
    kx = mesh.axis_names.index(x_axis) if ext else None
    out = np.empty(blocks.shape, dtype=object)
    for line in lines(mesh, y_axis):
        cols = _live_span(line[0][kx], mesh.size(x_axis), w_loc, ext) if ext else (0, w_loc)
        windows = [_live_span(i, n, h, k2) + cols for i in range(n)]
        fields = cuda_soft_mm.sharded_mm_fused([blocks[i] for i in line], frames, windows, k1, k2, shift, tau,
                                               temperature, eps, test_above)
        for i, f in zip(line, fields):
            out[i] = f[..., ext : ext + w_loc] if ext else f
    return out


def _soft_mm_local(blocks, mesh, y_axis, exchange, stats, tau, temperature, eps, test_above):
    """Tier 1b (JAX _local_soft_mm): per shard the shifted occupancy and
    the rows conv (radius k1) as float32 products on the width padded to
    128 columns of zero occupancy, cropped back; a k2-row halo of both
    sums (fill 0); then pass 2 on each shard's halo'd slab: the cols conv
    and the tails in one kernel each way for k2 <= 16 (rows 17-18), else
    the cols conv kernel (row 19) and the tails as torch ops."""
    k1, k2, shift = stats
    t = float(temperature)
    w = blocks.flat[0].shape[-1]
    wl = -(-max(w, soft_mxu._BLK) // soft_mxu._BLK) * soft_mxu._BLK

    def rows(g):
        gp = F.pad(g, (0, wl - w))
        _, e_in, e_out = soft_mxu.occupancy(gp, tau, t, shift, test_above)
        live = torch.arange(wl, device=g.device) < w
        zero = torch.zeros((), device=g.device)
        return tuple(soft_mxu.conv_rows_sym(torch.where(live, e, zero), k1, t)[..., :w]
                     for e in (e_in, e_out))

    sums = per_shard(rows, blocks)
    a_in = along(lambda c: exchange(c, k2, 0.0), per_shard(lambda s: s[0], sums), mesh, y_axis)
    a_out = along(lambda c: exchange(c, k2, 0.0), per_shard(lambda s: s[1], sums), mesh, y_axis)
    if k2 <= cuda_soft_mm.MAX_TAPS:
        return per_shard(lambda ai, ao: soft_mxu.pass2_fused_sym(ai, ao, k2, t, shift, eps), a_in, a_out)
    return per_shard(lambda ai, ao: soft_mxu.tails(soft_mxu.conv_cols_sym(ai, k2, t),
                                                   soft_mxu.conv_cols_sym(ao, k2, t), t, shift, eps)[0],
                     a_in, a_out)


def _soft_fused_window(blocks, mesh, y_axis, exchange, band, tau, temperature, eps, test_above):
    """Tier 2, 'window': each shard's block with a band-row gray halo
    (fill 0, read as no taps) through the four adaptive kernels, the live
    rows the image's, the interior rows kept; the gray halo's VJP returns
    the halo rows' gradients to their owners."""
    h = blocks.flat[0].shape[-2]
    ky = mesh.axis_names.index(y_axis)
    n = mesh.size(y_axis)
    gext = along(lambda c: exchange(c, band, 0.0), blocks, mesh, y_axis)
    out = np.empty(blocks.shape, dtype=object)
    for idx in np.ndindex(*blocks.shape):
        window = _live_span(idx[ky], n, h, band)
        field = soft_fused.soft_sdf_field_fused(gext[idx], band, tau, temperature, eps, test_above, window)
        out[idx] = field.narrow(-2, band, h)
    return out


def _soft_fused_split(blocks, mesh, y_axis, exchange, band, tau, temperature, eps, test_above):
    """Tier 2, 'split': F1 on each shard's block, a band-row halo of S1
    (fill 1e30), F2 on the halo'd S1; B2 returns the halo rows' dS1, which
    the S1 halo's VJP adds to their owners'."""
    s1 = per_shard(lambda g: soft_fused.pass1_s1(g, band, tau, temperature, test_above), blocks)
    s1ext = along(lambda c: exchange(c, band, soft_fused.PAD_H), s1, mesh, y_axis)
    return per_shard(lambda s: soft_fused.pass2_ext(s, band, temperature, eps, band), s1ext)


def _soft_composed(blocks, mesh, y_axis, exchange, band, tau, temperature, eps, test_above):
    """Tier 3, the composed scan (softsdf.soft_field_cols on each shard):
    the heights, their soft-min along x, a band-row halo of S1 (both fields
    side by side, fill 1e30), the soft-min along y, the tails."""
    w = blocks.flat[0].shape[-1]
    s1 = per_shard(lambda g: softsdf.cols_pass1(g, band, tau, temperature, test_above), blocks)
    s1ext = along(lambda c: exchange(c, band, soft_fused.PAD_H), s1, mesh, y_axis)
    return per_shard(lambda s: softsdf.cols_tails(softsdf.band_softmin_ext(s, band, temperature, axis=-2), w, eps),
                     s1ext)


def sharded_soft_sdf_field(
    gray: torch.Tensor,
    spread: int,
    mesh: Mesh,
    tau: float = 1.0,
    temperature: float = 0.5,
    eps: float = 1e-6,
    test_above: bool = True,
    band: Optional[int] = None,
    y_axis: str = "y",
    batch_axis: Optional[str] = None,
    halo: str = "ppermute",
    use_fused: Optional[bool] = None,
    gray_range: Optional[tuple] = None,
    use_mm: Optional[bool] = None,
    fused_impl: Optional[str] = None,
    x_axis: Optional[str] = None,
) -> torch.Tensor:
    """The soft SDF field over a mesh (the sharded softsdf.soft_sdf_field):
    (H, W) or (N, H, W) gray -> float32 of its shape on the mesh's first
    device, differentiable with respect to gray. The module docstring lists
    the tiers. ``use_mm``, ``use_fused`` force a tier as in JAX (None:
    its conditions), ``fused_impl`` 'window' or 'split' the adaptive tier's
    form; ``gray_range`` the declared input range. H must be divisible by
    the 'y' extent, W by the 'x' extent and N by the batch axis."""
    band = band if band is not None else spread + 2
    exchange = _halo_fn(halo)
    g = gray.to(torch.float32)
    spec = image_spec(g.dim(), y_axis, x_axis, batch_axis)
    g, mesh = localize(g, mesh, spec, along=(y_axis, x_axis))
    h_loc = _local_height(g, mesh, y_axis)
    w_loc = g.shape[-1] // mesh.size(x_axis)
    stats = soft_mxu.range_stats(band, tau, temperature, gray_range)
    use_mm = stats is not None if use_mm is None else use_mm
    if use_mm and stats is None:
        raise ValueError(f"use_mm needs a declared gray_range inside the gamut of tau {tau}, T {temperature}, "
                         f"band {band}; got {gray_range}")
    mm_fused = use_mm and _mm_fused_ok(h_loc, w_loc, stats[0], stats[1], x_axis is not None)
    if x_axis is not None and not mm_fused:
        raise XShardingRefused(
            "x-axis (column) sharding of the soft path requires the fused-mm tier: declared gray_range, static "
            "params, 128-aligned tile width, 128-divisible tile height" if use_mm else
            "x-axis (column) sharding of the soft path requires the fused-mm tier (declared gray_range + static "
            "params)")
    if not use_mm and use_fused is None:
        use_fused = h_loc % _FUSED_ROWS == 0 and h_loc >= 2 and band <= soft_fused.MAX_BAND
    use_window = fused_impl == "window"
    if use_fused and fused_impl is None:
        halo_rows = -(-band // _FUSED_ROWS) * _FUSED_ROWS  # JAX's choice, on its 8-aligned halo
        use_window = 2 * halo_rows <= max(h_loc // 2, 1)
    elif fused_impl not in (None, "window", "split"):
        raise ValueError(f"unknown fused_impl {fused_impl!r} (window or split)")

    blocks = shard(g, mesh, spec)
    kw = dict(tau=tau, temperature=temperature, eps=eps, test_above=test_above)
    if mm_fused:
        out = _soft_mm_fused(blocks, mesh, y_axis, x_axis, _halo_fn(halo, many=True), stats, **kw)
    elif use_mm:
        out = _soft_mm_local(blocks, mesh, y_axis, exchange, stats, **kw)
    elif use_fused:
        tier = _soft_fused_window if use_window else _soft_fused_split
        out = tier(blocks, mesh, y_axis, exchange, band, **kw)
    else:
        out = _soft_composed(blocks, mesh, y_axis, exchange, band, **kw)
    return unshard(out, mesh, spec)
