"""Sharded hard pipelines over a device mesh (chaq_sdfgen_tpu/parallel/
sharded.py): EXACT, BRUTE and JFA over a row ('y') mesh, a 2-D ('y', 'x')
tile mesh and, for EXACT and BRUTE, a 'data' batch axis.

Rows stay whole per 'y' shard, so the row passes are local; the column
passes read a halo of neighbouring shards' rows, exchanged by
``halo="ppermute"`` (parallel/halo.py, ``Tensor.to`` copies) or
``halo="rdma"`` (parallel/cuda_halo.py, kernels that pull through peer
pointers), and then run the single-device kernels on the halo'd strips:
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
device. The sharded soft path is the next slice (ROADMAP Queue 1 item
11b).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from chaq_sdfgen_tpu_torch.ops import cuda_brute, cuda_edt, jfa, threshold
from chaq_sdfgen_tpu_torch.ops.numerics import refined_sqrt
from chaq_sdfgen_tpu_torch.parallel import cuda_halo, halo
from chaq_sdfgen_tpu_torch.parallel.mesh import Mesh, along, image_spec, per_shard, shard, unshard


def _halo_fn(impl: str):
    """The row-halo exchange of ShardingConfig.halo_impl: 'ppermute' or
    'rdma'. Both give the same blocks."""
    if impl == "ppermute":
        return halo.exchange_row_halo
    if impl == "rdma":
        return cuda_halo.exchange_row_halo_rdma
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


def sharded_soft_sdf_field(*args, **kwargs):
    """The sharded soft path is not ported yet."""
    raise NotImplementedError(
        "the sharded soft path is not ported yet (ROADMAP Queue 1 item 11b)")
