"""The hard EXACT pipeline's two kernels and the exact distance field's
(csrc/edt.cu), each beside its plain PyTorch version
(chaq_sdfgen_tpu/ops/pallas_edt.py counterparts).

  row_distances_u8   pass 1: per-row distances to the nearest TRUE and the
                     nearest FALSE pixel (kernel ``edt_rows``);
  fused_pass2_bytes  pass 2: banded column min-plus, sqrt, signed merge and
                     byte remap in one kernel (kernel ``edt_band_bytes``);
  fused_sdf_bytes    both passes: (..., H, W) bool -> (..., H, W) uint8;
  exact_dist         the full-range column min-plus and sqrt of one
                     uint16 pass-1 strip: dist_core (kernel
                     ``edt_dist_core``: dense tiles, 16-row segment minima),
                     then dist_walk (kernel ``edt_dist``: the tiles left);
  exact_distance_field(s)  pass 1 at the saturation tier, then exact_dist:
                     (..., H, W) bool -> float32 distance field(s).

The strips between the passes are uint8 when band + 1 <= 255, uint16 up
to 65535 and int32 above, so one pair of kernels serves every band up to
MAX_BAND (the JAX package takes XLA above 65534, pallas_edt.py:939-945,
where its int32 d * d wraps once a clipped row distance passes 46340: on
a row with no seed, in an image wider than that or lacking a polarity;
the port squares in float32 and keeps the reference's saturation there).
On one device the strips carry no halo rows: pass 2 reads rows outside
the image as saturated itself. A shard's strips carry its neighbours'
rows (parallel/sharded.py): pass 2 then starts at a row offset and writes
only the shard's own rows.

A wrapper runs the plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises; it never falls back. ``LAUNCHES``
counts kernel launches, one per launch, so a run can show that it went
through the kernels; the uint16 instances of the two passes (the TPU's
``_ext`` kernels) are also counted on their own.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from chaq_sdfgen_tpu_torch.ops import _build, edt, jfa, merge, threshold
from chaq_sdfgen_tpu_torch.ops.numerics import refined_sqrt, walk_done
from chaq_sdfgen_tpu_torch.utils.profiling import recording, span

LAUNCHES = {"edt_rows": 0, "edt_band_bytes": 0, "edt_dist": 0, "edt_dist_core": 0, "edt_rows_u16": 0,
            "edt_band_bytes_u16": 0}

MAX_BAND = (1 << 30) - 1  # band + 1 stays below the kernels' "no seed" index 2^30
SEG = 16  # rows per segment minimum of exact_dist's table (csrc/edt.cu)
TILE = (128, 32)  # exact_dist's tiles: rows, columns
CAP = 8  # rows each way of a dense tile's capped walk


def strip_dtype(band: int) -> torch.dtype:
    if band + 1 <= 255:
        return torch.uint8
    return torch.uint16 if band + 1 <= 65535 else torch.int32


def _check_band(band: int) -> None:
    if band < 0 or band > MAX_BAND:
        raise ValueError(f"band must be in [0, {MAX_BAND}], got {band}")


# --------------------------------------------------------------------- pass 1


def row_distances_u8_plain(b: torch.Tensor, band: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain pass 1 on any device: (din, dout), each (..., H, W) of
    strip_dtype(band), clipped at band + 1."""
    _check_band(band)
    codes = threshold.as_codes(b)
    dtype = strip_dtype(band)
    din = edt.row_nearest(codes == 1, band + 1).to(dtype)
    dout = edt.row_nearest(codes == 0, band + 1).to(dtype)
    return din, dout


def row_distances_u8(b: torch.Tensor, band: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1: (..., H, W) bool mask or uint8 tri-state codes -> (din, dout)
    of strip_dtype(band): the distance along x to the nearest TRUE (code 1)
    and the nearest FALSE (code 0) pixel, clipped at band + 1. Kernel
    ``edt_rows`` on CUDA, the plain version on the CPU. Span
    ``sdf.edt_rows``."""
    if recording():
        with span("sdf.edt_rows"):
            return _row_distances_u8(b, band)
    return _row_distances_u8(b, band)


def _row_distances_u8(b: torch.Tensor, band: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if b.device.type == "cpu":
        return row_distances_u8_plain(b, band)
    if b.device.type != "cuda":
        raise ValueError(f"row_distances_u8: unsupported device {b.device}")
    _check_band(band)
    codes = threshold.as_codes(b)
    _build.check_cuda("row_distances_u8", codes)
    dtype = strip_dtype(band)
    din = torch.empty(codes.shape, dtype=dtype, device=codes.device)
    dout = torch.empty_like(din)
    n, h, w = _build.flat_shape(codes)
    if codes.numel() == 0:
        return din, dout
    _build.launch("chaq_edt_rows", codes.device, codes.data_ptr(), din.data_ptr(), dout.data_ptr(),
            n, h, w, band + 1, din.element_size())
    LAUNCHES["edt_rows"] += 1
    if din.dtype == torch.uint16:
        LAUNCHES["edt_rows_u16"] += 1
    return din, dout


# --------------------------------------------------------------------- pass 2


def _out_rows(din: torch.Tensor, row_off: int, out_rows) -> int:
    h = din.shape[-2]
    out_rows = h - 2 * row_off if out_rows is None else out_rows
    if row_off < 0 or out_rows < 0 or row_off + out_rows > h:
        raise ValueError(f"rows [{row_off}, {row_off} + {out_rows}) outside a strip of {h} rows")
    return out_rows


def pass2_staged(h: int, band: int, itemsize: int, device=None) -> bool:
    """Whether pass 2 (kernel edt_band_bytes) on strips of ``h`` rows and
    ``itemsize`` bytes a value takes the staged walk on ``device`` (the
    current CUDA device by default), as its launcher decides: where a
    block's largest window fits its shared memory; else the per-pixel walk.
    Asks the launcher's own rule (chaq_edt_band_staged)."""
    lib = _build.load()
    staged = ctypes.c_int(0)
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        rc = lib.chaq_edt_band_staged(h, band, itemsize, ctypes.byref(staged))
    if rc != 0:
        raise RuntimeError(f"chaq_edt_band_staged: cudaError {rc}")
    return bool(staged.value)


def fused_pass2_bytes_plain(
    din: torch.Tensor, dout: torch.Tensor, spread: int, asymmetric: bool, band: int,
    apply_sqrt: bool = True, row_off: int = 0, out_rows: int | None = None,
) -> torch.Tensor:
    """Plain pass 2 on any device: (..., H, W) strips -> (..., out_rows, W)
    uint8 (see fused_pass2_bytes)."""
    _check_band(band)
    out_rows = _out_rows(din, row_off, out_rows)
    clip = band + 1

    def squares(d):
        d = torch.clamp(d.to(torch.int32), max=clip).to(torch.float32)
        return d * d

    rows = slice(row_off, row_off + out_rows)
    d_in = edt.band_min_columns(squares(din), band)[..., rows, :]
    d_out = edt.band_min_columns(squares(dout), band)[..., rows, :]
    if apply_sqrt:
        d_in, d_out = refined_sqrt(d_in), refined_sqrt(d_out)
    return merge.remap_to_byte(merge.signed_merge(d_out, d_in), spread, asymmetric)


def fused_pass2_bytes(
    din: torch.Tensor, dout: torch.Tensor, spread: int, asymmetric: bool, band: int,
    apply_sqrt: bool = True, row_off: int = 0, out_rows: int | None = None,
) -> torch.Tensor:
    """Pass 2: row-distance strips (..., H, W) of strip_dtype -> final
    (..., out_rows, W) uint8 bytes. D = min over |dy| <= band of dy^2 +
    min(d, band+1)^2 per field (rows outside the strip read (band+1)^2),
    then the correctly rounded sqrt (skipped when ``apply_sqrt`` is False:
    the reference's single-row quirk), the -1-biased signed merge and the
    clamped remap. Output row y is strip row y + row_off; out_rows defaults
    to H - 2 row_off, the rows between two halos of row_off rows (the
    counterpart of pallas_edt.fused_pass2_bytes(row_off=, out_rows=)).
    Kernel ``edt_band_bytes`` on CUDA, the plain version on the CPU. Span
    ``sdf.edt_band``."""
    if recording():
        with span("sdf.edt_band"):
            return _fused_pass2_bytes(din, dout, spread, asymmetric, band, apply_sqrt, row_off, out_rows)
    return _fused_pass2_bytes(din, dout, spread, asymmetric, band, apply_sqrt, row_off, out_rows)


def _fused_pass2_bytes(din, dout, spread, asymmetric, band, apply_sqrt, row_off, out_rows) -> torch.Tensor:
    if din.device.type == "cpu":
        return fused_pass2_bytes_plain(din, dout, spread, asymmetric, band, apply_sqrt, row_off, out_rows)
    if din.device.type != "cuda":
        raise ValueError(f"fused_pass2_bytes: unsupported device {din.device}")
    _check_band(band)
    _build.check_cuda("fused_pass2_bytes", din, dout)
    if din.shape != dout.shape or din.dtype != dout.dtype:
        raise ValueError("fused_pass2_bytes: din and dout must match in shape and dtype")
    if din.dtype not in (torch.uint8, torch.uint16, torch.int32):
        raise TypeError(f"fused_pass2_bytes: strips must be uint8, uint16 or int32, got {din.dtype}")
    out_rows = _out_rows(din, row_off, out_rows)
    out = torch.empty(din.shape[:-2] + (out_rows, din.shape[-1]), dtype=torch.uint8, device=din.device)
    n, h, w = _build.flat_shape(din)
    if out.numel() == 0:
        return out
    s_min = 0.0 if asymmetric else -float(spread)
    _build.launch("chaq_edt_band_bytes", din.device, din.data_ptr(), dout.data_ptr(), out.data_ptr(),
            n, h, w, row_off, out_rows, band, s_min, float(spread), int(apply_sqrt), din.element_size())
    LAUNCHES["edt_band_bytes"] += 1
    if din.dtype == torch.uint16:
        LAUNCHES["edt_band_bytes_u16"] += 1
    return out


# ------------------------------------------------------------------ pipeline


def fused_sdf_bytes_plain(
    b: torch.Tensor, spread: int, asymmetric: bool = False, band: int | None = None
) -> torch.Tensor:
    """fused_sdf_bytes through the plain versions, on any device."""
    band = band if band is not None else spread + 2
    din, dout = row_distances_u8_plain(threshold.as_mask(b), band)
    return fused_pass2_bytes_plain(din, dout, spread, asymmetric, band, b.shape[-2] > 1)


def fused_sdf_bytes(
    b: torch.Tensor, spread: int, asymmetric: bool = False, band: int | None = None
) -> torch.Tensor:
    """Hard EXACT pipeline: (..., H, W) mask (bool, or any dtype with
    nonzero as TRUE) -> (..., H, W) uint8, byte-identical to the OpenMP
    reference (see ops/edt.py for the banding argument). band defaults to
    spread + 2 and may be at most MAX_BAND."""
    band = band if band is not None else spread + 2
    _check_band(band)
    din, dout = row_distances_u8(threshold.as_mask(b), band)
    # single-row images: the reference never applies the pass-2 sqrt
    return fused_pass2_bytes(din, dout, spread, asymmetric, band, apply_sqrt=b.shape[-2] > 1)


# ------------------------------------------------- exact full-range distance

NO_SEED = 32768.0  # jfa_distance's value where no seed exists


def dist_sat(n: int) -> int | None:
    """The smallest saturation tier for an image whose longest side is n
    (pallas_edt._dist_sat): sat > sqrt(2) (n - 1), so that a row with no
    seed can never beat a real candidate; sat^2 + (n - 1)^2 < 2^31, so that
    d^2 stays exact in int32; sat <= 65535 (uint16 strips). None beyond
    16384 px per side, where int32 would overflow."""
    if n <= 4096:
        return 8191
    if n <= 8192:
        return 16383
    if n <= 16384:
        return 23170
    return None


def exact_dist_plain(d: torch.Tensor, sat: int) -> torch.Tensor:
    """Plain version of kernel ``edt_dist`` on any device: (..., H, W) row
    distances (uint16, clipped at ``sat``) -> (..., H, W) float32. D = min
    over all dy of dy^2 + min(d(y+dy), sat)^2 in int32; NO_SEED where D >=
    sat^2, else the correctly rounded sqrt of D as float32. The walk over
    dy stops once dy^2 reaches the largest D so far (no later tap can lower
    any pixel), read to the host every few steps."""
    h = d.shape[-2]
    g = torch.clamp(d.to(torch.int32), max=sat)
    g = g * g
    acc = g.clone()
    for dy in range(1, h):
        if walk_done(dy, acc):
            break
        tap = g[..., dy:, :] + dy * dy
        torch.minimum(acc[..., :-dy, :], tap, out=acc[..., :-dy, :])
        tap = g[..., :-dy, :] + dy * dy
        torch.minimum(acc[..., dy:, :], tap, out=acc[..., dy:, :])
    dist = refined_sqrt(acc.to(torch.float32))
    return torch.where(acc >= sat * sat, torch.full_like(dist, NO_SEED), dist)


def dist_table_plain(d: torch.Tensor, sat: int) -> torch.Tensor:
    """The table kernel ``edt_dist_core`` writes, on any device: (..., H, W)
    row distances -> (..., ceil(H/16), W) uint16, the least min(d, sat) of
    each 16-row segment of each column."""
    h = d.shape[-2]
    nseg = -(-h // SEG)
    g = torch.clamp(d.to(torch.int32), max=sat)
    pad = torch.full(g.shape[:-2] + (nseg * SEG - h, g.shape[-1]), sat, dtype=torch.int32, device=d.device)
    g = torch.cat([g, pad], dim=-2)
    return g.view(g.shape[:-2] + (nseg, SEG, g.shape[-1])).amin(-2).to(torch.uint16)


def _tiles(x: torch.Tensor, op: str) -> torch.Tensor:
    """(n, H, W) -> (n, ceil(H/128), ceil(W/32)): the sum ("sum") or the any
    ("any") of x over each of exact_dist's tiles."""
    n, h, w = x.shape
    th, tw = TILE
    x = torch.nn.functional.pad(x.to(torch.int32), (0, -w % tw, 0, -h % th))
    x = x.view(n, -(-h // th), th, -(-w // tw), tw).sum((2, 4))
    return x if op == "sum" else x > 0


def dist_left_plain(d: torch.Tensor, sat: int) -> torch.Tensor:
    """The flags kernel ``edt_dist_core`` writes, on any device: (..., H, W)
    row distances -> (..., ceil(H/128), ceil(W/32)) uint8, what each tile
    leaves to kernel ``edt_dist``: 0 nothing, 1 every pixel (a sparse tile:
    fewer than 7/8 of its pixels' own min(d, sat) at most CAP), 2 some (a
    dense tile with a pixel whose least dy^2 + g over |dy| <= CAP exceeds
    (CAP + 1)^2 and whose column goes on past CAP rows)."""
    lead, (h, w) = d.shape[:-2], d.shape[-2:]
    g = torch.clamp(d.reshape(-1, h, w).to(torch.int32), max=sat)
    g = g * g
    npix = _tiles(torch.ones_like(g), "sum")
    dense = 8 * _tiles(g <= CAP * CAP, "sum") >= 7 * npix
    best = g.clone()
    for a in range(1, min(CAP, h - 1) + 1):
        torch.minimum(best[:, :-a], g[:, a:] + a * a, out=best[:, :-a])
        torch.minimum(best[:, a:], g[:, :-a] + a * a, out=best[:, a:])
    y = torch.arange(h, device=d.device).view(1, h, 1)
    done = (torch.maximum(y, h - 1 - y) <= CAP) | (best <= (CAP + 1) * (CAP + 1))
    left = torch.where(dense, 2 * _tiles(~done, "any").to(torch.int32), 1)
    return left.to(torch.uint8).reshape(lead + left.shape[-2:])


def dist_core_plain(d: torch.Tensor, sat: int):
    """Plain version of kernel ``edt_dist_core`` on any device: (out,
    table, left) as dist_core returns them, with every pixel of out set."""
    return exact_dist_plain(d, sat), dist_table_plain(d, sat), dist_left_plain(d, sat)


def _check_dist(name: str, d: torch.Tensor) -> None:
    _build.check_cuda(name, d)
    if d.dtype != torch.uint16:
        raise TypeError(f"{name}: the strip must be uint16, got {d.dtype}")


def dist_core(d: torch.Tensor, sat: int):
    """The first of exact_dist's two launches: uint16 row distances (...,
    H, W) clipped at ``sat`` -> (out, table, left). out (..., H, W) float32
    holds exact_dist's values on the tiles of 128 rows x 32 columns that
    ``left`` (..., ceil(H/128), ceil(W/32)) uint8 marks 0 (dense tiles done
    within CAP rows; elsewhere out is not yet written; see dist_left_plain);
    table is dist_table_plain's. Kernel ``edt_dist_core`` on CUDA, the plain
    version on the CPU."""
    if d.device.type == "cpu":
        return dist_core_plain(d, sat)
    if d.device.type != "cuda":
        raise ValueError(f"dist_core: unsupported device {d.device}")
    _check_dist("dist_core", d)
    n, h, w = _build.flat_shape(d)
    out = torch.empty(d.shape, dtype=torch.float32, device=d.device)
    table = torch.empty(d.shape[:-2] + (-(-h // SEG), w), dtype=torch.uint16, device=d.device)
    left = torch.empty(d.shape[:-2] + (-(-h // TILE[0]), -(-w // TILE[1])), dtype=torch.uint8, device=d.device)
    if d.numel() == 0:
        return out, table, left
    _build.launch("chaq_edt_dist_core", d.device, d.data_ptr(), table.data_ptr(), left.data_ptr(), out.data_ptr(),
                  n, h, w, sat)
    LAUNCHES["edt_dist_core"] += 1
    return out, table, left


def dist_walk(d: torch.Tensor, sat: int, out: torch.Tensor, table: torch.Tensor, left: torch.Tensor) -> torch.Tensor:
    """The second launch: writes exact_dist's values into ``out`` on the
    tiles dist_core left, from its table, and returns out. Kernel
    ``edt_dist`` on CUDA; on the CPU the plain version, exact_dist_plain."""
    if d.device.type == "cpu":
        return exact_dist_plain(d, sat)
    if d.device.type != "cuda":
        raise ValueError(f"dist_walk: unsupported device {d.device}")
    _check_dist("dist_walk", d)
    _build.check_cuda("dist_walk", d, out, table, left)
    n, h, w = _build.flat_shape(d)
    if (out.shape != d.shape or out.dtype != torch.float32 or table.dtype != torch.uint16
            or table.shape != d.shape[:-2] + (-(-h // SEG), w) or left.dtype != torch.uint8
            or left.shape != d.shape[:-2] + (-(-h // TILE[0]), -(-w // TILE[1]))):
        raise ValueError("dist_walk: out, table and left must be dist_core's")
    if d.numel() == 0:
        return out
    _build.launch("chaq_edt_dist", d.device, d.data_ptr(), table.data_ptr(), left.data_ptr(), out.data_ptr(),
                  n, h, w, sat)
    LAUNCHES["edt_dist"] += 1
    return out


def exact_dist(d: torch.Tensor, sat: int) -> torch.Tensor:
    """Pass 2 of the exact distance field: uint16 row distances clipped at
    ``sat`` -> float32 distances (see exact_dist_plain). On CUDA two
    launches: dist_core (the dense tiles, the segment table), then
    dist_walk (the tiles left, whose walk skips the segments the table rules
    out); the plain version on the CPU."""
    if d.device.type == "cpu":
        return exact_dist_plain(d, sat)
    return dist_walk(d, sat, *dist_core(d, sat))


def _exact_fields(b: torch.Tensor, row_pass, dist):
    """(distance to the nearest TRUE pixel, distance to the nearest FALSE
    pixel) of a (..., H, W) mask, through ``row_pass`` and ``dist`` (the
    kernels or their plain versions). Pass 1 at band sat - 1 clips at sat
    in uint16 and gives both polarities in one sweep. Beyond 16384 px per
    side the fields are jfa_distance's, by the function's definition."""
    b = threshold.as_mask(b)
    sat = dist_sat(max(b.shape[-2:]))
    if sat is None:
        return jfa.jfa_distance(b), jfa.jfa_distance(torch.logical_not(b))
    din, dout = row_pass(b, sat - 1)
    return dist(din, sat), dist(dout, sat)


def exact_distance_fields_plain(b: torch.Tensor):
    """exact_distance_fields through the plain versions, on any device."""
    return _exact_fields(b, row_distances_u8_plain, exact_dist_plain)


def exact_distance_fields(b: torch.Tensor):
    """(distance to the nearest TRUE pixel, distance to the nearest FALSE
    pixel) of a (..., H, W) mask, each float32, exact full-range, NO_SEED
    (32768.0) where there is none (pallas_edt.exact_distance_field on b and
    on not b). Exact up to 16384 px per side; beyond, jfa_distance. The
    kernels for a CUDA tensor, the plain versions on the CPU."""
    return _exact_fields(b, row_distances_u8, exact_dist)


def exact_distance_field(b: torch.Tensor) -> torch.Tensor:
    """The first of exact_distance_fields: the distance to the nearest
    TRUE pixel."""
    return exact_distance_fields(b)[0]


def refined_sqrt_cuda(n: torch.Tensor) -> torch.Tensor:
    """The pass-2 kernel's sqrt tail alone on a CUDA float32 tensor (a test
    entry: the exhaustive check against numerics.refined_sqrt)."""
    if n.device.type != "cuda" or n.dtype != torch.float32 or not n.is_contiguous():
        raise ValueError("refined_sqrt_cuda: needs a contiguous float32 CUDA tensor")
    out = torch.empty_like(n)
    if n.numel() > 0:
        _build.launch("chaq_refined_sqrt_f32", n.device, n.data_ptr(), out.data_ptr(), n.numel())
    return out
