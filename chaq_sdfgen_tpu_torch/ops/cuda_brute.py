"""The BRUTE pipeline's kernels (csrc/brute.cu), each beside its plain
PyTorch version (chaq_sdfgen_tpu/ops/pallas_brute.py counterparts).

  seed_strips       pass A: per row, side and polarity, the distances to
                    the nearest and second-nearest seed (kernel
                    ``brute_rows``);
  brute_scan_bytes  the dy scan over the triangle candidate set, the sqrt
                    and the OpenCL sign and remap tail in one kernel (kernel
                    ``brute_scan_bytes``);
  brute_sdf_bytes   both: (..., H, W) mask -> (..., H, W) uint8, byte for
                    byte the OpenCL binary's output;
  brute_scan_bytes_halo  the scan on one shard of parallel/sharded.py: the
                    strips carry the neighbouring shards' rows (kernel
                    ``brute_scan_bytes_halo``).

The strips are (2, 4, ..., H, W): [polarity][L1, L2, R1, R2], polarity 0
the TRUE pixels as seeds and 1 the FALSE ones, clipped at spread + 1,
uint8 while that fits and uint16 above, so one pair of kernels serves every
spread up to 32766 (where 2 (spread + 1)^2 still fits int32). On one
device the strips carry no halo rows: the scan reads rows outside the
image itself.

A wrapper runs the plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises; it never falls back. ``LAUNCHES``
counts kernel launches. Under a torch profiler pass A is the span
``sdf.brute_rows`` and either scan ``sdf.brute_scan`` (each site tests
``profiling.recording()`` first, so with no profiler a call costs one
check).
"""

from __future__ import annotations

import torch

from chaq_sdfgen_tpu_torch.ops import _build, brute, threshold
from chaq_sdfgen_tpu_torch.utils.profiling import recording, span

LAUNCHES = {"brute_rows": 0, "brute_scan_bytes": 0, "brute_scan_bytes_halo": 0}

MAX_SPREAD = 32766  # 2 (spread + 1)^2 must fit the int32 d^2


def strip_dtype(spread: int) -> torch.dtype:
    return torch.uint8 if spread + 1 <= 255 else torch.uint16


def _check_spread(spread: int) -> None:
    if spread < 1 or spread > MAX_SPREAD:
        raise ValueError(f"spread must be in [1, {MAX_SPREAD}], got {spread}")


def _cuda_args(name: str, b: torch.Tensor, *others: torch.Tensor) -> None:
    if b.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {b.device}")
    _build.check_cuda(name, b, *others)


# --------------------------------------------------------------------- pass A


def seed_strips_plain(b: torch.Tensor, spread: int) -> torch.Tensor:
    """Plain pass A on any device: (2, 4, ..., H, W) of strip_dtype(spread)."""
    _check_spread(spread)
    return brute.seed_strips(threshold.as_codes(b), spread).to(strip_dtype(spread))


def seed_strips(b: torch.Tensor, spread: int) -> torch.Tensor:
    """Pass A: (..., H, W) bool mask or uint8 tri-state codes (1 seeds TRUE,
    0 seeds FALSE, 2 neither; threshold.as_codes) -> (2, 4, ..., H, W)
    strips of strip_dtype(spread). Kernel ``brute_rows`` on CUDA, the plain
    version on the CPU. Span ``sdf.brute_rows``."""
    if recording():
        with span("sdf.brute_rows"):
            return _seed_strips(b, spread)
    return _seed_strips(b, spread)


def _seed_strips(b: torch.Tensor, spread: int) -> torch.Tensor:
    if b.device.type == "cpu":
        return seed_strips_plain(b, spread)
    _check_spread(spread)
    b = threshold.as_codes(b)
    _cuda_args("seed_strips", b)
    out = torch.empty((2, 4) + tuple(b.shape), dtype=strip_dtype(spread), device=b.device)
    n, h, w = _build.flat_shape(b)
    if b.numel() == 0:
        return out
    _build.launch("chaq_brute_rows", b.device, b.data_ptr(), out.data_ptr(), n, h, w, spread + 1,
                  out.element_size())
    LAUNCHES["brute_rows"] += 1
    return out


# ------------------------------------------------------------------- the scan


def brute_scan_bytes_plain(b: torch.Tensor, strips: torch.Tensor, spread: int,
                           asymmetric: bool = False, invert: bool = False) -> torch.Tensor:
    """Plain scan and tail on any device: (..., H, W) uint8."""
    _check_spread(spread)
    b = threshold.as_mask(b)
    return brute.brute_tail(brute.triangle_d2(b, strips, spread), b, spread, asymmetric, invert)


def brute_scan_bytes(b: torch.Tensor, strips: torch.Tensor, spread: int,
                     asymmetric: bool = False, invert: bool = False) -> torch.Tensor:
    """The scan: mask (..., H, W) and its seed strips -> final (..., H, W)
    uint8. Per pixel, D = min over |dy| <= spread of dx^2 + dy^2 over the
    seeds of the other value (|dx| == |dy| excluded), found = D <=
    spread^2, then the sqrt, the sign rule decider = invert ^ value, the
    +-INF fallback and the clamped remap. Kernel ``brute_scan_bytes`` on
    CUDA, the plain version on the CPU. Span ``sdf.brute_scan``."""
    if recording():
        with span("sdf.brute_scan"):
            return _brute_scan_bytes(b, strips, spread, asymmetric, invert)
    return _brute_scan_bytes(b, strips, spread, asymmetric, invert)


def _brute_scan_bytes(b: torch.Tensor, strips: torch.Tensor, spread: int, asymmetric: bool,
                      invert: bool) -> torch.Tensor:
    if b.device.type == "cpu":
        return brute_scan_bytes_plain(b, strips, spread, asymmetric, invert)
    _check_spread(spread)
    b = threshold.as_mask(b)
    _cuda_args("brute_scan_bytes", b, strips)
    if strips.shape != (2, 4) + tuple(b.shape) or strips.dtype != strip_dtype(spread):
        raise ValueError(
            f"brute_scan_bytes: strips must be (2, 4, *{tuple(b.shape)}) {strip_dtype(spread)}, "
            f"got {tuple(strips.shape)} {strips.dtype}")
    out = torch.empty(b.shape, dtype=torch.uint8, device=b.device)
    n, h, w = _build.flat_shape(b)
    if b.numel() == 0:
        return out
    s_min = 0.0 if asymmetric else -float(spread)
    _build.launch("chaq_brute_scan_bytes", b.device, b.data_ptr(), strips.data_ptr(), out.data_ptr(),
                  n, h, w, spread, s_min, float(spread), int(invert), strips.element_size())
    LAUNCHES["brute_scan_bytes"] += 1
    return out


def brute_scan_bytes_halo_plain(b: torch.Tensor, strips: torch.Tensor, spread: int, row_off: int,
                                asymmetric: bool = False, invert: bool = False) -> torch.Tensor:
    """Plain halo scan on any device: brute_scan_bytes_plain's scan on the
    extended strips, cropped to the shard's rows (see brute_scan_bytes_halo)."""
    _check_spread(spread)
    b = threshold.as_mask(b)
    h, hs = b.shape[-2], strips.shape[-2]
    _check_halo_rows(h, hs, row_off)
    # the halo rows' values only pick the polarity of halo pixels, which are cropped
    ext = torch.nn.functional.pad(b.view(torch.uint8), (0, 0, row_off, hs - h - row_off)) != 0
    d2 = brute.triangle_d2(ext, strips, spread)[..., row_off : row_off + h, :]
    return brute.brute_tail(d2, b, spread, asymmetric, invert)


def brute_scan_bytes_halo(b: torch.Tensor, strips: torch.Tensor, spread: int, row_off: int,
                          asymmetric: bool = False, invert: bool = False) -> torch.Tensor:
    """The scan on one shard: the shard's mask (..., H, W) and its strips
    extended by neighbouring shards' rows, (2, 4, ..., Hs, W) with the
    shard's rows at [row_off, row_off + H) -> the shard's (..., H, W) uint8.
    Byte for byte brute_scan_bytes on the whole image wherever the strips
    hold at least ``spread`` rows on either side of the shard (or the image
    ends there). Kernel ``brute_scan_bytes_halo`` on CUDA, the plain version
    on the CPU. Span ``sdf.brute_scan``."""
    if recording():
        with span("sdf.brute_scan"):
            return _brute_scan_bytes_halo(b, strips, spread, row_off, asymmetric, invert)
    return _brute_scan_bytes_halo(b, strips, spread, row_off, asymmetric, invert)


def _brute_scan_bytes_halo(b: torch.Tensor, strips: torch.Tensor, spread: int, row_off: int,
                           asymmetric: bool, invert: bool) -> torch.Tensor:
    if b.device.type == "cpu":
        return brute_scan_bytes_halo_plain(b, strips, spread, row_off, asymmetric, invert)
    _check_spread(spread)
    b = threshold.as_mask(b)
    _cuda_args("brute_scan_bytes_halo", b, strips)
    h, hs = b.shape[-2], strips.shape[-2]
    _check_halo_rows(h, hs, row_off)
    want = (2, 4) + tuple(b.shape[:-2]) + (hs, b.shape[-1])
    if strips.shape != want or strips.dtype != strip_dtype(spread):
        raise ValueError(f"brute_scan_bytes_halo: strips must be {want} {strip_dtype(spread)}, "
                         f"got {tuple(strips.shape)} {strips.dtype}")
    out = torch.empty(b.shape, dtype=torch.uint8, device=b.device)
    n, _, w = _build.flat_shape(b)
    if b.numel() == 0:
        return out
    s_min = 0.0 if asymmetric else -float(spread)
    _build.launch("chaq_brute_scan_bytes_halo", b.device, b.data_ptr(), strips.data_ptr(), out.data_ptr(),
                  n, h, hs, w, row_off, spread, s_min, float(spread), int(invert), strips.element_size())
    LAUNCHES["brute_scan_bytes_halo"] += 1
    return out


def _check_halo_rows(h: int, hs: int, row_off: int) -> None:
    if row_off < 0 or row_off + h > hs:
        raise ValueError(f"shard rows [{row_off}, {row_off + h}) outside strips of {hs} rows")


# ------------------------------------------------------------------ pipeline


def brute_sdf_bytes_plain(b: torch.Tensor, spread: int, asymmetric: bool = False,
                          invert: bool = False) -> torch.Tensor:
    """brute_sdf_bytes through the plain versions, on any device."""
    b = threshold.as_mask(b)
    return brute_scan_bytes_plain(b, seed_strips_plain(b, spread), spread, asymmetric, invert)


def brute_sdf_bytes(b: torch.Tensor, spread: int, asymmetric: bool = False,
                    invert: bool = False) -> torch.Tensor:
    """BRUTE pipeline: (..., H, W) mask (bool, or any dtype with nonzero as
    TRUE) -> (..., H, W) uint8, byte-identical to the OpenCL reference
    kernel (opencl/sdf.cl:193-224)."""
    b = threshold.as_mask(b)
    return brute_scan_bytes(b, seed_strips(b, spread), spread, asymmetric, invert)
