"""The BRUTE pipeline's two kernels (csrc/brute.cu), each beside its plain
PyTorch version (chaq_sdfgen_tpu/ops/pallas_brute.py counterparts).

  seed_strips       pass A: per row, side and polarity, the distances to
                    the nearest and second-nearest seed (kernel
                    ``brute_rows``);
  brute_scan_bytes  the dy scan over the triangle candidate set, the sqrt
                    and the OpenCL sign and remap tail in one kernel (kernel
                    ``brute_scan_bytes``);
  brute_sdf_bytes   both: (..., H, W) mask -> (..., H, W) uint8, byte for
                    byte the OpenCL binary's output.

The strips are (2, 4, ..., H, W): [polarity][L1, L2, R1, R2], polarity 0
the TRUE pixels as seeds and 1 the FALSE ones, clipped at spread + 1,
uint8 while that fits and uint16 above, so one pair of kernels serves every
spread up to 32766 (where 2 (spread + 1)^2 still fits int32). The strips
carry no halo rows: the scan reads rows outside the image itself.

A wrapper runs the plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises; it never falls back. ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import torch

from chaq_sdfgen_tpu_torch.ops import _build, brute, threshold

LAUNCHES = {"brute_rows": 0, "brute_scan_bytes": 0}

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
    return brute.seed_strips(threshold.as_mask(b), spread).to(strip_dtype(spread))


def seed_strips(b: torch.Tensor, spread: int) -> torch.Tensor:
    """Pass A: (..., H, W) mask -> (2, 4, ..., H, W) strips of
    strip_dtype(spread). Kernel ``brute_rows`` on CUDA, the plain version on
    the CPU."""
    if b.device.type == "cpu":
        return seed_strips_plain(b, spread)
    _check_spread(spread)
    b = threshold.as_mask(b)
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
    CUDA, the plain version on the CPU."""
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


# ------------------------------------------------------------------ pipeline


def brute_sdf_bytes_plain(b: torch.Tensor, spread: int, asymmetric: bool = False,
                          invert: bool = False) -> torch.Tensor:
    """brute_sdf_bytes through the plain versions, on any device."""
    return brute_scan_bytes_plain(b, seed_strips_plain(b, spread), spread, asymmetric, invert)


def brute_sdf_bytes(b: torch.Tensor, spread: int, asymmetric: bool = False,
                    invert: bool = False) -> torch.Tensor:
    """BRUTE pipeline: (..., H, W) mask (bool, or any dtype with nonzero as
    TRUE) -> (..., H, W) uint8, byte-identical to the OpenCL reference
    kernel (opencl/sdf.cl:193-224)."""
    return brute_scan_bytes(b, seed_strips(b, spread), spread, asymmetric, invert)
