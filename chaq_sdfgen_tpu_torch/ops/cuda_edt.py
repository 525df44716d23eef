"""The hard EXACT pipeline's two kernels (csrc/edt.cu), each beside its
plain PyTorch version (chaq_sdfgen_tpu/ops/pallas_edt.py counterparts).

  row_distances_u8   pass 1: per-row distances to the nearest TRUE and the
                     nearest FALSE pixel (kernel ``edt_rows``);
  fused_pass2_bytes  pass 2: banded column min-plus, sqrt, signed merge and
                     byte remap in one kernel (kernel ``edt_band_bytes``);
  fused_sdf_bytes    both passes: (..., H, W) bool -> (..., H, W) uint8.

The strips between the passes are uint8 when band + 1 <= 255 and uint16
above, so one pair of kernels serves every band up to 65534. Unlike the
TPU kernels, the strips carry no halo rows: pass 2 reads rows outside the
image as saturated itself.

A wrapper runs the plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises; it never falls back. ``LAUNCHES``
counts kernel launches, one per launch, so a run can show that it went
through the kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from chaq_sdfgen_tpu_torch.ops import _build, edt, merge
from chaq_sdfgen_tpu_torch.ops.numerics import refined_sqrt

LAUNCHES = {"edt_rows": 0, "edt_band_bytes": 0}

MAX_BAND = 65534  # band + 1 must fit the uint16 strips
_MAX_BATCH = 65535  # gridDim.z


def strip_dtype(band: int) -> torch.dtype:
    return torch.uint8 if band + 1 <= 255 else torch.uint16


def _check_band(band: int) -> None:
    if band < 0 or band > MAX_BAND:
        raise ValueError(f"band must be in [0, {MAX_BAND}], got {band}")


def _canonical_codes(b: torch.Tensor) -> torch.Tensor:
    """bool -> {0, 1} uint8 codes (a view: a bool is stored as one byte,
    0 or 1); uint8 tri-state codes (1 seeds TRUE, 0 seeds FALSE, 2 seeds
    neither) pass through."""
    if b.dtype == torch.bool:
        return b.view(torch.uint8)
    if b.dtype != torch.uint8:
        raise TypeError(f"expected a bool mask or uint8 codes, got {b.dtype}")
    return b


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.dim() < 2:
            raise ValueError(f"{name}: expected (..., H, W), got shape {tuple(t.shape)}")


def _launch(entry: str, device: torch.device, *args) -> None:
    """Call a launcher of the kernels' library (built at first use) on
    the current stream of ``device``; raise if the launch failed."""
    lib = _build.load()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with cudaError {rc}")


def _flat(t: torch.Tensor) -> Tuple[int, int, int]:
    h, w = t.shape[-2:]
    n = t.numel() // max(h * w, 1)
    if n > _MAX_BATCH:
        raise ValueError(f"batch of {n} images exceeds {_MAX_BATCH}")
    return n, h, w


# --------------------------------------------------------------------- pass 1


def row_distances_u8_plain(b: torch.Tensor, band: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain pass 1 on any device: (din, dout), each (..., H, W) of
    strip_dtype(band), clipped at min(band + 1, max of that dtype)."""
    _check_band(band)
    codes = _canonical_codes(b)
    dtype = strip_dtype(band)
    clip = min(band + 1, 255 if dtype == torch.uint8 else 65535)
    din = edt.row_nearest(codes == 1, clip).to(dtype)
    dout = edt.row_nearest(codes == 0, clip).to(dtype)
    return din, dout


def row_distances_u8(b: torch.Tensor, band: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1: (..., H, W) bool mask or uint8 tri-state codes -> (din, dout)
    of strip_dtype(band): the distance along x to the nearest TRUE (code 1)
    and the nearest FALSE (code 0) pixel, clipped at min(band + 1, max of
    the dtype). Kernel ``edt_rows`` on CUDA, the plain version on the CPU."""
    if b.device.type == "cpu":
        return row_distances_u8_plain(b, band)
    if b.device.type != "cuda":
        raise ValueError(f"row_distances_u8: unsupported device {b.device}")
    _check_band(band)
    codes = _canonical_codes(b)
    _check_cuda("row_distances_u8", codes)
    dtype = strip_dtype(band)
    din = torch.empty(codes.shape, dtype=dtype, device=codes.device)
    dout = torch.empty_like(din)
    n, h, w = _flat(codes)
    if codes.numel() == 0:
        return din, dout
    clip = min(band + 1, 255 if dtype == torch.uint8 else 65535)
    _launch("chaq_edt_rows", codes.device, codes.data_ptr(), din.data_ptr(), dout.data_ptr(),
            n, h, w, clip, din.element_size())
    LAUNCHES["edt_rows"] += 1
    return din, dout


# --------------------------------------------------------------------- pass 2


def fused_pass2_bytes_plain(
    din: torch.Tensor, dout: torch.Tensor, spread: int, asymmetric: bool, band: int,
    apply_sqrt: bool = True,
) -> torch.Tensor:
    """Plain pass 2 on any device: (..., H, W) strips -> (..., H, W) uint8."""
    _check_band(band)
    clip = band + 1

    def squares(d):
        d = torch.clamp(d.to(torch.int32), max=clip).to(torch.float32)
        return d * d

    d_in = edt.band_min_columns(squares(din), band)
    d_out = edt.band_min_columns(squares(dout), band)
    if apply_sqrt:
        d_in, d_out = refined_sqrt(d_in), refined_sqrt(d_out)
    return merge.remap_to_byte(merge.signed_merge(d_out, d_in), spread, asymmetric)


def fused_pass2_bytes(
    din: torch.Tensor, dout: torch.Tensor, spread: int, asymmetric: bool, band: int,
    apply_sqrt: bool = True,
) -> torch.Tensor:
    """Pass 2: row-distance strips (..., H, W) uint8 or uint16 -> final
    (..., H, W) uint8 bytes. D = min over |dy| <= band of dy^2 +
    min(d, band+1)^2 per field (rows outside the image read (band+1)^2),
    then the correctly rounded sqrt (skipped when ``apply_sqrt`` is False:
    the reference's single-row quirk), the -1-biased signed merge and the
    clamped remap. Kernel ``edt_band_bytes`` on CUDA, the plain version on
    the CPU."""
    if din.device.type == "cpu":
        return fused_pass2_bytes_plain(din, dout, spread, asymmetric, band, apply_sqrt)
    if din.device.type != "cuda":
        raise ValueError(f"fused_pass2_bytes: unsupported device {din.device}")
    _check_band(band)
    _check_cuda("fused_pass2_bytes", din, dout)
    if din.shape != dout.shape or din.dtype != dout.dtype:
        raise ValueError("fused_pass2_bytes: din and dout must match in shape and dtype")
    if din.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"fused_pass2_bytes: strips must be uint8 or uint16, got {din.dtype}")
    out = torch.empty(din.shape, dtype=torch.uint8, device=din.device)
    n, h, w = _flat(din)
    if din.numel() == 0:
        return out
    s_min = 0.0 if asymmetric else -float(spread)
    _launch("chaq_edt_band_bytes", din.device, din.data_ptr(), dout.data_ptr(), out.data_ptr(),
            n, h, w, band, s_min, float(spread), int(apply_sqrt), din.element_size())
    LAUNCHES["edt_band_bytes"] += 1
    return out


# ------------------------------------------------------------------ pipeline


def _as_mask(b: torch.Tensor) -> torch.Tensor:
    """Any mask -> bool (nonzero is TRUE), so that a 0/255 mask never
    reaches pass 1 as tri-state codes."""
    return b if b.dtype == torch.bool else b != 0


def fused_sdf_bytes_plain(
    b: torch.Tensor, spread: int, asymmetric: bool = False, band: int | None = None
) -> torch.Tensor:
    """fused_sdf_bytes through the plain versions, on any device."""
    band = band if band is not None else spread + 2
    din, dout = row_distances_u8_plain(_as_mask(b), band)
    return fused_pass2_bytes_plain(din, dout, spread, asymmetric, band, b.shape[-2] > 1)


def fused_sdf_bytes(
    b: torch.Tensor, spread: int, asymmetric: bool = False, band: int | None = None
) -> torch.Tensor:
    """Hard EXACT pipeline: (..., H, W) mask (bool, or any dtype with
    nonzero as TRUE) -> (..., H, W) uint8, byte-identical to the OpenMP
    reference (see ops/edt.py for the banding argument). band defaults to
    spread + 2 and may be at most 65534."""
    band = band if band is not None else spread + 2
    _check_band(band)
    din, dout = row_distances_u8(_as_mask(b), band)
    # single-row images: the reference never applies the pass-2 sqrt
    return fused_pass2_bytes(din, dout, spread, asymmetric, band, apply_sqrt=b.shape[-2] > 1)


def refined_sqrt_cuda(n: torch.Tensor) -> torch.Tensor:
    """The pass-2 kernel's sqrt tail alone on a CUDA float32 tensor (a test
    entry: the exhaustive check against numerics.refined_sqrt)."""
    if n.device.type != "cuda" or n.dtype != torch.float32 or not n.is_contiguous():
        raise ValueError("refined_sqrt_cuda: needs a contiguous float32 CUDA tensor")
    out = torch.empty_like(n)
    if n.numel() > 0:
        _launch("chaq_refined_sqrt_f32", n.device, n.data_ptr(), out.data_ptr(), n.numel())
    return out
