"""The composed soft path's two kernels (csrc/softmin.cu), each beside its
plain PyTorch version (chaq_sdfgen_tpu/ops/pallas_soft.py counterparts): the
banded soft-min along the rows of a pre-extended height field and its VJP.

  softmin_col_fwd  gext (..., H + 2B, W) -> S (..., H, W) (kernel
                   ``softmin_col_fwd``);
  softmin_col_bwd  gext, S and the cotangent ct (..., H, W) -> dgext (...,
                   H + 2B, W) (kernel ``softmin_col_bwd``);
  band_softmin_col the soft-min along axis -2 under torch autograd, through
                   both.

For output row q and tap d = -B .. B, v_d = gext[q + B + d]:
    S[q] = m - T log sum_d exp(((m - v_d) - d^2) / T),  m = min_d (v_d + d^2),
    dgext[p] = sum_d exp(((S[q] - d^2) - gext[p]) / T) ct[q],  q = p - B - d,
a tap entering a sum only where its exponent is at least -27 (the TPU
kernels' _CUT: a weight below e^-27 of the largest). The TPU kernels cut
whole tap groups by a chunk bound; these cut per tap, which differs only in
taps below e^-27 relative and makes the kernels reproducible bit for bit.
The extension rows of gext are data (the caller's sentinels, 1e30), not
padding: nothing here pads the forward's input.

The plain versions are written tap by tap, in the kernels' order (d
ascending) and with their cut, so the kernels match them bit for bit on the
card. Each reads two bounds to the host, so that its loop covers only the
taps in reach.

A wrapper runs the plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises; it never falls back. ``LAUNCHES``
counts kernel launches, one per launch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from chaq_sdfgen_tpu_torch.ops import _build
from chaq_sdfgen_tpu_torch.ops.soft_fused import _reach, _scalars

LAUNCHES = {"softmin_col_fwd": 0, "softmin_col_bwd": 0}

_CUT = 27.0  # pallas_soft._CUT


def _out_rows(gext: torch.Tensor, band: int) -> int:
    if band < 0 or gext.dim() < 2 or gext.shape[-2] < 2 * band:
        raise ValueError(f"softmin: gext of shape {tuple(gext.shape)} has fewer than 2 band = "
                         f"{2 * band} rows along axis -2")
    return gext.shape[-2] - 2 * band


# ------------------------------------------------------------- plain versions


def softmin_col_fwd_plain(gext: torch.Tensor, band: int, temperature: float) -> torch.Tensor:
    """Plain forward on any device: the kernel's arithmetic written out."""
    h = _out_rows(gext, band)
    _, t, inv_t = _scalars(1.0, temperature)
    if gext.numel() == 0 or h == 0:
        return gext.new_zeros(tuple(gext.shape[:-2]) + (h, gext.shape[-1]))
    m = gext.narrow(-2, band, h)
    for d in range(1, band + 1):
        side = torch.minimum(gext.narrow(-2, band - d, h), gext.narrow(-2, band + d, h))
        m = torch.minimum(m, side + float(d * d))
    gap, it = np.float32(m.max().item()) - np.float32(gext.min().item()), np.float32(inv_t)
    r = _reach(lambda dd: (gap - dd) * it, band)
    s = torch.zeros_like(m)
    for d in range(-r, r + 1):
        z = ((m - gext.narrow(-2, band + d, h)) - float(d * d)) * inv_t
        s = s + torch.where(z >= -_CUT, torch.exp(z), 0.0)
    return m - t * torch.log(s)


def softmin_col_bwd_plain(gext, s, ct, band: int, temperature: float) -> torch.Tensor:
    """Plain backward on any device: the kernel's arithmetic written out.
    Rows of S outside [0, H) are no taps (-inf, cotangent 0)."""
    _out_rows(gext, band)
    _, _, inv_t = _scalars(1.0, temperature)
    if s.numel() == 0:
        return torch.zeros_like(gext)
    hext = gext.shape[-2]
    pad = (0, 0, 2 * band, 2 * band)
    sp, cp = F.pad(s, pad, value=float("-inf")), F.pad(ct, pad, value=0.0)
    smax, gmin = np.float32(s.max().item()), np.float32(gext.min().item())
    it = np.float32(inv_t)
    r = _reach(lambda dd: ((smax - dd) - gmin) * it, band)
    acc = torch.zeros_like(gext)
    for d in range(-r, r + 1):
        z = ((sp.narrow(-2, band - d, hext) - float(d * d)) - gext) * inv_t
        acc = acc + torch.where(z >= -_CUT, torch.exp(z), 0.0) * cp.narrow(-2, band - d, hext)
    return acc


# ------------------------------------------------------------------ wrappers


def _launch(entry, ref, *ptrs, h, band, temperature):
    n, _, w = _build.flat_shape(ref)
    _build.launch(entry, ref.device, *ptrs, n, h, w, band, *_scalars(1.0, temperature)[1:])


def softmin_col_fwd(gext: torch.Tensor, band: int, temperature: float) -> torch.Tensor:
    """(..., H + 2B, W) float32 -> S (..., H, W): the banded soft-min along
    axis -2. Kernel ``softmin_col_fwd`` on CUDA, the plain version on the
    CPU."""
    if not _build.float32_on_cuda("softmin_col_fwd", gext):
        return softmin_col_fwd_plain(gext, band, temperature)
    h = _out_rows(gext, band)
    out = gext.new_empty(tuple(gext.shape[:-2]) + (h, gext.shape[-1]))
    if out.numel() > 0:
        _launch("chaq_softmin_fwd", gext, gext.data_ptr(), out.data_ptr(), h=h, band=band,
                temperature=temperature)
        LAUNCHES["softmin_col_fwd"] += 1
    return out


def softmin_col_bwd(gext, s, ct, band: int, temperature: float) -> torch.Tensor:
    """dgext (..., H + 2B, W) from gext, the forward's S and the cotangent
    ct (..., H, W). Kernel ``softmin_col_bwd`` on CUDA, the plain version on
    the CPU."""
    if not _build.float32_on_cuda("softmin_col_bwd", gext, s, ct):
        return softmin_col_bwd_plain(gext, s, ct, band, temperature)
    h = _out_rows(gext, band)
    want = tuple(gext.shape[:-2]) + (h, gext.shape[-1])
    if tuple(s.shape) != want or tuple(ct.shape) != want:
        raise ValueError(f"softmin_col_bwd: S {tuple(s.shape)} and ct {tuple(ct.shape)}, expected {want}")
    if s.numel() == 0:
        return torch.zeros_like(gext)
    dg = torch.empty_like(gext)
    _launch("chaq_softmin_bwd", gext, gext.data_ptr(), s.data_ptr(), ct.data_ptr(), dg.data_ptr(), h=h,
            band=band, temperature=temperature)
    LAUNCHES["softmin_col_bwd"] += 1
    return dg


# ----------------------------------------------------------------- autograd


class _BandSoftminCol(torch.autograd.Function):
    """The custom VJP of softsdf._band_softmin_ext_p on its kernel path: the
    forward keeps gext and S (when gext needs a gradient), the backward
    recomputes the weights from S. T is a constant (the JAX VJP gives it a
    zero cotangent)."""

    @staticmethod
    def forward(ctx, gext, band, temperature):
        s = softmin_col_fwd(gext, band, temperature)
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(gext, s)
            ctx.params = (band, temperature)
        return s

    @staticmethod
    def backward(ctx, ct):
        gext, s = ctx.saved_tensors
        return softmin_col_bwd(gext, s, ct.to(torch.float32).contiguous(), *ctx.params), None, None


def band_softmin_col(gext: torch.Tensor, band: int, temperature: float) -> torch.Tensor:
    """The banded soft-min along axis -2 of a pre-extended (..., H + 2B, W)
    field, differentiable with respect to it, through the two kernels (their
    plain versions on the CPU)."""
    return _BandSoftminCol.apply(gext.to(torch.float32).contiguous(), int(band), float(temperature))
