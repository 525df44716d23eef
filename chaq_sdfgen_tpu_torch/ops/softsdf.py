"""Differentiable (soft) SDF path (chaq_sdfgen_tpu/ops/softsdf.py): pixel
gradients flow from the output SDF back to input intensities.

Construction (mirrors the hard pipeline structurally):
  occupancy   o = sigmoid((v - 127.5)/tau)          (soft threshold)
  heights     h_in = -T log o,  h_out = -T log(1-o) (soft indicator)
  soft-min    D = -T log sum exp(-(dx^2+dy^2+h)/T)  (soft parabola envelope)
  distance    d = sqrt(relu(D) + eps)
  merge       s = d_out - relu(d_in - 1)            (the -1 bias, soft)

soft_sdf_field dispatches as the JAX package does on its accelerator
(chaq_sdfgen_tpu/ops/softsdf.py:218-344), on every device: a declared range
inside the gamut runs ops/cuda_soft_mm.py; otherwise, for band <= 112, a
runtime gate on the input's largest height picks the same two kernels with
a runtime shift or the four adaptive kernels of ops/soft_fused.py. Each
runs its kernels on CUDA and their plain versions on the CPU. The composed
scan form below (band_softmin, soft_edt_sq, soft_sdf_field_composed) is
plain PyTorch on any device and serves the tests as the independent
oracle; the band > 112 path it stands for on the card is the place of TPU
kernels not yet ported (ROADMAP Queue 2 item 13), so soft_sdf_field refuses
such calls instead of running it there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from chaq_sdfgen_tpu_torch.ops import cuda_soft_mm, merge, soft_fused, soft_mxu, threshold
from chaq_sdfgen_tpu_torch.ops.edt import big_sentinel
from chaq_sdfgen_tpu_torch.ops.numerics import div, softplus

_PAD_HEIGHT = 1e30  # sentinel height: exp(-(d^2+1e30)/T) underflows to 0
_NEG_HUGE = -3e38


def _band_softmin_fwd_impl(gext: torch.Tensor, band: int, temperature: float, axis: int) -> torch.Tensor:
    """Streaming (max, sumexp) accumulation over the 2 band + 1 taps:
    numerically stable for any T."""
    axis = axis % gext.dim()
    h = gext.shape[axis] - 2 * band
    m = torch.full_like(gext.narrow(axis, band, h), _NEG_HUGE)
    s = torch.zeros_like(m)
    for k in range(2 * band + 1):
        dy = float(k - band)
        z = div(-(dy * dy + gext.narrow(axis, k, h)), temperature)
        m2 = torch.maximum(m, z)
        # rescale the previous sum; exp(_NEG_HUGE - m2) == 0 handles the init
        s = s * torch.exp(m - m2) + torch.exp(z - m2)
        m = m2
    return -temperature * (m + torch.log(torch.clamp(s, min=1e-38)))


class _BandSoftmin(torch.autograd.Function):
    """band_softmin_ext with the JAX custom VJP: the backward recomputes
    the softmax weights from the saved output instead of storing per-tap
    residuals, so memory stays O(n^2), not O(n^2 band)."""

    @staticmethod
    def forward(ctx, gext, band, temperature, axis):
        out = _band_softmin_fwd_impl(gext, band, temperature, axis)
        ctx.save_for_backward(gext, out)
        ctx.params = (band, temperature, axis % gext.dim())
        return out

    @staticmethod
    def backward(ctx, ct):
        gext, out = ctx.saved_tensors
        band, temperature, axis = ctx.params
        hext = gext.shape[axis]
        # out[q] consumed gext[q + k]: pad out and ct by 2 band on both
        # sides so that q = p - k is always in range
        pad = [0, 0] * gext.dim()
        pad[2 * (gext.dim() - 1 - axis)] = pad[2 * (gext.dim() - 1 - axis) + 1] = 2 * band
        outp = torch.nn.functional.pad(out, pad, value=_NEG_HUGE)
        ctp = torch.nn.functional.pad(ct, pad, value=0.0)
        acc = torch.zeros_like(gext)
        for k in range(2 * band + 1):
            dy = float(k - band)
            start = 2 * band - k
            s_tap = outp.narrow(axis, start, hext)
            c_tap = ctp.narrow(axis, start, hext)
            w = torch.exp(div(s_tap - dy * dy - gext, temperature))
            acc = acc + w * c_tap
        return acc, None, None, None


def band_softmin_ext(gext: torch.Tensor, band: int, temperature: float, axis: int = -2) -> torch.Tensor:
    """band_softmin on a pre-extended input (``band`` extra entries on each
    side of ``axis``). Output is 2 band shorter along ``axis``."""
    return _BandSoftmin.apply(gext, band, float(temperature), axis)


def band_softmin(g: torch.Tensor, band: int, temperature: float, axis: int = -2) -> torch.Tensor:
    """S(p) = -T log sum_{|d| <= band} exp(-(d^2 + g(p+d))/T) along
    ``axis``; out-of-range taps contribute exp(-inf) = 0."""
    axis = axis % g.dim()
    pad = [0, 0] * g.dim()
    pad[2 * (g.dim() - 1 - axis)] = pad[2 * (g.dim() - 1 - axis) + 1] = band
    gp = torch.nn.functional.pad(g, pad, value=_PAD_HEIGHT)
    return band_softmin_ext(gp, band, temperature, axis)


def soft_edt_sq(heights: torch.Tensor, band: int, temperature: float) -> torch.Tensor:
    """Two-pass separable soft squared EDT of a height field (..., H, W)."""
    return band_softmin(band_softmin(heights, band, temperature, axis=-1), band, temperature, axis=-2)


def soft_sdf_field_composed(
    gray: torch.Tensor,
    spread: int,
    tau: float = 1.0,
    temperature: float = 0.5,
    eps: float = 1e-6,
    test_above: bool = True,
    band: Optional[int] = None,
) -> torch.Tensor:
    """The composed scan form of the soft field, plain PyTorch on any
    device and any value range: the tests' oracle."""
    band = band if band is not None else spread + 2
    big = big_sentinel(band)
    logits = threshold.soft_logits(gray, tau=tau, test_above=test_above)
    h_in = threshold.soft_log_indicator_from_logits(logits, temperature, True, big)
    h_out = threshold.soft_log_indicator_from_logits(logits, temperature, False, big)
    d2_in = soft_edt_sq(h_in, band, temperature)
    d2_out = soft_edt_sq(h_out, band, temperature)
    d_in = torch.sqrt(torch.clamp(d2_in, min=0) + eps)
    d_out = torch.sqrt(torch.clamp(d2_out, min=0) + eps)
    return d_out - torch.clamp(d_in - 1.0, min=0)


def unported_reason(band: int, tau: float, temperature: float, gray_range, shape=None) -> Optional[str]:
    """Why soft_sdf_field refuses these parameters (and, when given, this
    input shape), or None when the ported kernels take them."""
    stats = soft_mxu.range_stats(band, tau, temperature, gray_range)
    if stats is not None:
        k1, k2, _ = stats
        if not cuda_soft_mm.mm_fused_ok(k1, k2):
            return (f"tap radii ({k1}, {k2}) exceed the kernels' {cuda_soft_mm.MAX_TAPS} "
                    f"(tau={tau}, T={temperature}); the wide-tap paths are not ported yet "
                    "(ROADMAP Queue 2 item 14)")
        return None
    if band > soft_fused.MAX_BAND:
        return (f"band {band} exceeds the adaptive kernels' {soft_fused.MAX_BAND}; the composed "
                "path that takes it (TPU kernels 12-13) is not ported yet (ROADMAP Queue 2 item 13)")
    if shape is not None and (len(shape) < 2 or shape[-2] < 2):
        return (f"an input of shape {tuple(shape)} has fewer than 2 rows; the composed path that "
                "takes it (TPU kernels 12-13) is not ported yet (ROADMAP Queue 2 item 13)")
    return None


_RT_SHIFT_T = 60.0  # the gate's shift: max(h_max - 60 T, 0)


def runtime_gate(gray: torch.Tensor, band: int, tau: float, temperature: float) -> Optional[float]:
    """The runtime range gate of the undeclared path (JAX softsdf.py:265-
    324): the shift for the declared-range kernels at tap radius kk =
    min(16, band) when the input's largest height h_max = T softplus(
    max |g - 127.5| / tau), over the whole batch, satisfies h_max <=
    min(140 T, kk^2 - 36 T); else None (the adaptive kernels). h_max is
    computed in float32 as JAX computes it and read to the host once: one
    synchronisation per call. Like the JAX gate it admits T = 0.5, where
    taps at d >= 7 underflow (ROADMAP Queue 3)."""
    t = float(temperature)
    kk = min(cuda_soft_mm.MAX_TAPS, int(band))
    limit = min(140.0 * t, kk * kk - 36.0 * t)
    if not (limit > 0 and cuda_soft_mm.soft_field_mm_rt_ok(gray.shape, band)) or gray.numel() == 0:
        return None
    with torch.no_grad():
        labs = div((gray.detach().to(torch.float32) - 127.5).abs().max(), tau)
        h_max = np.float32((t * softplus(labs)).item())
    if not h_max <= np.float32(limit):
        return None
    return float(max(h_max - np.float32(_RT_SHIFT_T * t), np.float32(0.0)))


def soft_sdf_field(
    gray: torch.Tensor,
    spread: int,
    tau: float = 1.0,
    temperature: float = 0.5,
    eps: float = 1e-6,
    test_above: bool = True,
    band: Optional[int] = None,
    gray_range: Optional[tuple] = None,
) -> torch.Tensor:
    """Signed soft distance field (float32) from raw gray values (..., H, W),
    differentiable with respect to gray.

    ``gray_range``: optional DECLARED (lo, hi) bound on the input values
    (the CLI/atlas u8 path passes (0, 255)); the caller guarantees it, and
    mild overshoot (e.g. SGD pixel updates) degrades gracefully. A range
    inside the gamut runs ops/cuda_soft_mm.py; None (trained images) or a
    range outside it goes through runtime_gate to the same kernels or to
    ops/soft_fused.py. Band > 112 and inputs of fewer than 2 rows on that
    path raise NotImplementedError (ROADMAP Queue 2 item 13).
    """
    band = band if band is not None else spread + 2
    reason = unported_reason(band, tau, temperature, gray_range, tuple(gray.shape))
    if reason is not None:
        raise NotImplementedError(f"soft_sdf_field: {reason}")
    if soft_mxu.range_stats(band, tau, temperature, gray_range) is not None:
        return cuda_soft_mm.soft_field_mm_fused(gray, band, tau, temperature, eps, test_above, gray_range)
    shift = runtime_gate(gray, band, tau, temperature)
    if shift is not None:
        return cuda_soft_mm.soft_field_mm_rt(gray, shift, band, tau, temperature, eps, test_above)
    return soft_fused.soft_sdf_field_fused(gray, band, tau, temperature, eps, test_above)


def soft_sdf_bytes(
    gray: torch.Tensor, spread: int, asymmetric: bool = False, clamp: str = "tanh", **kw
) -> torch.Tensor:
    """Differentiable remapped output in [0, 255] float32 (the soft analogue
    of the reference's byte image)."""
    return merge.soft_remap(soft_sdf_field(gray, spread, **kw), spread, asymmetric, clamp=clamp)
