"""Differentiable (soft) SDF path (chaq_sdfgen_tpu/ops/softsdf.py): pixel
gradients flow from the output SDF back to input intensities.

Construction (mirrors the hard pipeline structurally):
  occupancy   o = sigmoid((v - 127.5)/tau)          (soft threshold)
  heights     h_in = -T log o,  h_out = -T log(1-o) (soft indicator)
  soft-min    D = -T log sum exp(-(dx^2+dy^2+h)/T)  (soft parabola envelope)
  distance    d = sqrt(relu(D) + eps)
  merge       s = d_out - relu(d_in - 1)            (the -1 bias, soft)

soft_sdf_field runs the declared-range form (ops/cuda_soft_mm.py, its
kernels on CUDA, their plain versions on the CPU). The composed scan form
below (band_softmin, soft_edt_sq, soft_sdf_field_composed) is plain
PyTorch on any device and serves the tests as the independent oracle; on
the card the undeclared-range path it would stand in for is the place of
TPU kernels not yet ported (ROADMAP Queue 1 item 6), so soft_sdf_field
refuses such calls instead of running it there.
"""

from __future__ import annotations

from typing import Optional

import torch

from chaq_sdfgen_tpu_torch.ops import cuda_soft_mm, merge, soft_mxu, threshold
from chaq_sdfgen_tpu_torch.ops.edt import big_sentinel
from chaq_sdfgen_tpu_torch.ops.numerics import div

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


def unported_reason(band: int, tau: float, temperature: float, gray_range) -> Optional[str]:
    """Why soft_sdf_field refuses these parameters, or None when the
    declared-range kernels take them."""
    if gray_range is None:
        return ("the soft path without a declared gray_range (the runtime-gated "
                "undeclared-range path) is not ported yet (ROADMAP Queue 1 item 6)")
    stats = soft_mxu.range_stats(band, tau, temperature, gray_range)
    if stats is None:
        return (f"gray_range {tuple(gray_range)} is outside the declared-range gamut for "
                f"tau={tau}, T={temperature}; the adaptive undeclared-range path is not "
                "ported yet (ROADMAP Queue 1 item 6)")
    k1, k2, _ = stats
    if not cuda_soft_mm.mm_fused_ok(k1, k2):
        return (f"tap radii ({k1}, {k2}) exceed the kernels' {cuda_soft_mm.MAX_TAPS} "
                f"(tau={tau}, T={temperature}); the wide-tap paths are not ported yet "
                "(ROADMAP Queue 1 item 6, Queue 2 item 14)")
    return None


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

    ``gray_range``: DECLARED (lo, hi) bound on the input values (the
    CLI/atlas u8 path passes (0, 255)); the caller guarantees it, and mild
    overshoot (e.g. SGD pixel updates) degrades gracefully. A range inside
    the gamut runs ops/cuda_soft_mm.py on any device; None or an
    out-of-gamut range raises NotImplementedError (ROADMAP Queue 1 item 6).
    """
    band = band if band is not None else spread + 2
    reason = unported_reason(band, tau, temperature, gray_range)
    if reason is not None:
        raise NotImplementedError(f"soft_sdf_field: {reason}")
    return cuda_soft_mm.soft_field_mm_fused(
        gray, band, tau, temperature, eps, test_above, gray_range)


def soft_sdf_bytes(
    gray: torch.Tensor, spread: int, asymmetric: bool = False, clamp: str = "tanh", **kw
) -> torch.Tensor:
    """Differentiable remapped output in [0, 255] float32 (the soft analogue
    of the reference's byte image)."""
    return merge.soft_remap(soft_sdf_field(gray, spread, **kw), spread, asymmetric, clamp=clamp)
