"""Differentiable (soft) SDF path (chaq_sdfgen_tpu/ops/softsdf.py): pixel
gradients flow from the output SDF back to input intensities.

Construction (mirrors the hard pipeline structurally):
  occupancy   o = sigmoid((v - 127.5)/tau)          (soft threshold)
  heights     h_in = -T log o,  h_out = -T log(1-o) (soft indicator)
  soft-min    D = -T log sum exp(-(dx^2+dy^2+h)/T)  (soft parabola envelope)
  distance    d = sqrt(relu(D) + eps)
  merge       s = d_out - relu(d_in - 1)            (the -1 bias, soft)

soft_sdf_field dispatches as the JAX package does on its accelerator
(chaq_sdfgen_tpu/ops/softsdf.py:218-372), on every device:
  1. a declared range inside the gamut with tap radii <= 16 runs the kernels
     of ops/cuda_soft_mm.py;
  2. a declared range inside the gamut with wider taps (up to 128) runs
     ops/soft_mxu.soft_field_wide, float32 matrix products and no kernel;
  3. otherwise, for band <= 112 and at least 2 rows, a runtime gate on the
     input's largest height picks the kernels of item 1 with a runtime shift
     or the four adaptive kernels of ops/soft_fused.py;
  4. everything else takes the composed path: the soft-min kernels of
     ops/softmin.py twice each way (pass 1 along x on both fields' heights in
     one launch, written into the two halves of S1; pass 2 along y on S1),
     with implicit sentinels: no pad, transpose or cat around them.
Each runs its kernels on CUDA and their plain versions on the CPU. Under a
profiler the path taken is the span ``soft.field.<path>`` (mm_fused, wide,
mm_rt, fused, cols) and the gate's read the span ``soft.gate``.

The streaming scan below (_band_softmin_fwd_impl, _BandSoftmin,
band_softmin_scan, soft_sdf_field_composed) is plain PyTorch on any device
and is no part of that dispatch: it serves the tests as the independent
oracle.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from chaq_sdfgen_tpu_torch.ops import cuda_soft_mm, merge, soft_fused, soft_mxu, softmin, threshold
from chaq_sdfgen_tpu_torch.ops.edt import big_sentinel
from chaq_sdfgen_tpu_torch.ops.numerics import div, softplus
from chaq_sdfgen_tpu_torch.utils.profiling import span

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
    """band_softmin_ext by the streaming scan, with the JAX custom VJP: the
    backward recomputes the softmax weights from the saved output instead of
    storing per-tap residuals, so memory stays O(n^2), not O(n^2 band)."""

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


def _pad_axis(g: torch.Tensor, band: int, axis: int) -> torch.Tensor:
    """``band`` sentinel heights on both sides of ``axis`` (the scan
    oracle's extension; the kernels read the sentinels implicitly)."""
    pad = [0, 0] * g.dim()
    pad[2 * (g.dim() - 1 - axis)] = pad[2 * (g.dim() - 1 - axis) + 1] = band
    return torch.nn.functional.pad(g, pad, value=_PAD_HEIGHT)


def _softmin_along(g: torch.Tensor, band: int, temperature: float, axis: int, implicit: bool) -> torch.Tensor:
    """The kernels of ops/softmin.py take the last two axes as they lie;
    another axis is moved to -2 and back, as the JAX package's 2-D path
    transposes."""
    axis = axis % g.dim()
    if axis >= g.dim() - 2:
        return softmin.band_softmin_fields(g, band, temperature, axis - g.dim(), implicit)
    return softmin.band_softmin_fields(g.movedim(axis, -2), band, temperature, -2, implicit).movedim(-2, axis)


def band_softmin_ext(gext: torch.Tensor, band: int, temperature: float, axis: int = -2) -> torch.Tensor:
    """band_softmin on a pre-extended input (``band`` extra entries on each
    side of ``axis``). Output is 2 band shorter along ``axis``. The soft-min
    kernels of ops/softmin.py (their plain versions on the CPU), under
    autograd."""
    return _softmin_along(gext, band, temperature, axis, False)


def band_softmin(g: torch.Tensor, band: int, temperature: float, axis: int = -2) -> torch.Tensor:
    """S(p) = -T log sum_{|d| <= band} exp(-(d^2 + g(p+d))/T) along
    ``axis``; out-of-range taps read the sentinel height 1e30 and contribute
    nothing (the kernels read them implicitly: nothing is padded)."""
    return _softmin_along(g, band, temperature, axis, True)


def band_softmin_scan(g: torch.Tensor, band: int, temperature: float, axis: int = -2) -> torch.Tensor:
    """band_softmin by the streaming scan (_BandSoftmin): plain PyTorch on
    any device, the tests' oracle."""
    axis = axis % g.dim()
    return _BandSoftmin.apply(_pad_axis(g, band, axis), band, float(temperature), axis)


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

    def edt_sq(h):
        return band_softmin_scan(band_softmin_scan(h, band, temperature, axis=-1), band, temperature, axis=-2)

    d2_in = edt_sq(h_in)
    d2_out = edt_sq(h_out)
    d_in = torch.sqrt(torch.clamp(d2_in, min=0) + eps)
    d_out = torch.sqrt(torch.clamp(d2_out, min=0) + eps)
    return d_out - torch.clamp(d_in - 1.0, min=0)


def cols_pass1(gray, band, tau, temperature, test_above=True):
    """Pass 1 of the composed path: (..., H, W) gray -> S1 of both fields
    side by side, (..., H, 2W): the heights, clipped at big_sentinel(band) =
    (band + 1)^2 as the JAX composed path clips them, and their soft-min
    along x, both fields in one launch each way, each written into (and its
    cotangent read from) its half of S1."""
    g = gray.to(torch.float32)
    big = big_sentinel(band)
    logits = threshold.soft_logits(g, tau=tau, test_above=test_above)
    heights = [threshold.soft_log_indicator_from_logits(logits, temperature, on, big) for on in (True, False)]
    return softmin.band_softmin_fields(heights, band, temperature, axis=-1, implicit=True)


def cols_tails(d2s, w, eps):
    """The composed path's tails: d2 of both fields side by side (..., H,
    2W) -> the field d_out - relu(d_in - 1), d = sqrt(relu(d2) + eps)."""
    d_in = torch.sqrt(torch.clamp(d2s[..., :w], min=0) + eps)
    d_out = torch.sqrt(torch.clamp(d2s[..., w:], min=0) + eps)
    return d_out - torch.clamp(d_in - 1.0, min=0)


def soft_field_cols(gray, band, tau, temperature, eps, test_above=True):
    """The composed path (JAX softsdf.py:345-372) of (..., H, W) gray of any
    value range, differentiable with respect to gray: cols_pass1, pass 2
    along y once, on both fields side by side (..., H, 2W), then cols_tails.
    A batch runs as one: the kernels take it in their grid (JAX runs its
    XLA scans there, the same function)."""
    s1 = cols_pass1(gray, band, tau, temperature, test_above)
    return cols_tails(band_softmin(s1, band, temperature, axis=-2), gray.shape[-1], eps)


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
    with span("soft.gate"), torch.no_grad():
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
    mild overshoot (e.g. SGD pixel updates) degrades gracefully. The module
    docstring lists the four paths and when each runs.
    """
    if gray.dim() < 2:
        raise ValueError(f"soft_sdf_field: expected (..., H, W), got shape {tuple(gray.shape)}")
    band = band if band is not None else spread + 2
    stats = soft_mxu.range_stats(band, tau, temperature, gray_range)
    if stats is not None:
        if cuda_soft_mm.mm_fused_ok(stats[0], stats[1]):
            with span("soft.field.mm_fused"):
                return cuda_soft_mm.soft_field_mm_fused(gray, band, tau, temperature, eps, test_above, gray_range)
        with span("soft.field.wide"):
            return soft_mxu.soft_field_wide(gray, band, tau, temperature, eps, test_above, gray_range)
    if soft_fused.fused_geometry_ok(gray, band):
        shift = runtime_gate(gray, band, tau, temperature)
        if shift is not None:
            with span("soft.field.mm_rt"):
                return cuda_soft_mm.soft_field_mm_rt(gray, shift, band, tau, temperature, eps, test_above)
        with span("soft.field.fused"):
            return soft_fused.soft_sdf_field_fused(gray, band, tau, temperature, eps, test_above)
    with span("soft.field.cols"):
        return soft_field_cols(gray, band, tau, temperature, eps, test_above)


def soft_sdf_bytes(
    gray: torch.Tensor, spread: int, asymmetric: bool = False, clamp: str = "tanh", **kw
) -> torch.Tensor:
    """Differentiable remapped output in [0, 255] float32 (the soft analogue
    of the reference's byte image)."""
    return merge.soft_remap(soft_sdf_field(gray, spread, **kw), spread, asymmetric, clamp=clamp)
