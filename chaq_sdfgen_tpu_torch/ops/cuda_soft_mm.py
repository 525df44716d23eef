"""The declared-range soft SDF's two kernels (csrc/soft_mm.cu), each beside
its plain PyTorch version (chaq_sdfgen_tpu/ops/pallas_soft_mm.py
counterparts).

  mm_fused_fwd  (..., H, W) f32 gray -> field, and the two d2 memos the
                backward needs (kernel ``soft_mm_fwd``);
  mm_fused_bwd  cotangent + memos + gray -> dgray (kernel ``soft_mm_bwd``);
  soft_field_mm_fused  the field under torch autograd, through both.

Unlike the TPU kernels, these work on the unpadded image with a zero
boundary (a pixel outside the image has zero occupancy): no dead-pixel
sentinel, no 128-multiple padding, no halo operands. That is exactly what
the JAX padding yields for live pixels.

A wrapper runs the plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises; it never falls back. ``LAUNCHES``
counts kernel launches, one per launch.
"""

from __future__ import annotations

import ctypes

import torch

from chaq_sdfgen_tpu_torch.ops import _build, soft_mxu
from chaq_sdfgen_tpu_torch.ops.numerics import div

LAUNCHES = {"soft_mm_fwd": 0, "soft_mm_bwd": 0}

MAX_TAPS = 16  # tap radius the kernels take (pallas_soft_mm._HK)
_LIVE_D2 = 1e29  # memos at or above this mark dead windows (d2 = 1e30)


def mm_fused_ok(k1: int, k2: int) -> bool:
    """Kernel gate: both tap radii within MAX_TAPS. The port has no
    geometry gate: any (..., H, W) runs."""
    return 0 <= k1 <= MAX_TAPS and 0 <= k2 <= MAX_TAPS


def soft_field_mm_ok(gray, band, tau, temperature, gray_range) -> bool:
    """Full gate: declared range in gamut for both passes AND taps fit."""
    if gray_range is None or gray.dim() < 2:
        return False
    stats = soft_mxu.range_stats(band, tau, temperature, gray_range)
    return stats is not None and mm_fused_ok(stats[0], stats[1])


def _taps(k1, k2, temperature):
    """Both tap vectors, each padded to 2 MAX_TAPS + 1, as the C array
    the launchers copy into the kernels' parameters."""
    n = 2 * MAX_TAPS + 1
    w1 = soft_mxu.tap_weights(k1, temperature)
    w2 = soft_mxu.tap_weights(k2, temperature)
    return (ctypes.c_float * (2 * n))(*w1, *[0.0] * (n - len(w1)), *w2, *[0.0] * (n - len(w2)))


def _check_taps(name, k1, k2):
    if not mm_fused_ok(k1, k2):
        raise ValueError(f"{name}: tap radii ({k1}, {k2}) outside [0, {MAX_TAPS}]")


def _check(name, *tensors):
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")
    _build.check_cuda(name, *tensors)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32 tensors, got {t.dtype}")
        if t.shape != tensors[0].shape:
            raise ValueError(f"{name}: shapes {tuple(t.shape)} and {tuple(tensors[0].shape)} differ")


# ------------------------------------------------------------------ forward


def mm_fused_fwd_plain(gray, shift, k1, k2, tau, temperature, eps, test_above=True, memos=True):
    """Plain forward on any device (soft_mxu.soft_field_collapsed)."""
    field, d2i, d2o = soft_mxu.soft_field_collapsed(
        gray, k1, k2, shift, tau, temperature, eps, test_above)
    return (field, d2i, d2o) if memos else field


def mm_fused_fwd(gray, shift, k1, k2, tau, temperature, eps, test_above=True, memos=True):
    """(..., H, W) float32 gray -> field, or (field, d2_in, d2_out) with
    ``memos``: the shifted occupancy, the rows conv (radius k1), the cols
    conv (radius k2), d2 = c - T log(s) (1e30 where nothing is live),
    d = sqrt(relu(d2) + eps) and field = d_out - relu(d_in - 1). ``shift``
    is c, a runtime argument of the kernel. Kernel ``soft_mm_fwd`` on
    CUDA, the plain version on the CPU; either way, radii up to MAX_TAPS."""
    _check_taps("mm_fused_fwd", k1, k2)
    if gray.device.type == "cpu":
        return mm_fused_fwd_plain(gray, shift, k1, k2, tau, temperature, eps, test_above, memos)
    _check("mm_fused_fwd", gray)
    field = torch.empty_like(gray)
    d2i = torch.empty_like(gray) if memos else None
    d2o = torch.empty_like(gray) if memos else None
    n, h, w = _build.flat_shape(gray)
    if gray.numel() > 0:
        _build.launch(
            "chaq_soft_mm_fwd", gray.device, gray.data_ptr(), field.data_ptr(),
            d2i.data_ptr() if memos else None, d2o.data_ptr() if memos else None,
            n, h, w, k1, k2, _taps(k1, k2, temperature), float(tau), float(temperature),
            float(eps), float(shift), int(test_above),
        )
        LAUNCHES["soft_mm_fwd"] += 1
    return (field, d2i, d2o) if memos else field


# ----------------------------------------------------------------- backward


def mm_fused_bwd_plain(ct, d2_in, d2_out, gray, shift, k1, k2, tau, temperature, eps, test_above=True):
    """Plain backward on any device: the kernel's arithmetic written out.

    The tails' VJP per pixel from ct and the memos (ds = ct_d2 (-T)
    exp((d2 - c)/T), zero in dead windows), then the transposed convs --
    which are the convs themselves (symmetric taps, zero boundary), and
    which commute (separable), so the rows conv runs first, as in the
    forward -- then the occupancy VJP."""
    w1 = soft_mxu.tap_weights(k1, temperature)
    w2 = soft_mxu.tap_weights(k2, temperature)
    zero = torch.zeros((), device=ct.device)

    def ds_of(d2, ct_d2):
        live = d2 < _LIVE_D2
        expo = torch.where(live, div(d2 - shift, temperature), zero)
        return torch.where(live, ct_d2 * (-temperature) * torch.exp(expo), zero)

    d_in = torch.sqrt(torch.where(d2_in > 0, d2_in, zero) + eps)
    d_out = torch.sqrt(torch.where(d2_out > 0, d2_out, zero) + eps)
    half = torch.full((), 0.5, device=ct.device)
    gate_i = torch.where(d2_in > 0, half, zero) / d_in
    gate_o = torch.where(d2_out > 0, half, zero) / d_out
    relu_on = torch.where(d_in > 1, torch.ones((), device=ct.device), zero)
    ds_in = ds_of(d2_in, -ct * relu_on * gate_i)
    ds_out = ds_of(d2_out, ct * gate_o)
    de_in = soft_mxu.conv_cols(soft_mxu.conv_rows(ds_in, w1), w2)
    de_out = soft_mxu.conv_cols(soft_mxu.conv_rows(ds_out, w1), w2)
    l, e_in, e_out = soft_mxu.occupancy(gray, tau, temperature, shift, test_above)
    dg = div(de_in * e_in * torch.sigmoid(-l) - de_out * e_out * torch.sigmoid(l), tau)
    return dg if test_above else -dg


def mm_fused_bwd(ct, d2_in, d2_out, gray, shift, k1, k2, tau, temperature, eps, test_above=True):
    """dgray from the field's cotangent, the forward's d2 memos and the
    gray input, all (..., H, W) float32. Kernel ``soft_mm_bwd`` on CUDA,
    the plain version on the CPU; either way, radii up to MAX_TAPS."""
    _check_taps("mm_fused_bwd", k1, k2)
    if ct.device.type == "cpu":
        return mm_fused_bwd_plain(ct, d2_in, d2_out, gray, shift, k1, k2, tau, temperature, eps,
                                  test_above)
    _check("mm_fused_bwd", ct, d2_in, d2_out, gray)
    dgray = torch.empty_like(gray)
    n, h, w = _build.flat_shape(gray)
    if gray.numel() > 0:
        _build.launch(
            "chaq_soft_mm_bwd", gray.device, ct.data_ptr(), d2_in.data_ptr(), d2_out.data_ptr(),
            gray.data_ptr(), dgray.data_ptr(), n, h, w, k1, k2, _taps(k1, k2, temperature),
            float(tau), float(temperature), float(eps), float(shift), int(test_above),
        )
        LAUNCHES["soft_mm_bwd"] += 1
    return dgray


# ----------------------------------------------------------------- autograd


class _MmFused(torch.autograd.Function):
    """The custom VJP of pallas_soft_mm._mm_fused: the forward writes the
    d2 memos only when gray needs a gradient; the backward returns None
    for the shift (its cotangent is exactly zero: c - T log(e^{c/T} ...)
    cancels c) and for the static parameters."""

    @staticmethod
    def forward(ctx, gray, shift, k1, k2, tau, temperature, eps, test_above):
        ctx.params = (shift, k1, k2, tau, temperature, eps, test_above)
        if not ctx.needs_input_grad[0]:
            return mm_fused_fwd(gray, *ctx.params, memos=False)
        field, d2i, d2o = mm_fused_fwd(gray, *ctx.params, memos=True)
        ctx.save_for_backward(gray, d2i, d2o)
        return field

    @staticmethod
    def backward(ctx, ct):
        gray, d2i, d2o = ctx.saved_tensors
        dgray = mm_fused_bwd(ct.to(torch.float32).contiguous(), d2i, d2o, gray, *ctx.params)
        return (dgray,) + (None,) * 7


def soft_field_mm_rt_ok(shape, band) -> bool:
    """Gate of the runtime-shift form (pallas_soft_mm.soft_field_mm_rt_ok):
    the port has no padding geometry, so only the tap radius min(MAX_TAPS,
    band) has to fit, and it always does."""
    kk = min(MAX_TAPS, int(band))
    return len(shape) >= 2 and mm_fused_ok(kk, kk)


def soft_field_mm_rt(gray, shift, band, tau, temperature, eps, test_above=True):
    """The declared-range kernels for an UNDECLARED range whose heights a
    runtime gate has found in gamut (pallas_soft_mm.soft_field_mm_rt): tap
    radius min(MAX_TAPS, band) for both passes (taps beyond the needed
    radius are exact terms of the banded sum) and the gate's shift, a
    launch argument of the kernels."""
    kk = min(MAX_TAPS, int(band))
    g = gray.to(torch.float32).contiguous()
    return _MmFused.apply(g, float(shift), kk, kk, float(tau), float(temperature), float(eps),
                          bool(test_above))


def soft_field_mm_fused(gray, band, tau, temperature, eps, test_above=True, gray_range=(0.0, 255.0)):
    """The bounded-range soft SDF field of (..., H, W) gray through the two
    kernels (their plain versions on the CPU), differentiable with respect
    to gray. Callers gate with soft_field_mm_ok; the wrappers refuse tap
    radii above MAX_TAPS."""
    k1, k2, shift = soft_mxu.range_stats(band, tau, temperature, gray_range)
    g = gray.to(torch.float32).contiguous()
    return _MmFused.apply(g, shift, k1, k2, float(tau), float(temperature), float(eps),
                          bool(test_above))
