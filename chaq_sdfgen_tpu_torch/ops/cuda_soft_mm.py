"""The declared-range soft SDF's two kernels (csrc/soft_mm.cu), each beside
its plain PyTorch version (chaq_sdfgen_tpu/ops/pallas_soft_mm.py
counterparts).

  mm_fused_fwd  (..., H, W) f32 gray -> field, and the two d2 memos the
                backward needs (kernel ``soft_mm_fwd``);
  mm_fused_bwd  cotangent + memos + gray -> dgray (kernel ``soft_mm_bwd``);
  soft_field_mm_fused  the field under torch autograd, through both;
  sharded_mm_fused  the same over the shards of a mesh chain (the sharded
                tier's pallas_soft_mm.sharded_local_mm_fused(_2d)).

Unlike the TPU kernels, these work on the unpadded image with a zero
boundary (a pixel outside the image has zero occupancy): no dead-pixel
sentinel, no 128-multiple padding. That is exactly what the JAX padding
yields for live pixels. A shard's halo rides in its frame instead: both
kernels read an input frame of h_in rows and write h_out rows, output row
o being input row o + row_off, and a live window of the input frame marks
the pixels inside the image (zero occupancy, and zero dgray, outside it).
A single-device call is the frame with no halo and the whole image live.

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


def _frame(name, h_in, w, row_off, h_out, window):
    """(h_out, (ylo, yhi, xlo, xhi)) with the defaults: every input row out,
    the whole input frame live."""
    h_out = h_in - row_off if h_out is None else int(h_out)
    ylo, yhi, xlo, xhi = (0, h_in, 0, w) if window is None else (int(v) for v in window)
    if h_out < 0:
        raise ValueError(f"{name}: {h_out} output rows")
    return h_out, (max(ylo, 0), min(yhi, h_in), max(xlo, 0), min(xhi, w))


def _live(window, rows, cols, row_off, device):
    """(rows, cols) bool: the pixels of a frame whose input-frame position
    (row + row_off, col) lies inside the window; None when all do."""
    ylo, yhi, xlo, xhi = window
    y = torch.arange(rows, device=device) + row_off
    x = torch.arange(cols, device=device)
    live = ((y >= ylo) & (y < yhi))[:, None] & ((x >= xlo) & (x < xhi))[None, :]
    return None if bool(live.all()) else live


# ------------------------------------------------------------------ forward


def mm_fused_fwd_plain(gray, shift, k1, k2, tau, temperature, eps, test_above=True, memos=True,
                       row_off=0, h_out=None, window=None):
    """Plain forward on any device (soft_mxu.soft_field_collapsed on the
    frame): the occupancy of the input frame, zero outside the window, the
    convs, the output rows, the tails."""
    h_out, window = _frame("mm_fused_fwd", gray.shape[-2], gray.shape[-1], row_off, h_out, window)
    w1 = soft_mxu.tap_weights(k1, temperature)
    w2 = soft_mxu.tap_weights(k2, temperature)
    _, e_in, e_out = soft_mxu.occupancy(gray, tau, temperature, shift, test_above)
    live = _live(window, gray.shape[-2], gray.shape[-1], 0, gray.device)
    if live is not None:
        zero = torch.zeros((), device=gray.device)
        e_in, e_out = torch.where(live, e_in, zero), torch.where(live, e_out, zero)
    field, d2i, d2o = soft_mxu.tails(soft_mxu.conv_cols(soft_mxu.conv_rows(e_in, w1), w2, row_off, h_out),
                                     soft_mxu.conv_cols(soft_mxu.conv_rows(e_out, w1), w2, row_off, h_out),
                                     temperature, shift, eps)
    return (field, d2i, d2o) if memos else field


def mm_fused_fwd(gray, shift, k1, k2, tau, temperature, eps, test_above=True, memos=True,
                 row_off=0, h_out=None, window=None):
    """(..., h_in, W) float32 gray -> field, or (field, d2_in, d2_out) with
    ``memos``, each (..., h_out, W): the shifted occupancy, the rows conv
    (radius k1), the cols conv (radius k2), d2 = c - T log(s) (1e30 where
    nothing is live), d = sqrt(relu(d2) + eps) and field = d_out -
    relu(d_in - 1). ``shift`` is c, a runtime argument of the kernel.
    Output row o is input row o + row_off (h_out default: h_in - row_off);
    ``window`` (ylo, yhi, xlo, xhi) of the input frame is live (default:
    all). Kernel ``soft_mm_fwd`` on CUDA, the plain version on the CPU;
    either way, radii up to MAX_TAPS."""
    _check_taps("mm_fused_fwd", k1, k2)
    if gray.device.type == "cpu":
        return mm_fused_fwd_plain(gray, shift, k1, k2, tau, temperature, eps, test_above, memos,
                                  row_off, h_out, window)
    _check("mm_fused_fwd", gray)
    n, h_in, w = _build.flat_shape(gray)
    h_out, (ylo, yhi, xlo, xhi) = _frame("mm_fused_fwd", h_in, w, row_off, h_out, window)
    shape = gray.shape[:-2] + (h_out, w)
    field = gray.new_empty(shape)
    d2i = gray.new_empty(shape) if memos else None
    d2o = gray.new_empty(shape) if memos else None
    if field.numel() > 0:
        _build.launch(
            "chaq_soft_mm_fwd", gray.device, gray.data_ptr(), field.data_ptr(),
            d2i.data_ptr() if memos else None, d2o.data_ptr() if memos else None,
            n, h_in, h_out, w, row_off, ylo, yhi, xlo, xhi, k1, k2, _taps(k1, k2, temperature),
            float(tau), float(temperature), float(eps), float(shift), int(test_above),
        )
        LAUNCHES["soft_mm_fwd"] += 1
    return (field, d2i, d2o) if memos else field


# ----------------------------------------------------------------- backward


def mm_fused_bwd_plain(ct, d2_in, d2_out, gray, shift, k1, k2, tau, temperature, eps, test_above=True,
                       row_off=0, window=None):
    """Plain backward on any device: the kernel's arithmetic written out.

    The tails' VJP per pixel of the cotangent's frame from ct and the memos
    (soft_mxu.tails_vjp), zero outside the window, then the transposed
    convs -- which are the convs themselves (symmetric taps, zero boundary),
    and which commute (separable), so the rows conv runs first, as in the
    forward -- onto gray's rows, then the occupancy VJP, zero outside the
    window."""
    h_out = gray.shape[-2]
    _, window = _frame("mm_fused_bwd", ct.shape[-2], ct.shape[-1], row_off, h_out, window)
    w1 = soft_mxu.tap_weights(k1, temperature)
    w2 = soft_mxu.tap_weights(k2, temperature)
    zero = torch.zeros((), device=ct.device)
    ds_in, ds_out = soft_mxu.tails_vjp(ct, d2_in, d2_out, temperature, shift, eps)
    live = _live(window, ct.shape[-2], ct.shape[-1], 0, ct.device)
    if live is not None:
        ds_in, ds_out = torch.where(live, ds_in, zero), torch.where(live, ds_out, zero)
    de_in = soft_mxu.conv_cols(soft_mxu.conv_rows(ds_in, w1), w2, row_off, h_out)
    de_out = soft_mxu.conv_cols(soft_mxu.conv_rows(ds_out, w1), w2, row_off, h_out)
    l, e_in, e_out = soft_mxu.occupancy(gray, tau, temperature, shift, test_above)
    dg = div(de_in * e_in * torch.sigmoid(-l) - de_out * e_out * torch.sigmoid(l), tau)
    dg = dg if test_above else -dg
    live = _live(window, h_out, gray.shape[-1], row_off, ct.device)
    return dg if live is None else torch.where(live, dg, zero)


def mm_fused_bwd(ct, d2_in, d2_out, gray, shift, k1, k2, tau, temperature, eps, test_above=True,
                 row_off=0, window=None):
    """dgray (gray's shape, (..., h_out, W)) from the field's cotangent and
    the forward's d2 memos (..., h_in, W) and the gray input, all float32:
    output row o is cotangent row o + row_off; ``window`` (ylo, yhi, xlo,
    xhi) of the cotangent's frame is live (default: all). Kernel
    ``soft_mm_bwd`` on CUDA, the plain version on the CPU; either way,
    radii up to MAX_TAPS."""
    _check_taps("mm_fused_bwd", k1, k2)
    if ct.device.type == "cpu":
        return mm_fused_bwd_plain(ct, d2_in, d2_out, gray, shift, k1, k2, tau, temperature, eps,
                                  test_above, row_off, window)
    _check("mm_fused_bwd", ct, d2_in, d2_out)
    _check("mm_fused_bwd", gray)
    n, h_in, w = _build.flat_shape(ct)
    h_out, (ylo, yhi, xlo, xhi) = _frame("mm_fused_bwd", h_in, w, row_off, gray.shape[-2], window)
    if gray.shape[:-2] != ct.shape[:-2] or gray.shape[-1] != w or gray.device != ct.device:
        raise ValueError(f"mm_fused_bwd: gray {tuple(gray.shape)} does not fit the cotangent's frame "
                         f"{tuple(ct.shape)}")
    dgray = torch.empty_like(gray)
    if gray.numel() > 0:
        _build.launch(
            "chaq_soft_mm_bwd", gray.device, ct.data_ptr(), d2_in.data_ptr(), d2_out.data_ptr(),
            gray.data_ptr(), dgray.data_ptr(), n, h_in, h_out, w, row_off, ylo, yhi, xlo, xhi, k1, k2,
            _taps(k1, k2, temperature), float(tau), float(temperature), float(eps), float(shift),
            int(test_above),
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


class _MmFusedChain(torch.autograd.Function):
    """The kernels over the shards of a mesh's chains along 'y', one node
    for every local shard (the custom VJP of pallas_soft_mm._mm_fused
    inside shard_map). Forward: each shard's gray block with a k2-row gray
    halo of its neighbours ([k2 | block | k2], live in its window), the
    field of its own rows. Backward: each shard pulls its neighbours' k2
    edge rows of the cotangent (fill 0) and of both memos (fill 1e30), the
    three in one exchange, and writes the complete dgray of its own rows
    (the contributions through the neighbours' outputs included), so the
    halo inputs take no cotangent and each pixel's gradient sums its taps
    in the single-device order. Where a chain crosses processes, both
    exchanges take the other processes' rows by point-to-point, and the
    fills arrive only where the image ends."""

    @staticmethod
    def forward(ctx, params, frames, windows, *blocks):
        shift, k1, k2, tau, temperature, eps, test_above = params
        h = blocks[0].shape[-2]
        memos = any(ctx.needs_input_grad[3:])
        outs, saved = [], []
        for g, gext, win in zip(blocks, frames([blocks], k2, [0.0])[0], windows):
            res = mm_fused_fwd(gext, *params, memos=memos, row_off=k2, h_out=h, window=win)
            outs.append(res[0] if memos else res)
            saved += [g, res[1], res[2]] if memos else []
        ctx.params, ctx.frames, ctx.windows = params, frames, windows
        ctx.save_for_backward(*saved)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cts):
        k2 = ctx.params[2]
        saved = ctx.saved_tensors
        grays, d2is, d2os = saved[0::3], saved[1::3], saved[2::3]
        cts = [c.to(torch.float32).contiguous() for c in cts]
        ext = ctx.frames([cts, d2is, d2os], k2, [0.0, soft_mxu.PAD_D2, soft_mxu.PAD_D2])
        # every row of the frame is live: beyond the image the cotangent is 0
        # and the memos 1e30 (no tap); the columns keep the forward's window
        dgrays = [mm_fused_bwd(c, di, do, g, *ctx.params, row_off=k2,
                               window=(0, c.shape[-2]) + tuple(win[2:]))
                  for c, di, do, g, win in zip(*ext, grays, ctx.windows)]
        return (None, None, None, *dgrays)


def sharded_mm_fused(blocks, frames, windows, k1, k2, shift, tau, temperature, eps, test_above=True):
    """The declared-range field of each local shard of a mesh (a list of
    (..., H_local, W) float32 blocks, the mesh's in flat order) through the
    two kernels, differentiable with respect to every block (the sharded
    tier's pallas_soft_mm.sharded_local_mm_fused(_2d)). ``frames(arrays,
    rows, fills)`` is the halo exchange along 'y' for several such lists
    (sharded._soft_mm_fused over halo.halo_frames_many or
    cuda_halo.halo_frames_rdma_many): each list's [rows | block | rows]
    frames, each list with its fill; ``windows`` each shard's live (ylo,
    yhi, xlo, xhi) in its [k2 | block | k2] frame (sharded._live_span at
    its global position: the image's rows and, for a 2-D tile with its
    column halo, columns). Bitwise the single-device field on the shards'
    rows, and its gradient too."""
    _check_taps("sharded_mm_fused", k1, k2)
    blocks = [b.to(torch.float32).contiguous() for b in blocks]
    params = (float(shift), int(k1), int(k2), float(tau), float(temperature), float(eps), bool(test_above))
    return list(_MmFusedChain.apply(params, frames, tuple(tuple(w) for w in windows), *blocks))


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
