"""The banded Gaussian cols-conv kernels of the sharded declared-range tier
(csrc/band_conv.cu), each beside its plain PyTorch version
(chaq_sdfgen_tpu/ops/pallas_band_conv.py counterparts).

  cols_conv     sum_d w(d) e(y + row_off + d) over rows, zero outside e:
                the halo'd slab's interior (row_off = k) or the adjoint back
                onto the slab (row_off = -k) (kernel ``cols_conv``);
  p2_fused_fwd  the cols conv of both pass-1 sums of a halo'd (..., h + 2k,
                W) slab and the tails -> (field, d2_in, d2_out), each (...,
                h, W) (kernel ``p2_fused_fwd``);
  p2_fused_bwd  the tails' VJP from the cotangent and the memos (..., h, W),
                then the cols conv of both back onto the slab (..., h + 2k,
                W) (kernel ``p2_fused_bwd``).

w(d) = exp(-d^2/T) for |d| <= k (soft_mxu.tap_weights), radius up to
MAX_TAPS. soft_mxu.conv_cols_sym and soft_mxu.pass2_fused_sym put them
under autograd. Unlike the TPU kernels these take any (h, W): no 128-row
strips, no 16-row halo blocks, no padding.

The plain versions are written tap by tap in the kernels' order (d = -k ..
k), so the kernels match them bit for bit on the card. A wrapper runs the
plain version only for a tensor on the CPU. For a CUDA tensor it launches
the kernel or raises; it never falls back. ``LAUNCHES`` counts kernel
launches, one per launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from chaq_sdfgen_tpu_torch.ops import _build, soft_mxu

LAUNCHES = {"p2_fused_fwd": 0, "p2_fused_bwd": 0, "cols_conv": 0}

MAX_TAPS = 128  # tap radius the kernels take


@functools.lru_cache(maxsize=64)
def _taps(k: int, temperature: float):
    """The launchers' tap array, built once per (k, T): a launch needs it on
    the host every time."""
    w = soft_mxu.tap_weights(k, float(temperature))
    return (ctypes.c_float * len(w))(*w)


def _check(name, k, *tensors) -> bool:
    if not 0 <= k <= MAX_TAPS:
        raise ValueError(f"{name}: tap radius {k} outside [0, {MAX_TAPS}]")
    if not _build.float32_on_cuda(name, *tensors):
        return False
    for t in tensors:
        if t.shape != tensors[0].shape:
            raise ValueError(f"{name}: shapes {tuple(t.shape)} and {tuple(tensors[0].shape)} differ")
    return True


def _out_shape(name, x, h_out):
    if h_out < 0:
        raise ValueError(f"{name}: {h_out} output rows from an input of shape {tuple(x.shape)}")
    return x.shape[:-2] + (h_out, x.shape[-1])


# ------------------------------------------------------------------ cols_conv


def cols_conv_plain(e, k, temperature, row_off, h_out):
    """Plain cols_conv on any device (soft_mxu.conv_cols)."""
    return soft_mxu.conv_cols(e, soft_mxu.tap_weights(k, float(temperature)), row_off, h_out)


def cols_conv(e: torch.Tensor, k: int, temperature: float, row_off: Optional[int] = None,
              h_out: Optional[int] = None) -> torch.Tensor:
    """(..., h_in, W) float32 -> (..., h_out, W): out[y] = sum_{|d| <= k}
    w(d) e[y + row_off + d], zero outside e's rows. Default: the interior
    of a k-row halo'd slab (row_off = k, h_out = h_in - 2k). Kernel
    ``cols_conv`` on CUDA, the plain version on the CPU."""
    row_off = k if row_off is None else int(row_off)
    h_out = e.shape[-2] - 2 * k if h_out is None else int(h_out)
    shape = _out_shape("cols_conv", e, h_out)
    if not _check("cols_conv", k, e):
        return cols_conv_plain(e, k, temperature, row_off, h_out)
    out = e.new_empty(shape)
    n, h_in, w = _build.flat_shape(e)
    if out.numel() > 0 and e.numel() > 0:
        _build.launch("chaq_cols_conv", e.device, e.data_ptr(), out.data_ptr(), n, h_in, h_out, w, k,
                      row_off, _taps(k, float(temperature)))
        LAUNCHES["cols_conv"] += 1
    elif out.numel() > 0:
        out.zero_()
    return out


# ---------------------------------------------------------------- pass 2 fused


def p2_fused_fwd_plain(a_in, a_out, k, temperature, shift, eps, memos=True):
    """Plain p2_fused_fwd on any device: the cols conv of both sums, then
    soft_mxu.tails."""
    h_out = a_in.shape[-2] - 2 * k
    field, d2i, d2o = soft_mxu.tails(cols_conv_plain(a_in, k, temperature, k, h_out),
                                     cols_conv_plain(a_out, k, temperature, k, h_out),
                                     temperature, shift, eps)
    return (field, d2i, d2o) if memos else field


def p2_fused_fwd(a_in, a_out, k, temperature, shift, eps, memos=True):
    """Both pass-1 sums of a halo'd slab, (..., h + 2k, W) float32 ->
    field, or (field, d2_in, d2_out) with ``memos``, each (..., h, W):
    s = the cols conv (radius k) at the slab's interior rows, d2 = shift -
    T log s (1e30 where s <= 1e-30), d = sqrt(max(d2, 0) + eps), field =
    d_out - max(d_in - 1, 0). Kernel ``p2_fused_fwd`` on CUDA, the plain
    version on the CPU."""
    shape = _out_shape("p2_fused_fwd", a_in, a_in.shape[-2] - 2 * k)
    if not _check("p2_fused_fwd", k, a_in, a_out):
        return p2_fused_fwd_plain(a_in, a_out, k, temperature, shift, eps, memos)
    field = a_in.new_empty(shape)
    d2i = a_in.new_empty(shape) if memos else None
    d2o = a_in.new_empty(shape) if memos else None
    n, h_in, w = _build.flat_shape(a_in)
    if field.numel() > 0:
        _build.launch("chaq_p2_fused_fwd", a_in.device, a_in.data_ptr(), a_out.data_ptr(), field.data_ptr(),
                      d2i.data_ptr() if memos else None, d2o.data_ptr() if memos else None,
                      n, h_in, shape[-2], w, k, k, _taps(k, float(temperature)), float(temperature), float(eps),
                      float(shift))
        LAUNCHES["p2_fused_fwd"] += 1
    return (field, d2i, d2o) if memos else field


def p2_fused_bwd_plain(ct, d2_in, d2_out, k, temperature, shift, eps):
    """Plain p2_fused_bwd on any device: soft_mxu.tails_vjp, then the cols
    conv of both back onto the slab."""
    h_out = ct.shape[-2] + 2 * k
    ds_in, ds_out = soft_mxu.tails_vjp(ct, d2_in, d2_out, temperature, shift, eps)
    return (cols_conv_plain(ds_in, k, temperature, -k, h_out),
            cols_conv_plain(ds_out, k, temperature, -k, h_out))


def p2_fused_bwd(ct, d2_in, d2_out, k, temperature, shift, eps):
    """(da_in, da_out), each (..., h + 2k, W): the cotangents of both
    halo'd slabs, from the field's cotangent and the forward's memos, each
    (..., h, W) float32: the tails' VJP (soft_mxu.tails_vjp: dead windows
    give 0, never through the exp), then the cols conv of ds_in and ds_out
    at every slab row (the conv is its own adjoint). Kernel
    ``p2_fused_bwd`` on CUDA, the plain version on the CPU."""
    shape = _out_shape("p2_fused_bwd", ct, ct.shape[-2] + 2 * k)
    if not _check("p2_fused_bwd", k, ct, d2_in, d2_out):
        return p2_fused_bwd_plain(ct, d2_in, d2_out, k, temperature, shift, eps)
    da_in, da_out = ct.new_empty(shape), ct.new_empty(shape)
    n, h_in, w = _build.flat_shape(ct)
    if da_in.numel() > 0 and ct.numel() > 0:
        _build.launch("chaq_p2_fused_bwd", ct.device, ct.data_ptr(), d2_in.data_ptr(), d2_out.data_ptr(),
                      da_in.data_ptr(), da_out.data_ptr(), n, h_in, shape[-2], w, k, -k,
                      _taps(k, float(temperature)), float(temperature), float(eps), float(shift))
        LAUNCHES["p2_fused_bwd"] += 1
    elif da_in.numel() > 0:
        da_in.zero_()
        da_out.zero_()
    return da_in, da_out
