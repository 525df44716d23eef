"""The composed soft path's two kernels (csrc/softmin.cu), each beside its
plain PyTorch version (chaq_sdfgen_tpu/ops/pallas_soft.py counterparts): the
banded soft-min along one axis of a height field and its VJP.

  softmin_col_fwd  g -> S (kernel ``softmin_col_fwd``);
  softmin_col_bwd  g, S and the cotangent ct -> dg (kernel
                   ``softmin_col_bwd``);
  band_softmin_fields, band_softmin_col
                   the soft-min under torch autograd, through both.

For output position q and tap d = -B .. B along the axis, v_d = g'[q + B + d]
with g' the field extended by B positions on each side:
    S[q] = m - T log sum_d exp(((m - v_d) - d^2) / T),  m = min_d (v_d + d^2),
    dg'[p] = sum_d exp(((S[q] - d^2) - g'[p]) / T) ct[q],  q = p - B - d,
a tap entering a sum only where its exponent is at least -27 (the TPU
kernels' _CUT: a weight below e^-27 of the largest). The TPU kernels cut
whole tap groups by a chunk bound; these cut per tap, which differs only in
taps below e^-27 relative and makes the kernels reproducible bit for bit.

Forms (keywords of both functions; the defaults are the original form):
  axis      -2 slides the taps along y, -1 along x;
  implicit  False: g is pre-extended, B extra positions on each side along
            the axis (data: the caller's sentinels or a shard's halo rows);
            True: g is the field itself and positions outside it read the
            sentinel 1e30; dg then covers the field only (F.pad's VJP);
  fields    g may be a tuple of one or two fields of one shape: one launch;
  out, out_col (forward) / s_col (backward)
            field f of S lies at columns out_col + f Wf .. of ``out`` (row
            pitch out.shape[-1]), Wf the field's output width; the backward
            reads S and ct at s_col + f Wf. By default a new S holds the
            fields side by side.

The plain versions are written tap by tap, in the kernels' order (d
ascending) and with their cut, so the kernels match them bit for bit on the
card. Each reads two bounds to the host, so that its loop covers only the
taps in reach.

A wrapper runs the plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises; it never falls back. The launcher
stages the strip in shared memory where it fits (``staged_fits``) and takes
the global-load instance of the same kernel past that; ``impl`` ("staged" or
"global") asks for one. ``LAUNCHES`` counts kernel launches, one per launch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from chaq_sdfgen_tpu_torch.ops import _build
from chaq_sdfgen_tpu_torch.ops.soft_fused import _reach, _scalars

LAUNCHES = {"softmin_col_fwd": 0, "softmin_col_bwd": 0}

_CUT = 27.0  # pallas_soft._CUT
_PAD = 1e30  # the sentinel height
_IMPLS = {"auto": 0, "staged": 1, "global": 2}
_MAX_SMEM = 232448  # a block's shared memory on sm_90


def staged_fits(band: int, axis: int = -2) -> bool:
    """Whether the staged instance of csrc/softmin.cu takes ``band`` along
    ``axis`` (the launcher takes the global-load instance past it). Along y
    a block's ring of floor((2 band + 127) / 16) + 9 segments of 16 x 32
    floats and their bounds must fit its shared memory: up to band 720.
    Along x a warp's ring holds the next power of two of floor((2 band +
    127) / 32) + 5 segments of 32 floats, at most 128: up to band 1920."""
    if axis == -2:
        return 4 * ((2 * band + 127) // 16 + 9) * (16 * 32 + 32) <= _MAX_SMEM
    return (2 * band + 127) // 32 + 5 <= 128


def _fields(g) -> tuple:
    fields = tuple(g) if isinstance(g, (tuple, list)) else (g,)
    if not 1 <= len(fields) <= 2 or any(f.shape != fields[0].shape for f in fields):
        raise ValueError("softmin: one or two fields of one shape")
    return fields


def _geometry(g: torch.Tensor, band: int, axis: int, implicit: bool) -> tuple:
    """(axis, npos, width): the axis as -2 or -1, the output positions
    along it and the output width of one field."""
    if axis not in (-2, -1):
        raise ValueError(f"softmin: axis must be -2 or -1, got {axis}")
    ext = 0 if implicit else 2 * band
    if band < 0 or g.dim() < 2 or g.shape[axis] < ext:
        raise ValueError(f"softmin: g of shape {tuple(g.shape)} has fewer than 2 band = {ext} positions "
                         f"along axis {axis}")
    npos = g.shape[axis] - ext
    return axis, npos, (g.shape[-1] if axis == -2 else npos)


def _out_shape(g: torch.Tensor, axis: int, npos: int, width: int) -> tuple:
    """(..., rows, width): one field's S."""
    rows = npos if axis == -2 else g.shape[-2]
    return tuple(g.shape[:-2]) + (rows, width)


def _check_out(name, out, want, col, nf, width):
    if tuple(out.shape[:-1]) != want[:-1] or col < 0 or col + nf * width > out.shape[-1]:
        raise ValueError(f"{name}: {tuple(out.shape)} cannot hold {nf} field(s) of {want} from column {col}")


def _extend(g: torch.Tensor, band: int, axis: int) -> torch.Tensor:
    """g with ``band`` sentinel positions on both sides of ``axis``."""
    pad = (band, band) if axis == -1 else (0, 0, band, band)
    return F.pad(g, pad, value=_PAD)


# ------------------------------------------------------------- plain versions


def _fwd_plain(gext: torch.Tensor, band: int, t: float, inv_t: float, axis: int, h: int) -> torch.Tensor:
    m = gext.narrow(axis, band, h)
    for d in range(1, band + 1):
        side = torch.minimum(gext.narrow(axis, band - d, h), gext.narrow(axis, band + d, h))
        m = torch.minimum(m, side + float(d * d))
    gap, it = np.float32(m.max().item()) - np.float32(gext.min().item()), np.float32(inv_t)
    r = _reach(lambda dd: (gap - dd) * it, band)
    s = torch.zeros_like(m)
    for d in range(-r, r + 1):
        z = ((m - gext.narrow(axis, band + d, h)) - float(d * d)) * inv_t
        s = s + torch.where(z >= -_CUT, torch.exp(z), 0.0)
    return m - t * torch.log(s)


def softmin_col_fwd_plain(gext, band: int, temperature: float, *, axis: int = -2, implicit: bool = False,
                          out=None, out_col: int = 0) -> torch.Tensor:
    """Plain forward on any device: the kernel's arithmetic written out,
    along ``axis``, on each field."""
    fields = _fields(gext)
    axis, h, width = _geometry(fields[0], band, axis, implicit)
    _, t, inv_t = _scalars(1.0, temperature)
    want = _out_shape(fields[0], axis, h, width)
    res = []
    for g in fields:
        if g.numel() == 0 or h == 0:
            res.append(g.new_zeros(want))
        else:
            res.append(_fwd_plain(_extend(g, band, axis) if implicit else g, band, t, inv_t, axis, h))
    if out is None:
        return res[0] if len(res) == 1 else torch.cat(res, -1)
    _check_out("softmin_col_fwd", out, want, out_col, len(res), width)
    for f, r in enumerate(res):
        out.narrow(-1, out_col + f * width, width).copy_(r)
    return out


def _bwd_plain(gext, s, ct, band: int, inv_t: float, axis: int) -> torch.Tensor:
    """Rows of S outside [0, H) are no taps (-inf, cotangent 0)."""
    hext = gext.shape[axis]
    pad = (2 * band, 2 * band) if axis == -1 else (0, 0, 2 * band, 2 * band)
    sp, cp = F.pad(s, pad, value=float("-inf")), F.pad(ct, pad, value=0.0)
    smax, gmin = np.float32(s.max().item()), np.float32(gext.min().item())
    it = np.float32(inv_t)
    r = _reach(lambda dd: ((smax - dd) - gmin) * it, band)
    acc = torch.zeros_like(gext)
    for d in range(-r, r + 1):
        z = ((sp.narrow(axis, band - d, hext) - float(d * d)) - gext) * inv_t
        acc = acc + torch.where(z >= -_CUT, torch.exp(z), 0.0) * cp.narrow(axis, band - d, hext)
    return acc


def softmin_col_bwd_plain(gext, s, ct, band: int, temperature: float, *, axis: int = -2, implicit: bool = False,
                          s_col: int = 0):
    """Plain backward on any device: the kernel's arithmetic written out,
    per field; a tensor for one field given as a tensor, else a tuple."""
    fields = _fields(gext)
    axis, h, width = _geometry(fields[0], band, axis, implicit)
    _, _, inv_t = _scalars(1.0, temperature)
    want = _out_shape(fields[0], axis, h, width)
    for name, a in (("S", s), ("ct", ct)):
        _check_out(f"softmin_col_bwd ({name})", a, want, s_col, len(fields), width)
    res = []
    for f, g in enumerate(fields):
        if s.numel() == 0 or h == 0 or width == 0:
            res.append(torch.zeros_like(g))
            continue
        sf, cf = s.narrow(-1, s_col + f * width, width), ct.narrow(-1, s_col + f * width, width)
        dg = _bwd_plain(_extend(g, band, axis) if implicit else g, sf, cf, band, inv_t, axis)
        res.append(dg.narrow(axis, band, h) if implicit else dg)
    return res[0] if isinstance(gext, torch.Tensor) else tuple(res)


# ------------------------------------------------------------------ wrappers


def _impl(impl: str, band: int, axis: int) -> int:
    if impl not in _IMPLS:
        raise ValueError(f"softmin: impl must be one of {tuple(_IMPLS)}, got {impl!r}")
    if impl == "staged" and not staged_fits(band, axis):
        raise ValueError(f"softmin: the staged strip does not fit a block's shared memory at band {band}")
    return _IMPLS[impl]


def _dims(g: torch.Tensor, axis: int, h: int) -> tuple:
    """(n, npos, nlanes) as the launchers take them."""
    n, rows, cols = _build.flat_shape(g)
    return n, h, (cols if axis == -2 else rows)


def softmin_col_fwd(gext, band: int, temperature: float, *, axis: int = -2, implicit: bool = False, out=None,
                    out_col: int = 0, impl: str = "auto") -> torch.Tensor:
    """The banded soft-min along ``axis`` of one or two fields (module
    docstring: forms). Kernel ``softmin_col_fwd`` on CUDA, the plain version
    on the CPU."""
    fields = _fields(gext)
    if not _build.float32_on_cuda("softmin_col_fwd", *fields, *(() if out is None else (out,))):
        return softmin_col_fwd_plain(gext, band, temperature, axis=axis, implicit=implicit, out=out,
                                     out_col=out_col)
    axis, h, width = _geometry(fields[0], band, axis, implicit)
    want = _out_shape(fields[0], axis, h, width)
    if out is None:
        out, out_col = fields[0].new_empty(want[:-1] + (len(fields) * width,)), 0
    _check_out("softmin_col_fwd", out, want, out_col, len(fields), width)
    mode = _impl(impl, band, axis)
    if fields[0].numel() > 0 and h > 0 and width > 0:
        n, npos, nlanes = _dims(fields[0], axis, h)
        _build.launch("chaq_softmin_fwd", out.device, fields[0].data_ptr(), fields[-1].data_ptr(), out.data_ptr(),
                      n, len(fields), npos, nlanes, band, int(axis == -1), int(implicit), out.shape[-1], out_col,
                      *_scalars(1.0, temperature)[1:], mode)
        LAUNCHES["softmin_col_fwd"] += 1
    return out


def softmin_col_bwd(gext, s, ct, band: int, temperature: float, *, axis: int = -2, implicit: bool = False,
                    s_col: int = 0, impl: str = "auto"):
    """dg of each field (its shape) from the fields, the forward's S and
    the cotangent ct (module docstring: forms); a tensor for a field given
    as a tensor, else a tuple. Kernel ``softmin_col_bwd`` on CUDA, the
    plain version on the CPU."""
    fields = _fields(gext)
    if not _build.float32_on_cuda("softmin_col_bwd", *fields, s, ct):
        return softmin_col_bwd_plain(gext, s, ct, band, temperature, axis=axis, implicit=implicit, s_col=s_col)
    axis, h, width = _geometry(fields[0], band, axis, implicit)
    want = _out_shape(fields[0], axis, h, width)
    for name, a in (("S", s), ("ct", ct)):
        _check_out(f"softmin_col_bwd ({name})", a, want, s_col, len(fields), width)
    if s.shape != ct.shape:
        raise ValueError(f"softmin_col_bwd: S {tuple(s.shape)} and ct {tuple(ct.shape)} differ")
    mode = _impl(impl, band, axis)
    if s.numel() == 0 or h == 0 or width == 0:
        dg = tuple(torch.zeros_like(g) for g in fields)
    else:
        dg = tuple(torch.empty_like(g) for g in fields)
        n, npos, nlanes = _dims(fields[0], axis, h)
        _build.launch("chaq_softmin_bwd", s.device, fields[0].data_ptr(), fields[-1].data_ptr(), s.data_ptr(),
                      ct.data_ptr(), dg[0].data_ptr(), dg[-1].data_ptr(), n, len(fields), npos, nlanes, band,
                      int(axis == -1), int(implicit), s.shape[-1], s_col, *_scalars(1.0, temperature)[1:], mode)
        LAUNCHES["softmin_col_bwd"] += 1
    return dg[0] if isinstance(gext, torch.Tensor) else dg


# ----------------------------------------------------------------- autograd


class _BandSoftmin(torch.autograd.Function):
    """The custom VJP of softsdf._band_softmin_ext_p on its kernel path, for
    one or two fields in one launch each way: the forward keeps the fields
    and S (when a field needs a gradient), the backward recomputes the
    weights from S. T is a constant (the JAX VJP gives it a zero
    cotangent)."""

    @staticmethod
    def forward(ctx, band, temperature, axis, implicit, *fields):
        s = softmin_col_fwd(fields, band, temperature, axis=axis, implicit=implicit)
        if any(ctx.needs_input_grad[4:]):
            ctx.save_for_backward(*fields, s)
            ctx.params = (band, temperature, axis, implicit)
        return s

    @staticmethod
    def backward(ctx, ct):
        *fields, s = ctx.saved_tensors
        band, temperature, axis, implicit = ctx.params
        dg = softmin_col_bwd(tuple(fields), s, ct.to(torch.float32).contiguous(), band, temperature, axis=axis,
                             implicit=implicit)
        return (None, None, None, None, *dg)


def band_softmin_fields(fields, band: int, temperature: float, axis: int = -2,
                        implicit: bool = False) -> torch.Tensor:
    """The banded soft-min along ``axis`` (-2 or -1) of one or two fields,
    differentiable with respect to them, through the two kernels (their
    plain versions on the CPU): S of the fields side by side."""
    fields = tuple(f.to(torch.float32).contiguous() for f in _fields(fields))
    return _BandSoftmin.apply(int(band), float(temperature), axis, bool(implicit), *fields)


def band_softmin_col(gext: torch.Tensor, band: int, temperature: float) -> torch.Tensor:
    """The banded soft-min along axis -2 of a pre-extended (..., H + 2B, W)
    field, differentiable with respect to it."""
    return band_softmin_fields(gext, band, temperature)
