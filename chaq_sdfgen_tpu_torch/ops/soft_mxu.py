"""The collapsed two-conv soft SDF (chaq_sdfgen_tpu/ops/soft_mxu.py), plain
PyTorch: the plain version of the kernel pair in ops/cuda_soft_mm.py.

For inputs with a DECLARED value range the heights are bounded,
h <= h_max = T softplus(max |logit|), so every tap that can contribute more
than exp(-_CUT) relative lies within K columns, and one GLOBAL shift
c = max(0, h_max - 60 T) keeps every term of the exp-sums inside float32.
Pass 1's log and pass 2's exp then cancel, and the soft EDT collapses to
two banded Gaussian convolutions of the shifted occupancy with one log at
the end:

    d2 = c - T log( Wcols (*) Wrows (*) exp(c/T) sigmoid(l) )

In soft_field_collapsed each conv is a sum of 2k+1 shifted, weighted
slices in float32 with zero fill at the border, in the order d = -k .. k,
one rounding per multiply and per add: no F.conv* and no matmul, which
cuDNN and cuBLAS may run in TF32 on the card. The kernels in
csrc/soft_mm.cu do the same arithmetic in the same order. torch autograd
through this form is the independent check of the backward kernel.

Tap radii above the kernels' 16 (up to 128) take soft_field_wide: the JAX
module's own einsum tail (its window matrix products against the band
matrix, self-adjoint VJPs), as torch.matmul in full float32; it refuses to
run when TF32 products are allowed. No Pallas kernel is on that path in
the JAX package either.

The sharded declared tier (parallel/sharded.py) runs the rows conv as such
a product (conv_rows_sym) and pass 2 on each shard's halo'd slab through
the kernels of ops/band_conv.py: pass2_fused_sym (cols conv and tails, tap
radius <= 16) or, for wider taps, conv_cols_sym and the tails.

The JAX module's corner-matrix variant and its pass2='kernel' branch are
TPU layout tricks and are not ported.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from chaq_sdfgen_tpu_torch.ops import threshold
from chaq_sdfgen_tpu_torch.ops.numerics import div

_BLK = 128
_CUT = 30.0  # tap-truncation exponent
# beyond this h_max/T the global shift cannot keep the max term
# representable in f32 (e^{c/T} <= e^85)
_HMAX_OVER_T_LIMIT = 140.0
# pass-2 value-bound margin: S1 >= -T log(2K+1) > -6T for any K <= _BLK
_P2_MARGIN_T = 6.0
_FLO = 1e-30  # live-window floor: the center tap alone gives >= e^-60
PAD_D2 = 1e30  # d2 of a fully dead window (no live pixel within the taps)
_LIVE_D2 = 1e29  # memos at or above this mark dead windows
_TINY = float(np.finfo(np.float32).tiny)


def _range_stats(band, tau, temperature, gray_range, margin=0.0) -> Optional[Tuple[int, float]]:
    """(K, shift c) for a declared input range; None when out of gamut.

    ``margin`` widens the value bound (in units of the raw height): pass 2
    consumes S1, which can dip below 0 by up to T log(#taps), so its tap
    cutoff needs the extra slack."""
    lo, hi = float(gray_range[0]), float(gray_range[1])
    t = float(temperature)
    labs = max(abs(lo - 127.5), abs(hi - 127.5)) / float(tau)
    h_max = t * (max(labs, 0.0) + math.log1p(math.exp(-abs(labs))))
    if h_max / t > _HMAX_OVER_T_LIMIT:
        return None
    k = min(int(math.ceil(math.sqrt(_CUT * t + h_max + margin))), int(band))
    if k > _BLK:
        return None
    c = max(0.0, h_max - 60.0 * t)
    return max(k, 1), c


def range_stats(band, tau, temperature, gray_range):
    """(k1, k2, shift) of both passes, or None when either is out of
    gamut (or no range is declared)."""
    if gray_range is None:
        return None
    s1 = _range_stats(band, tau, temperature, gray_range)
    s2 = _range_stats(band, tau, temperature, gray_range, margin=_P2_MARGIN_T * float(temperature))
    if s1 is None or s2 is None:
        return None
    return s1[0], s2[0], s1[1]


@functools.lru_cache(maxsize=64)
def tap_weights(k: int, temperature: float) -> Tuple[float, ...]:
    """The 2k+1 float32 taps w(d) = exp(-d^2/T), d = -k .. k, computed on
    the host as the JAX package's _wrow/_wcolt compute them. Subnormal
    taps are flushed to zero, as XLA and the TPU flush them. Cached: a
    kernel launch needs them on the host every time."""
    d = torch.arange(-k, k + 1, dtype=torch.float32)
    w = div(-(d * d), temperature).exp()
    return tuple(torch.where(w >= _TINY, w, torch.zeros(())).tolist())


def conv_rows(e: torch.Tensor, w: Sequence[float]) -> torch.Tensor:
    """sum_d w(d) e(y, x + d) over the last axis, zero outside."""
    k = (len(w) - 1) // 2
    n = e.shape[-1]
    ep = F.pad(e, (k, k))
    acc = torch.zeros_like(e)
    for i, wi in enumerate(w):
        acc = acc + wi * ep[..., i : i + n]
    return acc


def conv_cols(e: torch.Tensor, w: Sequence[float], row_off: int = 0,
              h_out: Optional[int] = None) -> torch.Tensor:
    """sum_d w(d) e(y + row_off + d, x) over the second-to-last axis, zero
    outside e's rows, for output rows y in [0, h_out) (default: e's rows,
    row_off 0). A halo'd slab's interior is row_off = k, h_out = rows - 2k;
    the adjoint back onto the slab is row_off = -k, h_out = rows + 2k."""
    k = (len(w) - 1) // 2
    n = e.shape[-2]
    h_out = n if h_out is None else h_out
    top, bot = max(0, k - row_off), max(0, h_out + row_off + k - n)
    ep = F.pad(e, (0, 0, top, bot))
    start = row_off - k + top
    acc = e.new_zeros(e.shape[:-2] + (h_out, e.shape[-1]))
    for i, wi in enumerate(w):
        acc = acc + wi * ep[..., start + i : start + i + h_out, :]
    return acc


def shift_over_t(shift: float, temperature: float) -> float:
    """c/T rounded once in float32, as the kernels compute it."""
    return float(np.float32(shift) / np.float32(temperature))


def occupancy(gray, tau, temperature, shift, test_above):
    """gray -> (l, e_in, e_out): the logits and the shifted occupancies
    exp(c/T + log sigmoid(l)) and exp(c/T + log sigmoid(-l)), with
    log sigmoid(+-l) = min(+-l, 0) - log1p(exp(-|l|)). Each exponent is
    formed as one sum, never as a product of exponentials, so it stays
    inside float32 from e^-60 to e^70. (The TPU kernel forms the second as
    c/T + log sigmoid(l) - l, equal in exact arithmetic; that difference
    cancels to an ulp of |l| where l << 0, and its autograd derivative,
    sigmoid(-l) - 1, loses all digits of the true -sigmoid(l) there.)

    The values are those of the kernels' min(+-l, 0) and |l|, bit for bit,
    but written as branches on l >= 0, so that autograd takes one smooth
    branch at l = 0 (gray exactly 127.5): through min and |.| it would add
    the subgradients of both kinks and double sigmoid(0) = 0.5 to 1."""
    l = threshold.soft_logits(gray, tau=tau, test_above=test_above)
    pos = l >= 0
    sp = torch.log1p(torch.exp(torch.where(pos, -l, l)))  # log1p(exp(-|l|))
    ct1 = shift_over_t(shift, temperature)
    e_in = torch.exp(ct1 + torch.where(pos, -sp, l - sp))
    e_out = torch.exp(ct1 + torch.where(pos, -l - sp, -sp))
    return l, e_in, e_out


def _safe_neglog(s, temperature, shift, dead_value):
    """shift - T log(s), with fully dead windows (s below a normal-range
    floor: nothing live within the taps) routed to ``dead_value``. The
    log never sees a non-positive argument on either pass of autograd."""
    live = s > _FLO
    s_safe = torch.where(live, s, torch.ones((), device=s.device))
    out = shift - temperature * torch.log(s_safe)
    return torch.where(live, out, torch.full((), dead_value, device=s.device))


def tails(s_in, s_out, temperature, shift, eps):
    """The two fields' conv sums -> (field, d2_in, d2_out): c - T log (1e30
    for dead windows), sqrt(max(d2, 0) + eps) and the merge d_out -
    max(d_in - 1, 0). Differentiable by torch autograd."""
    d2_in = _safe_neglog(s_in, temperature, shift, PAD_D2)
    d2_out = _safe_neglog(s_out, temperature, shift, PAD_D2)
    zero = torch.zeros((), device=s_in.device)
    # where(d2 > 0, d2, 0): max(d2, 0) with the kernel's zero gradient at 0
    d_in = torch.sqrt(torch.where(d2_in > 0, d2_in, zero) + eps)
    d_out = torch.sqrt(torch.where(d2_out > 0, d2_out, zero) + eps)
    field = d_out - torch.where(d_in > 1, d_in - 1.0, zero)
    return field, d2_in, d2_out


def tails_vjp(ct, d2_in, d2_out, temperature, shift, eps):
    """The tails' VJP as the kernels form it, from the field's cotangent and
    the d2 memos -> (ds_in, ds_out): ds = ct_d2 (-T) exp((d2 - c)/T), zero
    in dead windows (d2 >= 1e29, never through the exp)."""
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
    return ds_of(d2_in, -ct * relu_on * gate_i), ds_of(d2_out, ct * gate_o)


def soft_field_collapsed(gray, k1, k2, shift, tau, temperature, eps, test_above=True):
    """(..., H, W) float32 gray -> (field, d2_in, d2_out), each (..., H, W):
    occupancy, rows conv with radius k1, cols conv with radius k2,
    c - T log, sqrt, and the merge. Differentiable by torch autograd."""
    w1, w2 = tap_weights(k1, temperature), tap_weights(k2, temperature)
    _, e_in, e_out = occupancy(gray, tau, temperature, shift, test_above)
    return tails(conv_cols(conv_rows(e_in, w1), w2), conv_cols(conv_rows(e_out, w1), w2),
                 temperature, shift, eps)


# ------------------------------------------------ wide taps: matrix products


def require_fp32_matmul() -> None:
    """Raise unless float32 matrix products run in full float32: TF32 (or
    bf16) products shift the soft path's gradients at sigmoid-knee pixels
    far past its tolerance (the JAX package measured 16% of the scale with
    a 3-pass bf16 product, soft_mxu.py:54-58)."""
    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "soft_field_wide needs full float32 matrix products: "
            "torch.set_float32_matmul_precision('highest') and "
            "torch.backends.cuda.matmul.allow_tf32 = False")


@functools.lru_cache(maxsize=64)
def _band_matrix(k: int, temperature: float, device: torch.device) -> torch.Tensor:
    """(blk + 2k, blk) float32 on ``device``, blk = 128 (the JAX package's
    block for k > 16): W[j, q] = w(j - q - k) for |j - q - k| <= k, 0 beyond
    (JAX soft_mxu._band_matrix), from the tap weights. Cached per device: a
    copy from the host at each product would stall the host until the card
    drains its queue."""
    blk = _BLK
    w = torch.tensor(tap_weights(k, temperature), dtype=torch.float32)
    m = torch.zeros((blk + 2 * k, blk), dtype=torch.float32)
    for q in range(blk):
        m[q : q + 2 * k + 1, q] = w
    return m.to(device)


def _conv(e: torch.Tensor, k: int, temperature: float, cols: bool) -> torch.Tensor:
    """sum_d w(d) e(. + d) along the last axis (rows) or the one before it
    (cols), zero outside, as window matrix products (JAX soft_mxu._conv_rows
    and _conv_cols): each blk-wide block with k columns of each neighbour
    block times the band matrix. The axis length is a multiple of blk."""
    wmat = _band_matrix(k, float(temperature), e.device)
    blk = wmat.shape[1]
    if cols:
        e = e.transpose(-1, -2)
    *lead, n = e.shape
    eb = e.reshape(*lead, n // blk, blk)
    left = F.pad(eb[..., :-1, blk - k :], (0, 0, 1, 0))   # block b-1's last k, zeros at b = 0
    right = F.pad(eb[..., 1:, :k], (0, 0, 0, 1))          # block b+1's first k
    out = torch.matmul(torch.cat([left, eb, right], dim=-1), wmat).reshape(*lead, n)
    return out.transpose(-1, -2) if cols else out


class _ConvSym(torch.autograd.Function):
    """conv_rows_sym / conv_cols_sym as products (JAX soft_mxu.py:244-298):
    the taps are symmetric and the boundary is zero, so the conv is its own
    adjoint and the backward runs the same products on the cotangent."""

    @staticmethod
    def forward(ctx, e, k, temperature, cols):
        ctx.params = (k, temperature, cols)
        return _conv(e, k, temperature, cols)

    @staticmethod
    def backward(ctx, ct):
        return _conv(ct, *ctx.params), None, None, None


class _ColsConvSym(torch.autograd.Function):
    """conv_cols_sym (JAX soft_mxu.py:284-298) on a halo'd slab: the
    forward runs kernel ``cols_conv`` to the slab's interior, the backward
    the same kernel from the cotangent back onto the slab (the conv is its
    own adjoint)."""

    @staticmethod
    def forward(ctx, e, k, temperature):
        from chaq_sdfgen_tpu_torch.ops import band_conv

        ctx.params = (k, temperature)
        return band_conv.cols_conv(e, k, temperature)

    @staticmethod
    def backward(ctx, ct):
        from chaq_sdfgen_tpu_torch.ops import band_conv

        k, temperature = ctx.params
        ct = ct.to(torch.float32).contiguous()
        return band_conv.cols_conv(ct, k, temperature, -k, ct.shape[-2] + 2 * k), None, None


def conv_cols_sym(e: torch.Tensor, k: int, temperature: float) -> torch.Tensor:
    """(..., h + 2k, W) float32 halo'd slab -> (..., h, W): the banded
    Gaussian cols conv (radius k <= 128, zero boundary) at the interior
    rows, differentiable with respect to the slab through the kernel in
    both directions (its plain version on the CPU)."""
    return _ColsConvSym.apply(e.to(torch.float32).contiguous(), int(k), float(temperature))


class _Pass2FusedSym(torch.autograd.Function):
    """pass2_fused_sym (JAX soft_mxu.py:301-335): the forward runs kernel
    ``p2_fused_fwd`` and keeps the d2 memos when a slab needs a gradient;
    the backward runs kernel ``p2_fused_bwd`` from them."""

    @staticmethod
    def forward(ctx, a_in, a_out, k, temperature, shift, eps):
        from chaq_sdfgen_tpu_torch.ops import band_conv

        ctx.params = (k, temperature, shift, eps)
        if not any(ctx.needs_input_grad[:2]):
            return band_conv.p2_fused_fwd(a_in, a_out, *ctx.params, memos=False)
        field, d2i, d2o = band_conv.p2_fused_fwd(a_in, a_out, *ctx.params)
        ctx.save_for_backward(d2i, d2o)
        return field

    @staticmethod
    def backward(ctx, ct):
        from chaq_sdfgen_tpu_torch.ops import band_conv

        d2i, d2o = ctx.saved_tensors
        da_in, da_out = band_conv.p2_fused_bwd(ct.to(torch.float32).contiguous(), d2i, d2o, *ctx.params)
        return da_in, da_out, None, None, None, None


def pass2_fused_sym(a_in, a_out, k2, temperature, shift, eps) -> torch.Tensor:
    """Both pass-1 sums of a k2-row halo'd slab, (..., h + 2 k2, W) float32
    -> the field (..., h, W): the cols conv and the tails in one kernel each
    way (ops/band_conv.py; the plain versions on the CPU), differentiable
    with respect to both slabs."""
    return _Pass2FusedSym.apply(a_in.to(torch.float32).contiguous(), a_out.to(torch.float32).contiguous(),
                                int(k2), float(temperature), float(shift), float(eps))


def conv_rows_sym(e: torch.Tensor, k: int, temperature: float) -> torch.Tensor:
    """The rows conv (radius k, zero boundary) of (..., H, W) float32 with
    W a multiple of 128, as float32 matrix products, self-adjoint under
    autograd (JAX soft_mxu.conv_rows_sym). Raises if float32 products may
    run in TF32."""
    require_fp32_matmul()
    return _ConvSym.apply(e, int(k), float(temperature), False)


def soft_field_wide(gray, band, tau, temperature, eps, test_above=True, gray_range=(0.0, 255.0)):
    """The declared-range field with tap radii above the kernels' 16 (up to
    128): the non-fused tail of JAX soft_mxu.soft_sdf_field_mxu (pass2='mm',
    soft_mxu.py:487-556), the path the JAX package's gate picks there on
    one device. (..., H, W) gray, padded to multiples of 128 with dead
    (zero-occupancy) pixels; the shifted occupancy (``occupancy``, as the
    declared kernels form it); the rows conv (radius k1) and the cols conv
    (radius k2) as float32 matrix products with their self-adjoint VJPs;
    c - T log (1e30 for dead windows); the sqrt and merge tails. Differentiable with respect to gray by torch autograd; no
    kernel of this package. Raises if float32 products may run in TF32."""
    require_fp32_matmul()
    k1, k2, shift = range_stats(band, tau, temperature, gray_range)
    h, w = gray.shape[-2:]
    hp, wl = -(-max(h, _BLK) // _BLK) * _BLK, -(-max(w, _BLK) // _BLK) * _BLK
    g = F.pad(gray.to(torch.float32), (0, wl - w, 0, hp - h))
    _, e_in, e_out = occupancy(g, tau, temperature, shift, test_above)
    live = (torch.arange(hp, device=g.device)[:, None] < h) & (torch.arange(wl, device=g.device)[None, :] < w)
    zero = torch.zeros((), device=g.device)
    t = float(temperature)
    d = []
    for e in (e_in, e_out):
        s = _ConvSym.apply(_ConvSym.apply(torch.where(live, e, zero), k1, t, False), k2, t, True)
        d.append(torch.sqrt(torch.clamp(_safe_neglog(s, t, shift, PAD_D2), min=0) + eps))
    field = d[1] - torch.clamp(d[0] - 1.0, min=0)
    return field[..., :h, :w]

