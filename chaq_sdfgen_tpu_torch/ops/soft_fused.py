"""The undeclared-range soft SDF's four kernels (csrc/soft_fused.cu), each
beside its plain PyTorch version (chaq_sdfgen_tpu/ops/pallas_soft_fused.py
counterparts): the adaptive banded soft-min that serves any value range.

  f1_pass  (..., H, W) gray -> S1 (..., 2, H, W): the heights of both fields
           and their soft-min along x (kernel ``soft_f1``);
  f2_pass  S1 -> field (..., H, W) and the d2 memos (..., 2, H, W): the
           soft-min along y and the tails (kernel ``soft_f2``);
  b2_pass  cotangent, memos, S1 -> dS1: the tails' VJP and pass 2's
           (kernel ``soft_b2``);
  b1_pass  gray, S1, dS1 -> dgray: pass 1's VJP and the heights' and
           threshold's (kernel ``soft_b1``);
  soft_sdf_field_fused  the field under torch autograd, through all four;
  pass1_s1, pass2_ext  the sharded tier's split of it (F1 on a shard, then
           F2 on the shard's S1 with a halo of its neighbours' rows).

The soft-min of heights v along an axis, for |d| <= band,
    S = m - T log sum_d exp(((m - v[d]) - d^2) / T),  m = min_d (v[d] + d^2),
adds a tap only where its exponent is at least -27 (the JAX kernels'
_UNDERFLOW: a weight below e^-27 of the largest); the weight sums of the
backward cut the same way. Pixels outside the image are no taps (the TPU
kernels pad with height 1e30, which contributes nothing); heights are
clipped at 1e30 as the TPU kernels clip them. Unlike the TPU kernels, these
work on the unpadded image and keep dS1 in float32 (the JAX package stores
it as bf16). F1 and B1 take a live-row window (ylo, yhi), default every row:
a row outside it lies beyond the image (an edge shard's gray halo), F1 gives
it the clipped height 1e30 as its S1 and B1 a zero dgray.

The plain versions are written tap by tap, in the kernels' order and with
their cut, so the kernels match them bit for bit on the card. They compute
the hard min m without autograd: m's gradient, (1 - sum of the weights)
times dm, is zero in exact arithmetic, and only rounding through it. Each
plain pass reads one bound to the host, the last tap any pixel can add, so
that its loop (and autograd's memory) covers only the taps in reach.

A wrapper runs the plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises; it never falls back. ``LAUNCHES``
counts kernel launches, one per launch. Both refuse a band above MAX_BAND.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from chaq_sdfgen_tpu_torch.ops import _build

LAUNCHES = {"soft_f1": 0, "soft_f2": 0, "soft_b2": 0, "soft_b1": 0}

MAX_BAND = 112  # pallas_soft_fused.fused_geometry_ok: band <= _TM - 16
_CUT = 27.0  # pallas_soft_fused._UNDERFLOW
PAD_H = 1e30  # height clip (pallas_soft_fused._PAD_H)


def fused_geometry_ok(gray: torch.Tensor, band: int) -> bool:
    """The JAX gate of the adaptive kernels, with its thresholds: band <=
    112 and at least 2 rows. Batches (..., H, W) are taken whole."""
    return gray.dim() >= 2 and gray.shape[-2] >= 2 and 0 <= band <= MAX_BAND


def _scalars(tau, temperature, test_above=True):
    """(scale, T, 1/T) as the kernels take them, each rounded once to
    float32 (pallas_soft_fused._params): scale = +-1/tau, so that the
    logits are (g - 127.5) * scale."""
    inv_tau = float(np.float32(1.0 / float(tau)))
    return (inv_tau if test_above else -inv_tau, float(np.float32(temperature)),
            float(np.float32(1.0 / float(temperature))))


# ------------------------------------------------------------- plain versions


def _pad(x: torch.Tensor, band: int, dim: int, value: float) -> torch.Tensor:
    pad = [0, 0] * (-dim)
    pad[-1] = pad[-2] = band
    return F.pad(x, pad, value=value)


def _reach(ub, band: int) -> int:
    """The largest |d| <= band whose exponent bound ub(d) (float32, falling
    in d) still passes the cut: no tap beyond it can enter a sum."""
    r = 0
    while r < band and ub(np.float32((r + 1) * (r + 1))) >= -_CUT:
        r += 1
    return r


def _logits(gray: torch.Tensor, scale: float) -> torch.Tensor:
    return (gray.to(torch.float32) - 127.5) * scale


def _heights(l: torch.Tensor, t: float) -> torch.Tensor:
    """(..., 2, H, W): h_in = min(T softplus(-l), 1e30) and h_out = h_in +
    T l, the kernels' values bit for bit, with softplus written as branches
    on -l > 0 so that autograd takes sigmoid(0) = 1/2 at l = 0 (through
    max and |.| it would add the subgradients of both kinks)."""
    x = -l
    pos = x > 0
    zero = torch.zeros((), device=l.device)
    sp = torch.where(pos, x, zero) + torch.log(1.0 + torch.exp(torch.where(pos, -x, x)))
    h0 = torch.clamp(t * sp, max=PAD_H)
    return torch.stack([h0, h0 + t * l], dim=-3)


def _soft_min(v: torch.Tensor, band: int, t: float, inv_t: float, dim: int) -> torch.Tensor:
    """The banded soft-min of v along ``dim`` (negative), out-of-image taps
    excluded (+inf)."""
    if v.numel() == 0:
        return v.clone()
    n = v.shape[dim]
    vp = _pad(v, band, dim, float("inf"))
    with torch.no_grad():
        m = v.detach()
        for d in range(1, band + 1):
            side = torch.minimum(vp.narrow(dim, band - d, n), vp.narrow(dim, band + d, n))
            m = torch.minimum(m, side + float(d * d))
        gap = np.float32(m.max().item()) - np.float32(v.min().item())
    it = np.float32(inv_t)
    r = _reach(lambda dd: (gap - dd) * it, band)
    s = torch.zeros_like(m)
    for d in range(-r, r + 1):
        z = ((m - vp.narrow(dim, band + d, n)) - float(d * d)) * inv_t
        s = s + torch.where(z >= -_CUT, torch.exp(z), 0.0)
    return m - t * torch.log(s)


def _weight_sum(v, g, target, band: int, inv_t: float, dim: int) -> torch.Tensor:
    """sum_d exp(((v[d] - d^2) - target) / T) g[d] along ``dim`` over the
    taps that pass the cut; out-of-image taps excluded (v = -inf, g = 0)."""
    if v.numel() == 0:
        return torch.zeros_like(target)
    n = v.shape[dim]
    vp = _pad(v, band, dim, float("-inf"))
    gp = _pad(g, band, dim, 0.0)
    vmax, tmin, it = np.float32(v.max().item()), np.float32(target.min().item()), np.float32(inv_t)
    r = _reach(lambda dd: ((vmax - dd) - tmin) * it, band)
    s = torch.zeros_like(target)
    for d in range(-r, r + 1):
        z = ((vp.narrow(dim, band + d, n) - float(d * d)) - target) * inv_t
        s = s + torch.where(z >= -_CUT, torch.exp(z), 0.0) * gp.narrow(dim, band + d, n)
    return s


def _live_rows(h: int, window, device):
    """(H, 1) bool of the rows inside ``window`` (ylo, yhi); None for all."""
    if window is None or (window[0] <= 0 and window[1] >= h):
        return None
    y = torch.arange(h, device=device)
    return ((y >= window[0]) & (y < window[1]))[:, None]


def f1_plain(gray, band, tau, temperature, test_above=True, window=None):
    """Plain F1 on any device: (..., H, W) gray -> S1 (..., 2, H, W),
    differentiable by torch autograd."""
    scale, t, inv_t = _scalars(tau, temperature, test_above)
    s1 = _soft_min(_heights(_logits(gray, scale), t), band, t, inv_t, -1)
    live = _live_rows(gray.shape[-2], window, gray.device)
    return s1 if live is None else torch.where(live, s1, torch.full((), PAD_H, device=gray.device))


def _dist(d2, eps):
    zero = torch.zeros((), device=d2.device)
    # where(d2 > 0, d2, 0): max(d2, 0) with the kernel's zero gradient at 0
    return torch.sqrt(torch.where(d2 > 0, d2, zero) + eps)


def f2_plain(s1, band, temperature, eps, memos=True):
    """Plain F2 on any device: S1 -> field, or (field, d2) with ``memos``;
    differentiable by torch autograd."""
    _, t, inv_t = _scalars(1.0, temperature)
    d2 = _soft_min(s1, band, t, inv_t, -2)
    d_in, d_out = _dist(d2, eps).unbind(-3)
    field = d_out - torch.where(d_in > 1, d_in - 1.0, torch.zeros((), device=s1.device))
    return (field, d2) if memos else field


def b2_plain(ct, d2, s1, band, temperature, eps):
    """Plain B2 on any device: the kernel's arithmetic written out."""
    _, _, inv_t = _scalars(1.0, temperature)
    zero = torch.zeros((), device=ct.device)
    d = _dist(d2, eps)
    half = torch.where(d2 > 0, torch.full((), 0.5, device=ct.device), zero) / d
    g = torch.stack([(-ct) * torch.where(d[..., 0, :, :] > 1, half[..., 0, :, :], zero),
                     ct * half[..., 1, :, :]], dim=-3)
    return _weight_sum(d2, g, s1, band, inv_t, -2)


def b1_plain(gray, s1, ds1, band, tau, temperature, test_above=True, window=None):
    """Plain B1 on any device: the kernel's arithmetic written out."""
    scale, t, inv_t = _scalars(tau, temperature, test_above)
    l = _logits(gray, scale)
    h = _heights(l, t)
    dh = _weight_sum(s1, ds1, h, band, inv_t, -1)
    one = torch.ones((), device=gray.device)
    sig = one / (one + torch.exp(torch.stack([l, -l], dim=-3)))  # sigmoid(-l_f)
    dl = torch.where(h < PAD_H, (dh * -t) * sig, torch.zeros((), device=gray.device))
    dgray = dl[..., 0, :, :] * scale + dl[..., 1, :, :] * -scale
    live = _live_rows(gray.shape[-2], window, gray.device)
    return dgray if live is None else torch.where(live, dgray, torch.zeros((), device=gray.device))


# ------------------------------------------------------------------ wrappers


def _check(name, band, *tensors):
    if not 0 <= band <= MAX_BAND:
        raise ValueError(f"{name}: band {band} outside [0, {MAX_BAND}]")
    return _build.float32_on_cuda(name, *tensors)


def _check_shapes(name, image, *fields):
    """image (..., H, W); each of ``fields`` (..., 2, H, W)."""
    want = tuple(image.shape[:-2]) + (2,) + tuple(image.shape[-2:])
    for f in fields:
        if tuple(f.shape) != want:
            raise ValueError(f"{name}: shape {tuple(f.shape)}, expected {want}")


def _launch(entry, image, *ptrs, band, tau=1.0, temperature=1.0, eps=0.0, test_above=True, window=None):
    n, h, w = _build.flat_shape(image)
    scale, t, inv_t = _scalars(tau, temperature, test_above)
    ylo, yhi = (0, h) if window is None else (int(window[0]), int(window[1]))
    _build.launch(entry, image.device, *ptrs, n, h, w, band, scale, t, inv_t, float(eps), ylo, yhi)


def f1_pass(gray, band, tau, temperature, test_above=True, window=None):
    """(..., H, W) float32 gray -> S1 (..., 2, H, W), 1e30 in the rows
    outside ``window`` (ylo, yhi) (default: none): kernel ``soft_f1`` on
    CUDA, the plain version on the CPU."""
    if not _check("f1_pass", band, gray):
        return f1_plain(gray, band, tau, temperature, test_above, window)
    s1 = gray.new_empty(tuple(gray.shape[:-2]) + (2,) + tuple(gray.shape[-2:]))
    if gray.numel() > 0:
        _launch("chaq_soft_f1", gray, gray.data_ptr(), s1.data_ptr(), band=band, tau=tau,
                temperature=temperature, test_above=test_above, window=window)
        LAUNCHES["soft_f1"] += 1
    return s1


def f2_pass(s1, band, temperature, eps, memos=True):
    """S1 (..., 2, H, W) -> field (..., H, W), or (field, d2 memos) with
    ``memos``: kernel ``soft_f2`` on CUDA, the plain version on the CPU."""
    if not _check("f2_pass", band, s1):
        return f2_plain(s1, band, temperature, eps, memos)
    if s1.dim() < 3 or s1.shape[-3] != 2:
        raise ValueError(f"f2_pass: expected S1 of shape (..., 2, H, W), got {tuple(s1.shape)}")
    field = s1.new_empty(tuple(s1.shape[:-3]) + tuple(s1.shape[-2:]))
    d2 = torch.empty_like(s1) if memos else None
    if field.numel() > 0:
        _launch("chaq_soft_f2", field, s1.data_ptr(), field.data_ptr(),
                d2.data_ptr() if memos else None, band=band, temperature=temperature, eps=eps)
        LAUNCHES["soft_f2"] += 1
    return (field, d2) if memos else field


def b2_pass(ct, d2, s1, band, temperature, eps):
    """dS1 (..., 2, H, W) from the field's cotangent (..., H, W), the d2
    memos and S1: kernel ``soft_b2`` on CUDA, the plain version on the CPU."""
    if not _check("b2_pass", band, ct, d2, s1):
        return b2_plain(ct, d2, s1, band, temperature, eps)
    _check_shapes("b2_pass", ct, d2, s1)
    ds1 = torch.empty_like(s1)
    if ct.numel() > 0:
        _launch("chaq_soft_b2", ct, ct.data_ptr(), d2.data_ptr(), s1.data_ptr(), ds1.data_ptr(),
                band=band, temperature=temperature, eps=eps)
        LAUNCHES["soft_b2"] += 1
    return ds1


def b1_pass(gray, s1, ds1, band, tau, temperature, test_above=True, window=None):
    """dgray (..., H, W) from gray, S1 and dS1, zero in the rows outside
    ``window`` (ylo, yhi) (default: none): kernel ``soft_b1`` on CUDA, the
    plain version on the CPU."""
    if not _check("b1_pass", band, gray, s1, ds1):
        return b1_plain(gray, s1, ds1, band, tau, temperature, test_above, window)
    _check_shapes("b1_pass", gray, s1, ds1)
    dgray = torch.empty_like(gray)
    if gray.numel() > 0:
        _launch("chaq_soft_b1", gray, gray.data_ptr(), s1.data_ptr(), ds1.data_ptr(),
                dgray.data_ptr(), band=band, tau=tau, temperature=temperature,
                test_above=test_above, window=window)
        LAUNCHES["soft_b1"] += 1
    return dgray


# ----------------------------------------------------------------- autograd


class _FusedField(torch.autograd.Function):
    """The custom VJP of pallas_soft_fused._fused_field_p: the forward runs
    F1 then F2 and keeps S1 and the d2 memos only when gray needs a
    gradient; the backward runs B2 then B1 and returns None for the
    parameters (the JAX VJP reports them as zero)."""

    @staticmethod
    def forward(ctx, gray, band, tau, temperature, eps, test_above, window):
        s1 = f1_pass(gray, band, tau, temperature, test_above, window)
        if not ctx.needs_input_grad[0]:
            return f2_pass(s1, band, temperature, eps, memos=False)
        field, d2 = f2_pass(s1, band, temperature, eps)
        ctx.save_for_backward(gray, s1, d2)
        ctx.params = (band, tau, temperature, eps, test_above, window)
        return field

    @staticmethod
    def backward(ctx, ct):
        gray, s1, d2 = ctx.saved_tensors
        band, tau, temperature, eps, test_above, window = ctx.params
        ds1 = b2_pass(ct.to(torch.float32).contiguous(), d2, s1, band, temperature, eps)
        dgray = b1_pass(gray, s1, ds1, band, tau, temperature, test_above, window)
        return (dgray,) + (None,) * 6


def soft_sdf_field_fused(gray, band, tau, temperature, eps, test_above=True, window=None):
    """The soft SDF field of (..., H, W) gray of any value range through the
    four kernels (their plain versions on the CPU), differentiable with
    respect to gray. tau, T and eps are launch arguments: one build serves
    every schedule, so there is no ``_dynamic`` twin. ``window`` (ylo, yhi):
    the live rows (the sharded tier's halo'd blocks; default: all)."""
    g = gray.to(torch.float32).contiguous()
    return _FusedField.apply(g, int(band), float(tau), float(temperature), float(eps),
                             bool(test_above), window)


# -------------------------------------------------- split (sharded tier)


class _Pass1S1(torch.autograd.Function):
    """pallas_soft_fused.pass1_s1: F1 forward, B1 backward."""

    @staticmethod
    def forward(ctx, gray, band, tau, temperature, test_above):
        ctx.params = (band, tau, temperature, test_above)
        s1 = f1_pass(gray, band, tau, temperature, test_above)
        ctx.save_for_backward(gray, s1)
        return s1

    @staticmethod
    def backward(ctx, ds1):
        gray, s1 = ctx.saved_tensors
        band, tau, temperature, test_above = ctx.params
        return (b1_pass(gray, s1, ds1.to(torch.float32).contiguous(), band, tau, temperature, test_above),
                None, None, None, None)


def pass1_s1(gray, band, tau, temperature, test_above=True):
    """(..., H, W) gray -> S1 (..., 2, H, W) through F1, differentiable
    (B1 in the backward): a shard's pass 1, rows never crossing shards."""
    g = gray.to(torch.float32).contiguous()
    return _Pass1S1.apply(g, int(band), float(tau), float(temperature), bool(test_above))


class _Pass2Ext(torch.autograd.Function):
    """pallas_soft_fused.pass2_ext: F2 over the halo'd S1 block, its
    interior rows out; B2 over the whole block, the halo rows' cotangent
    zero, so that dS1 comes back for the halo rows too."""

    @staticmethod
    def forward(ctx, s1ext, band, temperature, eps, halo):
        h = s1ext.shape[-2] - 2 * halo
        if not ctx.needs_input_grad[0]:
            return f2_pass(s1ext, band, temperature, eps, memos=False).narrow(-2, halo, h)
        field, d2 = f2_pass(s1ext, band, temperature, eps)
        ctx.save_for_backward(s1ext, d2)
        ctx.params = (band, temperature, eps, halo)
        return field.narrow(-2, halo, h)

    @staticmethod
    def backward(ctx, ct):
        s1ext, d2 = ctx.saved_tensors
        band, temperature, eps, halo = ctx.params
        ct_ext = F.pad(ct.to(torch.float32), (0, 0, halo, halo)).contiguous()
        return b2_pass(ct_ext, d2, s1ext, band, temperature, eps), None, None, None, None


def pass2_ext(s1ext, band, temperature, eps, halo):
    """A shard's S1 (..., 2, H + 2 halo, W) with ``halo`` rows of its
    neighbours' S1 above and below (1e30 beyond the image) -> the field of
    its H rows through F2, differentiable (B2 in the backward, over every
    row of the block)."""
    return _Pass2Ext.apply(s1ext.to(torch.float32).contiguous(), int(band), float(temperature), float(eps),
                           int(halo))
