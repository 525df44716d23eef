"""The soft-min forms of the PyTorch port (ops/softmin.py): along x,
implicit sentinels, two fields at once and output offsets, each held bit
for bit against the column form it replaces (transposes, F.pad and
torch.cat around softmin_col_fwd/bwd), on the CPU, through the plain
versions that the kernels of csrc/softmin.cu match bit for bit on the card;
and the composed path built on them (softsdf.cols_pass1, soft_field_cols)
against its earlier form and against JAX's composed path."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from chaq_sdfgen_tpu.ops import softsdf as jsoft
from chaq_sdfgen_tpu_torch.ops import softmin, softsdf, threshold
from chaq_sdfgen_tpu_torch.ops.edt import big_sentinel

EPS = 1e-6


def _heights(shape, seed, hi=2000.0):
    return torch.from_numpy((np.random.default_rng(seed).random(shape) * hi).astype(np.float32))


def _pad(g, band, axis):
    return F.pad(g, (band, band) if axis == -1 else (0, 0, band, band), value=1e30)


def _col_fwd(g, band, t, axis, implicit):
    """The column form: g moved to axis -2, padded unless pre-extended."""
    x = g.transpose(-1, -2).contiguous() if axis == -1 else g
    x = _pad(x, band, -2) if implicit else x
    s = softmin.softmin_col_fwd(x, band, t)
    return s.transpose(-1, -2) if axis == -1 else s


def _col_bwd(g, s, ct, band, t, axis, implicit):
    """The column form's VJP, narrowed to the field where the sentinels
    were padded on (F.pad's VJP)."""
    tr = (lambda a: a.transpose(-1, -2).contiguous()) if axis == -1 else (lambda a: a)
    x = _pad(tr(g), band, -2) if implicit else tr(g)
    dg = softmin.softmin_col_bwd(x, tr(s), tr(ct), band, t)
    dg = dg.narrow(-2, band, dg.shape[-2] - 2 * band) if implicit else dg
    return dg.transpose(-1, -2) if axis == -1 else dg


FORMS = [(axis, implicit) for axis in (-2, -1) for implicit in (False, True)]


@pytest.mark.parametrize("axis,implicit", FORMS)
@pytest.mark.parametrize("band,t", [(0, 1.0), (1, 0.5), (5, 0.7), (20, 1.0), (40, 2.0)])
@pytest.mark.parametrize("shape", [(23, 19), (2, 17, 30), (1, 40)])
def test_forms_equal_the_column_form(axis, implicit, band, t, shape):
    """Along y or x, explicit or implicit sentinels: S and dg bit for bit
    those of the column form on the same field."""
    rng = np.random.default_rng(band + len(shape))
    g = _heights(shape, band)
    if not implicit:
        g = _pad(g, band, axis)
    s = softmin.softmin_col_fwd(g, band, t, axis=axis, implicit=implicit)
    want = _col_fwd(g, band, t, axis, implicit)
    assert torch.equal(s, want)
    ct = torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32))
    dg = softmin.softmin_col_bwd(g, s, ct, band, t, axis=axis, implicit=implicit)
    assert dg.shape == g.shape
    assert torch.equal(dg, _col_bwd(g, s, ct, band, t, axis, implicit))


@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("band", [3, 17])
def test_two_fields_in_place_equal_cat(axis, band):
    """Two fields in one call, written at a column offset of a wider output,
    equal torch.cat of the one-field calls; the backward reading both halves
    in place equals the one-field calls on the halves."""
    t = 0.8
    fields = (_heights((2, 21, 26), 1), _heights((2, 21, 26), 2, 30.0))
    one = [softmin.softmin_col_fwd(f, band, t, axis=axis, implicit=True) for f in fields]
    w = one[0].shape[-1]
    out = torch.full((2, one[0].shape[-2], 3 + 2 * w + 4), -5.0)
    got = softmin.softmin_col_fwd(fields, band, t, axis=axis, implicit=True, out=out, out_col=3)
    assert got is out
    assert torch.equal(out[..., 3:3 + 2 * w], torch.cat(one, -1))
    assert bool((out[..., :3] == -5.0).all()) and bool((out[..., 3 + 2 * w:] == -5.0).all())
    assert torch.equal(softmin.softmin_col_fwd(fields, band, t, axis=axis, implicit=True), torch.cat(one, -1))
    ct = torch.from_numpy(np.random.default_rng(3).standard_normal(out.shape).astype(np.float32))
    dg = softmin.softmin_col_bwd(fields, out, ct, band, t, axis=axis, implicit=True, s_col=3)
    assert isinstance(dg, tuple) and len(dg) == 2
    for i, f in enumerate(fields):
        cols = slice(3 + i * w, 3 + (i + 1) * w)
        want = softmin.softmin_col_bwd(f, out[..., cols].contiguous(), ct[..., cols].contiguous(), band, t,
                                       axis=axis, implicit=True)
        assert torch.equal(dg[i], want)


def _cols_pass1_column_form(gray, band, tau, t):
    """cols_pass1 as the composed path formed it before: the heights of the
    transposed image, padded with 1e30, the column form per field, each
    transposed back, then torch.cat."""
    logits_t = threshold.soft_logits(gray.to(torch.float32).transpose(-1, -2).contiguous(), tau=tau)
    s1 = []
    for on in (True, False):
        h = threshold.soft_log_indicator_from_logits(logits_t, t, on, big_sentinel(band))
        s1.append(softmin.band_softmin_col(_pad(h, band, -2), band, t).transpose(-1, -2))
    return torch.cat(s1, -1)


def _field_column_form(gray, band, tau, t):
    s1 = _cols_pass1_column_form(gray, band, tau, t)
    return softsdf.cols_tails(softmin.band_softmin_col(_pad(s1, band, -2), band, t), gray.shape[-1], EPS)


@pytest.mark.parametrize("shape,band", [((24, 20), 9), ((2, 16, 18), 30), ((1, 48), 25), ((40, 1), 12)])
@pytest.mark.parametrize("tau,t", [(2.0, 1.0), (1.0, 0.5)])
def test_composed_path_equals_its_column_form(shape, band, tau, t):
    """cols_pass1 and soft_field_cols (pass 1 along x in one call, written
    into S1's halves; pass 2 with implicit sentinels) equal their earlier
    column form, field and gradient, bit for bit."""
    g = torch.from_numpy((np.random.default_rng(band).random(shape) * 4000 - 2000).astype(np.float32))
    ct = torch.from_numpy(np.random.default_rng(band + 1).standard_normal(shape).astype(np.float32))
    assert torch.equal(softsdf.cols_pass1(g, band, tau, t), _cols_pass1_column_form(g, band, tau, t))
    x, y = g.clone().requires_grad_(), g.clone().requires_grad_()
    got = softsdf.soft_field_cols(x, band, tau, t, EPS)
    want = _field_column_form(y, band, tau, t)
    (got * ct).sum().backward()
    (want * ct).sum().backward()
    assert torch.equal(got.detach(), want.detach())
    assert torch.equal(x.grad, y.grad)


@pytest.mark.parametrize("shape,spread", [((3, 18, 22), 111), ((1, 40), 30), ((2, 1, 33), 12)])
def test_soft_field_cols_matches_jax(shape, spread):
    """soft_field_cols on a batch and on one row against JAX's composed
    path (its CPU scans) with test_torch_soft_composed.py's tolerances:
    field within 1e-4, gradient within 1e-4 of the scale."""
    band = spread + 2
    g = (np.random.default_rng(spread).random(shape) * 4000 - 2000).astype(np.float32)
    ct = np.random.default_rng(spread + 1).standard_normal(shape).astype(np.float32)

    def both(y, c):
        out, vjp = jax.vjp(lambda z: jsoft.soft_sdf_field(z, spread, tau=2.0, temperature=1.0, eps=EPS), y)
        return out, vjp(c)[0]

    want, want_g = (np.asarray(a) for a in jax.jit(both)(jnp.asarray(g), jnp.asarray(ct)))
    x = torch.from_numpy(g).requires_grad_()
    got = softsdf.soft_field_cols(x, band, 2.0, 1.0, EPS)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)
    assert np.abs(x.grad.numpy() - want_g).max() <= 1e-4 * np.abs(want_g).max()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_band_softmin_every_axis_equals_the_column_form(axis):
    """band_softmin (implicit sentinels, no padding) along each axis of a
    3-D field equals the column form on the padded field moved to -2, value
    and gradient, bit for bit."""
    g = _heights((9, 11, 13), axis, 50.0)
    ct = torch.from_numpy(np.random.default_rng(axis).standard_normal(g.shape).astype(np.float32))
    x, y = g.clone().requires_grad_(), g.clone().requires_grad_()
    got = softsdf.band_softmin(x, 6, 0.9, axis=axis)
    want = softmin.band_softmin_col(_pad(y.movedim(axis, -2), 6, -2), 6, 0.9).movedim(-2, axis)
    (got * ct).sum().backward()
    (want * ct).sum().backward()
    assert torch.equal(got.detach(), want.detach()) and torch.equal(x.grad, y.grad)


def test_forms_refuse_what_they_do_not_take():
    """Bad axes, too short pre-extended fields, unequal fields and outputs
    too narrow for their fields raise; staged_fits gives each axis its
    limit."""
    g = torch.zeros((10, 12))
    with pytest.raises(ValueError):
        softmin.softmin_col_fwd(g, 2, 1.0, axis=0)
    with pytest.raises(ValueError):
        softmin.softmin_col_fwd(g, 7, 1.0, axis=-1)  # 12 < 2 band
    with pytest.raises(ValueError):
        softmin.softmin_col_fwd((g, torch.zeros((10, 11))), 2, 1.0, implicit=True)
    with pytest.raises(ValueError):
        softmin.softmin_col_fwd((g, g), 2, 1.0, implicit=True, out=torch.zeros((10, 23)))
    with pytest.raises(ValueError):
        softmin.softmin_col_bwd(g, torch.zeros((10, 12)), torch.zeros((10, 12)), 2, 1.0, implicit=True, s_col=1)
    assert softmin.staged_fits(720) and not softmin.staged_fits(721)
    assert softmin.staged_fits(1920, -1) and not softmin.staged_fits(1921, -1)
