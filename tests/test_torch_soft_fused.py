"""The undeclared-range soft kernels of the PyTorch port (ops/soft_fused.py,
plain versions on the CPU) against the JAX package's adaptive Pallas
kernels (ops/pallas_soft_fused.py, interpret mode), pass by pass and as the
whole custom-VJP field; against JAX's composed path where the height clip
does not bind; and the hand-written backward against torch autograd of the
plain forward and against finite differences. Inputs come from numpy seeds
and go to both sides."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chaq_sdfgen_tpu.ops import pallas_soft_fused as JF
from chaq_sdfgen_tpu.ops import softsdf as jsoft
from chaq_sdfgen_tpu_torch.ops import soft_fused as SF

EPS = 1e-6
_TM = JF._TM

# name: (shape, band, tau, T, test_above, value range). The first five are
# the shapes and parameters of tests/test_pallas_fused.py (the multi-block
# one is its 150x117 spread 6); the last two are out of gamut.
CASES = {
    "small": ((40, 36), 5, 2.0, 1.0, True, "u8"),
    "wide": ((130, 150), 17, 1.5, 0.5, True, "u8"),
    "square": ((64, 64), 3, 4.0, 1.5, True, "u8"),
    "inverted": ((48, 40), 5, 2.0, 1.0, False, "u8"),
    "multiblock": ((150, 117), 8, 2.0, 1.0, True, "u8"),
    "ood": ((96, 80), 66, 2.0, 1.0, True, "pm2000"),
    "ood-band112": ((64, 72), 112, 1.0, 0.5, False, "pm2000"),
}


def _inputs(name):
    shape, band, _, _, _, kind = CASES[name]
    rng = np.random.default_rng(band + shape[0])
    if kind == "u8":
        g = (rng.random(shape) * 255).astype(np.float32)
    else:
        g = (rng.random(shape) * 4000 - 2000).astype(np.float32)
    return g, rng.standard_normal(shape).astype(np.float32)


def _ru(x, m):
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX kernels' outputs for a case, cut out of their padded and
    transposed layouts: S1, d2 (2, H, W); field (H, W); dS1 (2, H, W) from
    its bf16 store; dgray (H, W), which is the custom VJP's, i.e. jax.grad's
    with the case's cotangent."""
    (h, w), band, tau, t, above, _ = CASES[name]
    g, ct = _inputs(name)
    hp, wl = _ru(max(h, _TM), _TM), _ru(max(w, 128), 128)
    prm = JF._params(tau, t, EPS, 0.0, float(h))
    pc = (tau, 1.0 / tau, t, 1.0 / t, EPS)
    pad = ((0, hp - h), (0, wl - w))
    s1cat, logits_t, s1t = JF.f1_pass(jnp.pad(jnp.asarray(g), pad), prm, w, band, above,
                                      jnp.float32, True, pc)
    field, d2cat = JF.f2_pass(s1cat, prm, hp, band, True, pc)
    ds1t, ph = JF.b2_pass(s1cat, jnp.pad(jnp.asarray(ct), pad), d2cat, prm, band, True, pc)
    dgray = JF.b1_pass(logits_t, ds1t, s1t, prm, hp, w, band, ph, above, True, pc)
    nj = wl // JF._TN + 2 * (ph // JF._TN)
    s1cat, field, d2cat, dgray = map(np.asarray, (s1cat, field, d2cat, dgray))
    ds1t = np.asarray(ds1t.astype(jnp.float32))
    return dict(
        s1=np.stack([s1cat[_TM:_TM + h, f * wl:f * wl + w] for f in range(2)]),
        d2=np.stack([d2cat[f * hp:f * hp + h, :w] for f in range(2)]),
        field=field[:h, :w],
        ds1=np.stack([ds1t[f * nj * JF._TN + ph:f * nj * JF._TN + ph + w, :h].T for f in range(2)]),
        dgray=dgray[:h, :w],
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", CASES)
def test_f1_matches_jax(name):
    """S1 within 1e-4 (measured <= 2e-6: exp/log differ by an ulp)."""
    _, band, tau, t, above, _ = CASES[name]
    g, _ = _inputs(name)
    got = SF.f1_plain(_t(g), band, tau, t, above).numpy()
    np.testing.assert_allclose(got, _jax(name)["s1"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_f2_matches_jax(name):
    """Given JAX's S1: d2 and the field within 1e-4 (measured <= 7e-7)."""
    _, band, _, t, _, _ = CASES[name]
    want = _jax(name)
    field, d2 = SF.f2_plain(_t(want["s1"]), band, t, EPS)
    np.testing.assert_allclose(d2.numpy(), want["d2"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(field.numpy(), want["field"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_b2_matches_jax(name):
    """Given JAX's S1, memos and cotangent: dS1 within the bf16 rounding of
    JAX's store (2^-8 relative, measured 3.9e-3), plus 1e-6 of the scale."""
    _, band, _, t, _, _ = CASES[name]
    want = _jax(name)
    _, ct = _inputs(name)
    got = SF.b2_plain(_t(ct), _t(want["d2"]), _t(want["s1"]), band, t, EPS).numpy()
    bound = 2.0 ** -8 * np.abs(got) + 1e-6 * np.abs(got).max()
    assert (np.abs(got - want["ds1"]) <= bound).all()


@pytest.mark.parametrize("name", CASES)
def test_b1_matches_jax(name):
    """Given JAX's S1 and (bf16) dS1: dgray within 1e-5 of the scale
    (measured <= 1.4e-7)."""
    _, band, tau, t, above, _ = CASES[name]
    want = _jax(name)
    g, _ = _inputs(name)
    got = SF.b1_plain(_t(g), _t(want["s1"]), _t(want["ds1"]), band, tau, t, above).numpy()
    assert np.abs(got - want["dgray"]).max() <= 1e-5 * np.abs(want["dgray"]).max()


@pytest.mark.parametrize("name", CASES)
def test_fused_field_and_grad_match_jax(name):
    """The whole _FusedField, forward and torch.autograd.grad, against the
    JAX kernels' field and custom VJP: the field within 1e-4, the gradient
    within 1e-2 of the scale (test_pallas_fused.py:147; JAX stores dS1 as
    bf16, measured <= 2.9e-3)."""
    _, band, tau, t, above, _ = CASES[name]
    want = _jax(name)
    g, ct = _inputs(name)
    x = _t(g).requires_grad_()
    field = SF.soft_sdf_field_fused(x, band, tau, t, EPS, above)
    grad, = torch.autograd.grad(field, x, _t(ct))
    np.testing.assert_allclose(field.detach().numpy(), want["field"], atol=1e-4, rtol=0)
    assert np.abs(grad.numpy() - want["dgray"]).max() <= 1e-2 * np.abs(want["dgray"]).max()


@pytest.mark.parametrize("name", ["multiblock", "ood"])
def test_grad_matches_jax_grad_of_fused(name):
    """jax.grad itself (not the passes called one by one) through
    soft_sdf_field_fused(interpret=True): the same VJP."""
    _, band, tau, t, above, _ = CASES[name]
    g, ct = _inputs(name)
    want = np.asarray(jax.grad(lambda y: jnp.vdot(
        JF.soft_sdf_field_fused(y, band, tau, t, EPS, above, True), jnp.asarray(ct)))(jnp.asarray(g)))
    x = _t(g).requires_grad_()
    (SF.soft_sdf_field_fused(x, band, tau, t, EPS, above) * _t(ct)).sum().backward()
    assert np.abs(x.grad.numpy() - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("shape,spread,tau,t", [((150, 117), 6, 2.0, 1.0), ((130, 150), 15, 1.5, 0.5),
                                                ((96, 80), 20, 2.0, 1.0)])
def test_matches_jax_composed_where_the_clip_does_not_bind(shape, spread, tau, t):
    """On dense noise with (band + 1)^2 above every height, JAX's composed
    path (its CPU default, which clips heights at (band + 1)^2 where the
    kernels clip at 1e30) computes the same field: forward within 1e-4,
    gradient within 1e-4 of the scale (measured <= 4.1e-5)."""
    rng = np.random.default_rng(spread)
    g = (rng.random(shape) * 255).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    band = spread + 2
    assert (band + 1) ** 2 > t * (127.5 / tau + 1)
    field_fn = lambda y: jsoft.soft_sdf_field(y, spread, tau=tau, temperature=t, eps=EPS)
    want_f = np.asarray(field_fn(jnp.asarray(g)))
    want_g = np.asarray(jax.grad(lambda y: jnp.vdot(field_fn(y), jnp.asarray(ct)))(jnp.asarray(g)))
    x = _t(g).requires_grad_()
    field = SF.soft_sdf_field_fused(x, band, tau, t, EPS)
    (field * _t(ct)).sum().backward()
    np.testing.assert_allclose(field.detach().numpy(), want_f, atol=1e-4, rtol=0)
    assert np.abs(x.grad.numpy() - want_g).max() <= 1e-4 * np.abs(want_g).max()


@pytest.mark.parametrize("shape,band,tau,t,above,lo,hi", [
    ((33, 41), 5, 2.0, 1.0, True, 0.0, 255.0),
    ((2, 30, 44), 66, 1.0, 0.5, False, 0.0, 255.0),
    ((40, 52), 112, 2.0, 1.0, True, -2000.0, 2000.0),
    ((25, 70), 12, 0.25, 0.5, True, -2000.0, 2000.0),
])
def test_backward_mirror_matches_autograd_of_plain(shape, band, tau, t, above, lo, hi):
    """b2_plain then b1_plain (the kernels' arithmetic written out) against
    torch autograd through f1_plain and f2_plain: 1e-5 of the scale."""
    rng = np.random.default_rng(band)
    g = _t((rng.random(shape) * (hi - lo) + lo).astype(np.float32))
    ct = _t(rng.standard_normal(shape).astype(np.float32))
    x = g.clone().requires_grad_()
    want, = torch.autograd.grad(SF.f2_plain(SF.f1_plain(x, band, tau, t, above), band, t, EPS,
                                            memos=False), x, ct)
    s1 = SF.f1_plain(g, band, tau, t, above)
    _, d2 = SF.f2_plain(s1, band, t, EPS)
    got = SF.b1_plain(g, s1, SF.b2_plain(ct, d2, s1, band, t, EPS), band, tau, t, above)
    assert torch.isfinite(got).all() and float(want.abs().max()) > 0
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_autograd_of_plain_at_the_threshold_midpoint():
    """Gray exactly 127.5 (l = 0): autograd through the plain heights takes
    sigmoid(0) = 1/2, as B1 does, not the sum of both kinks' subgradients."""
    rng = np.random.default_rng(15)
    g = (rng.random((30, 34)) * 255).astype(np.float32)
    g[::5, ::3] = 127.5
    ct = _t(rng.standard_normal(g.shape).astype(np.float32))
    x = _t(g).requires_grad_()
    want, = torch.autograd.grad(SF.f2_plain(SF.f1_plain(x, 8, 1.0, 0.5), 8, 0.5, EPS, memos=False),
                                x, ct)
    s1 = SF.f1_plain(_t(g), 8, 1.0, 0.5)
    got = SF.b1_plain(_t(g), s1, SF.b2_plain(ct, SF.f2_plain(s1, 8, 0.5, EPS)[1], s1, 8, 0.5, EPS),
                      8, 1.0, 0.5)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_gradient_vs_finite_difference():
    """Central differences at 24x20, band 4, tau 4, T 1.5, with the bound of
    test_pallas_fused.py:95-115."""
    rng = np.random.default_rng(4)
    h, w, band, tau, t = 24, 20, 4, 4.0, 1.5
    gray = (rng.random((h, w)) * 255).astype(np.float32)
    weights = _t(rng.standard_normal((h, w)).astype(np.float32))

    def loss(g):
        return (SF.soft_sdf_field_fused(g, band, tau, t, EPS) * weights).sum()

    x = _t(gray).requires_grad_()
    loss(x).backward()
    grad = x.grad.numpy()
    eps = 0.25
    for _ in range(8):
        y, xx = rng.integers(0, h), rng.integers(0, w)
        gp = gray.copy(); gp[y, xx] += eps
        gm = gray.copy(); gm[y, xx] -= eps
        fd = (loss(_t(gp)).item() - loss(_t(gm)).item()) / (2 * eps)
        assert abs(fd - grad[y, xx]) <= 3e-2 + 0.08 * abs(fd), (y, xx, fd, grad[y, xx])


def test_batch_equals_images():
    rng = np.random.default_rng(12)
    g = (rng.random((3, 40, 36)) * 4000 - 2000).astype(np.float32)
    x = _t(g).requires_grad_()
    out = SF.soft_sdf_field_fused(x, 20, 2.0, 1.0, EPS)
    out.sum().backward()
    for i in range(3):
        xi = _t(g[i]).requires_grad_()
        oi = SF.soft_sdf_field_fused(xi, 20, 2.0, 1.0, EPS)
        oi.sum().backward()
        np.testing.assert_array_equal(out[i].detach().numpy(), oi.detach().numpy())
        np.testing.assert_allclose(x.grad[i].numpy(), xi.grad.numpy(), rtol=0,
                                   atol=1e-6 * float(xi.grad.abs().max()))


def test_memos_only_when_gray_needs_a_gradient(monkeypatch):
    calls = []
    real = SF.f2_pass

    def spy(*args, memos=True, **kw):
        calls.append(memos)
        return real(*args, memos=memos, **kw)

    monkeypatch.setattr(SF, "f2_pass", spy)
    g = _t((np.random.default_rng(13).random((20, 30)) * 255).astype(np.float32))
    SF.soft_sdf_field_fused(g, 16, 2.0, 1.0, EPS)
    x = g.clone().requires_grad_()
    SF.soft_sdf_field_fused(x, 16, 2.0, 1.0, EPS).sum().backward()
    assert calls == [False, True]
    assert x.grad is not None and x.grad.shape == g.shape


@pytest.mark.parametrize("shape,band", [((40, 36), 5), ((40, 36), 112), ((40, 36), 113),
                                        ((1, 36), 5), ((2, 36), 5), ((40, 1), 5)])
def test_geometry_gate_matches_jax(shape, band):
    assert SF.fused_geometry_ok(torch.zeros(shape), band) == JF.fused_geometry_ok(
        jnp.zeros(shape), band)
    assert SF.fused_geometry_ok(torch.zeros((3,) + shape), band) == SF.fused_geometry_ok(
        torch.zeros(shape), band)


def test_wrappers_refuse_what_kernels_do_not_take():
    g = torch.zeros((8, 8))
    with pytest.raises(ValueError):
        SF.f1_pass(g, 113, 2.0, 1.0)
    with pytest.raises(ValueError):
        SF.soft_sdf_field_fused(g, 113, 2.0, 1.0, EPS)
    m = torch.zeros((8, 8), device="meta")
    m2 = torch.zeros((2, 8, 8), device="meta")
    with pytest.raises(ValueError):
        SF.f1_pass(m, 5, 2.0, 1.0)
    with pytest.raises(ValueError):
        SF.f2_pass(m2, 5, 1.0, EPS)
    with pytest.raises(ValueError):
        SF.b2_pass(m, m2, m2, 5, 1.0, EPS)
    with pytest.raises(ValueError):
        SF.b1_pass(m, m2, m2, 5, 2.0, 1.0)
