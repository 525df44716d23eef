"""The declared-range soft kernel pair of the PyTorch port
(ops/cuda_soft_mm.py, plain versions on the CPU) against the JAX package's
fused Pallas pair (ops/pallas_soft_mm.py, interpret mode), against the
composed scan oracles of both packages, and the hand-written backward
against torch autograd of the plain forward."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chaq_sdfgen_tpu.ops import pallas_soft_mm as PM
from chaq_sdfgen_tpu.ops import soft_mxu as JM
from chaq_sdfgen_tpu.ops import softsdf as jsoft
from chaq_sdfgen_tpu_torch.ops import cuda_soft_mm as CM
from chaq_sdfgen_tpu_torch.ops import soft_mxu as SM
from chaq_sdfgen_tpu_torch.ops import softsdf as tsoft

TAU, T, EPS = 2.0, 1.0, 1e-6
U8 = (0.0, 255.0)


def _gray(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _jax_field(g, band, **kw):
    return np.asarray(PM.soft_field_mm_fused(jnp.asarray(g), band, TAU, T, EPS, interpret=True, **kw))


def _port_field(g, band, **kw):
    return CM.soft_field_mm_fused(torch.from_numpy(g), band, TAU, T, EPS, **kw)


@pytest.mark.parametrize(
    "shape,spread,test_above",
    [((256, 256), 14, True), ((129, 130), 9, True), ((384, 260), 20, True),
     ((200, 190), 14, False), ((1, 17), 14, True), ((17, 1), 14, True)],
)
def test_field_matches_jax_fused(shape, spread, test_above):
    g = _gray(shape, 3)
    band = spread + 2
    assert PM.soft_field_mm_ok(jnp.asarray(g), band, TAU, T, U8)
    assert CM.soft_field_mm_ok(torch.from_numpy(g), band, TAU, T, U8)
    got = _port_field(g, band, test_above=test_above).numpy()
    np.testing.assert_allclose(got, _jax_field(g, band, test_above=test_above), atol=1e-4, rtol=0)


def _jax_memos(g, band):
    """JAX's forward state: the d2 memos of the fused kernel, unpadded."""
    k1, shift = JM._range_stats(band, TAU, T, U8)
    k2, _ = JM._range_stats(band, TAU, T, U8, margin=JM._P2_MARGIN_T * T)
    h, w = g.shape
    hp, wl = max(-(-h // 128) * 128, 256), -(-max(w, 128) // 128) * 128
    gp = jnp.pad(jnp.asarray(g), ((0, hp - h), (0, wl - w)), constant_values=PM._DEAD)
    edge = jnp.full((PM._HK, wl), PM._DEAD, jnp.float32)
    _, d2i, d2o = PM.mm_fused_fwd(gp, edge, edge, shift, k1, k2, TAU, T, EPS, True, True, True)
    return np.asarray(d2i)[:h, :w], np.asarray(d2o)[:h, :w]


def _jax_grad(g, w, band):
    return np.asarray(jax.grad(
        lambda x: jnp.sum(jnp.asarray(w) * PM.soft_field_mm_fused(x, band, TAU, T, EPS, interpret=True))
    )(jnp.asarray(g)))


def test_backward_matches_jax_given_the_same_forward():
    """The port's backward (the kernel's plain version) fed JAX's memos
    and the same cotangent: within 1e-4 of the scale of jax.grad at the
    JAX test's shape, seed and band (test_pallas_soft_mm.py:45-54)."""
    rng = np.random.default_rng(5)
    g = (rng.random((200, 190)) * 255).astype(np.float32)
    w = rng.standard_normal((200, 190)).astype(np.float32)
    band = 16
    k1, k2, shift = SM.range_stats(band, TAU, T, U8)
    d2i, d2o = _jax_memos(g, band)
    got = CM.mm_fused_bwd(torch.from_numpy(w), torch.from_numpy(d2i.copy()),
                          torch.from_numpy(d2o.copy()), torch.from_numpy(g), shift, k1, k2,
                          TAU, T, EPS).numpy()
    want = _jax_grad(g, w, band)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_gradient_matches_jax_grad():
    """The whole chain, the port's forward included, against jax.grad:
    within 1e-4 of the scale (6.8e-5 measured on the CPU). The two
    forwards sum in different orders, so their d2 differ in the last ulp
    (<= 1e-6 here); at sigmoid-knee outputs, where d2 is just above 0 and the gate
    0.5/sqrt(d2 + eps) is steep, that moves the gradient most. With the
    cotangent zeroed at the outputs whose |d2| is below 1e-3 (0.08% of
    them) the chain holds 2e-5 (reading 9.9e-6)."""
    rng = np.random.default_rng(5)
    g = (rng.random((200, 190)) * 255).astype(np.float32)
    w = rng.standard_normal((200, 190)).astype(np.float32)
    d2i, d2o = _jax_memos(g, 16)
    k1, k2, shift = SM.range_stats(16, TAU, T, U8)
    _, t_d2i, t_d2o = SM.soft_field_collapsed(torch.from_numpy(g), k1, k2, shift, TAU, T, EPS)
    assert np.abs(t_d2i.numpy() - d2i).max() < 1e-6 and np.abs(t_d2o.numpy() - d2o).max() < 1e-6
    knee = (np.abs(d2i) < 1e-3) | (np.abs(d2o) < 1e-3)
    assert 0 < knee.mean() < 2e-3
    for cot, tol in ((w, 1e-4), (np.where(knee, 0, w).astype(np.float32), 2e-5)):
        x = torch.from_numpy(g).requires_grad_()
        (CM.soft_field_mm_fused(x, 16, TAU, T, EPS) * torch.from_numpy(cot)).sum().backward()
        want = _jax_grad(g, cot, 16)
        assert np.abs(x.grad.numpy() - want).max() / np.abs(want).max() < tol


@pytest.mark.parametrize("shape,test_above", [((129, 130), True), ((2, 70, 90), False)])
@pytest.mark.parametrize("tau,temperature", [(2.0, 1.0), (1.0, 0.5)])
def test_backward_mirror_matches_autograd_of_plain(shape, test_above, tau, temperature):
    """mm_fused_bwd_plain (the kernel's arithmetic written out, rows conv
    first) against torch autograd through the plain forward (cols conv's
    transpose first), same memos: 1e-5 of the scale."""
    g = torch.from_numpy(_gray(shape, 8))
    ct = torch.from_numpy(np.random.default_rng(9).standard_normal(shape).astype(np.float32))
    k1, k2, shift = SM.range_stats(66, tau, temperature, U8)
    x = g.clone().requires_grad_()
    field, d2i, d2o = CM.mm_fused_fwd_plain(x, shift, k1, k2, tau, temperature, EPS, test_above)
    want, = torch.autograd.grad(field, x, ct)
    got = CM.mm_fused_bwd_plain(ct, d2i.detach(), d2o.detach(), g, shift, k1, k2, tau,
                                temperature, EPS, test_above)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_autograd_of_plain_at_the_threshold_midpoint():
    """Gray exactly 127.5 (l = 0): torch autograd through the plain form
    must take sigmoid(0) = 0.5, as the hand-written backward does, not the
    sum of the subgradients of min(l, 0) and |l|."""
    g = _gray((60, 70), 15)
    g[::7, ::5] = 127.5
    ct = np.random.default_rng(16).standard_normal(g.shape).astype(np.float32)
    k1, k2, shift = SM.range_stats(66, 1.0, 0.5, U8)
    x = torch.from_numpy(g).requires_grad_()
    field, d2i, d2o = CM.mm_fused_fwd_plain(x, shift, k1, k2, 1.0, 0.5, EPS)
    want, = torch.autograd.grad(field, x, torch.from_numpy(ct))
    got = CM.mm_fused_bwd_plain(torch.from_numpy(ct), d2i.detach(), d2o.detach(),
                                torch.from_numpy(g), shift, k1, k2, 1.0, 0.5, EPS)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_field_matches_composed_oracles():
    """The declared-range form against the composed scan form of both
    packages (the oracle of the soft family): 2e-3, the JAX test's bound
    (test_pallas_soft_mm.py:111-128)."""
    g = _gray((256, 256), 11)
    spread = 14
    got = _port_field(g, spread + 2).numpy()
    port_composed = tsoft.soft_sdf_field_composed(torch.from_numpy(g), spread, tau=TAU,
                                                  temperature=T, eps=EPS).numpy()
    jax_composed = np.asarray(jsoft.soft_sdf_field(jnp.asarray(g), spread, tau=TAU,
                                                   temperature=T, eps=EPS))
    np.testing.assert_allclose(got, port_composed, atol=2e-3, rtol=0)
    np.testing.assert_allclose(got, jax_composed, atol=2e-3, rtol=0)


def test_batch_equals_images():
    g = _gray((3, 64, 48), 12)
    out = _port_field(g, 16)
    for i in range(3):
        np.testing.assert_array_equal(out[i].numpy(), _port_field(g[i], 16).numpy())


def test_memos_only_when_gray_needs_a_gradient(monkeypatch):
    calls = []
    real = CM.mm_fused_fwd

    def spy(*args, memos=True, **kw):
        calls.append(memos)
        return real(*args, memos=memos, **kw)

    monkeypatch.setattr(CM, "mm_fused_fwd", spy)
    g = torch.from_numpy(_gray((20, 30), 13))
    CM.soft_field_mm_fused(g, 16, TAU, T, EPS)
    x = g.clone().requires_grad_()
    CM.soft_field_mm_fused(x, 16, TAU, T, EPS).sum().backward()
    assert calls == [False, True]
    assert x.grad is not None and x.grad.shape == g.shape


def test_shift_cancels_in_the_field():
    """The shift cancels exactly in the output (c - T log(e^{c/T} ...)):
    two shifts give the same field up to rounding."""
    g = torch.from_numpy(_gray((40, 50), 14))
    a = CM.mm_fused_fwd(g, 3.75, 10, 10, TAU, T, EPS, memos=False)
    b = CM.mm_fused_fwd(g, 10.0, 10, 10, TAU, T, EPS, memos=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)


def test_gates():
    assert CM.mm_fused_ok(16, 16) and not CM.mm_fused_ok(17, 10) and not CM.mm_fused_ok(10, 17)
    g2 = torch.zeros((64, 64))
    for band, tau, t, rng in [(18, TAU, T, U8), (18, TAU, T, None), (300, 2.0, 8.0, U8),
                              (66, 1.0, 0.5, U8), (66, 1.0, 0.5, (-1e9, 1e9))]:
        assert CM.soft_field_mm_ok(g2, band, tau, t, rng) == PM.soft_field_mm_ok(
            jnp.zeros((64, 64)), band, tau, t, rng)
    with pytest.raises(ValueError):
        CM.soft_field_mm_fused(g2, 300, 2.0, 8.0, EPS)


def test_wrappers_refuse_other_devices():
    g = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError):
        CM.mm_fused_fwd(g, 0.0, 3, 3, TAU, T, EPS)
    with pytest.raises(ValueError):
        CM.mm_fused_bwd(g, g, g, g, 0.0, 3, 3, TAU, T, EPS)
