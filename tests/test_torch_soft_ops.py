"""The soft path's ops in the PyTorch port against the JAX package, on the
CPU: soft logits and heights, the soft remap, the declared-range gamut
(_range_stats), the tap weights, the composed band soft-min with its
autograd function, and a finite-difference check of the port's soft field.
Inputs come from numpy seeds and go to both sides."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chaq_sdfgen_tpu.ops import merge as jmerge
from chaq_sdfgen_tpu.ops import pallas_soft_mm as jpm
from chaq_sdfgen_tpu.ops import soft_mxu as jmxu
from chaq_sdfgen_tpu.ops import softsdf as jsoft
from chaq_sdfgen_tpu.ops import threshold as jthr
from chaq_sdfgen_tpu_torch.ops import merge as tmerge
from chaq_sdfgen_tpu_torch.ops import soft_mxu as tmxu
from chaq_sdfgen_tpu_torch.ops import softsdf as tsoft
from chaq_sdfgen_tpu_torch.ops import threshold as tthr

TINY = float(np.finfo(np.float32).tiny)
ULP = 2.0 ** -23  # float32 relative spacing at 1


def _gray(shape, seed, lo=-20.0, hi=280.0):
    return (np.random.default_rng(seed).random(shape) * (hi - lo) + lo).astype(np.float32)


@pytest.mark.parametrize("tau", [0.5, 1.0, 2.0, 3.0, 0.7])
@pytest.mark.parametrize("test_above", [True, False])
def test_soft_logits_match_jax(tau, test_above):
    g = _gray((33, 41), 1)
    want = np.asarray(jthr.soft_logits(jnp.asarray(g), tau, test_above))
    got = tthr.soft_logits(torch.from_numpy(g), tau, test_above).numpy()
    np.testing.assert_array_equal(got, want)  # one IEEE division each


@pytest.mark.parametrize("tau", [0.5, 1.0, 2.0, 0.7])
@pytest.mark.parametrize("temperature", [0.5, 1.0, 1.5])
@pytest.mark.parametrize("seeds_are_on", [True, False])
def test_soft_log_indicator_matches_jax(tau, temperature, seeds_are_on):
    """Equal to float32 rounding (exp/log1p differ by an ulp or two
    between torch and XLA) where JAX's value is normal. Where it is not,
    XLA has flushed a subnormal exp to zero; the port keeps it, and T
    scales it to at most a few TINY."""
    logits = np.asarray(jthr.soft_logits(jnp.asarray(_gray((33, 41), 2)), tau))
    want = np.asarray(jthr.soft_log_indicator_from_logits(jnp.asarray(logits), temperature,
                                                          seeds_are_on, 4489.0))
    got = tthr.soft_log_indicator_from_logits(torch.from_numpy(logits), temperature,
                                              seeds_are_on, 4489.0).numpy()
    normal = np.abs(want) >= TINY
    np.testing.assert_allclose(got[normal], want[normal], rtol=4 * ULP, atol=0)
    assert np.abs(got[~normal]).max(initial=0.0) < 1e-37


@pytest.mark.parametrize("clamp", ["hard", "tanh", "none"])
@pytest.mark.parametrize("asymmetric", [False, True])
@pytest.mark.parametrize("spread", [8, 64])
def test_soft_remap_matches_jax(clamp, asymmetric, spread):
    """Exact for 'hard' and 'none'; 'tanh' within 4 ulp of 256 (torch's
    and XLA's tanh differ by an ulp)."""
    v = _gray((40, 50), 3, lo=-2.5 * spread, hi=2.5 * spread)
    want = np.asarray(jmerge.soft_remap(jnp.asarray(v), spread, asymmetric, clamp))
    got = tmerge.soft_remap(torch.from_numpy(v), spread, asymmetric, clamp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0 if clamp != "tanh" else 4 * 256 * ULP / 2)


def test_soft_remap_rejects_unknown_clamp():
    with pytest.raises(ValueError):
        tmerge.soft_remap(torch.zeros(3), 8, False, "soft")


RANGE_GRID = [
    (band, tau, t, rng)
    for band in (3, 16, 66, 302)
    for tau in (0.25, 1.0, 2.0, 4.0)
    for t in (0.5, 1.0, 1.5, 8.0)
    for rng in ((0.0, 255.0), (-1e9, 1e9), (-300.0, 400.0), (127.0, 128.0))
]


def test_range_stats_equal_jax():
    """Equal, not close, over (band, tau, T, range), out-of-gamut (None)
    cases included, for both passes' margins."""
    nones = 0
    for band, tau, t, rng in RANGE_GRID:
        for margin in (0.0, jmxu._P2_MARGIN_T * t):
            want = jmxu._range_stats(band, tau, t, rng, margin=margin)
            assert tmxu._range_stats(band, tau, t, rng, margin=margin) == want
            nones += want is None
    assert nones > 0  # the grid reaches outside the gamut


def test_range_stats_defaults_fit_the_kernel_gate():
    """The three default soft calls (the CLI's tau 1 / T 0.5, the bench's
    2 / 1, and 4 / 1.5) at spread 64 all land inside k <= 16."""
    want = {(1.0, 0.5): (9, 10, 33.75), (2.0, 1.0): (10, 10, 3.75), (4.0, 1.5): (10, 11, 0.0)}
    for (tau, t), stats in want.items():
        assert tmxu.range_stats(66, tau, t, (0.0, 255.0)) == stats
    assert tmxu.range_stats(66, 1.0, 0.5, None) is None


@pytest.mark.parametrize("temperature", [0.5, 1.0])
@pytest.mark.parametrize("k", [9, 10, 16])
def test_tap_weights_equal_jax_bits(temperature, k):
    """Bit for bit equal to the entries of JAX's _wcolt (cols) and _wrow
    (rows) at the CLI's and the bench's temperatures."""
    got = np.asarray(tmxu.tap_weights(k, temperature), np.float32)
    cols = np.asarray(jpm._wcolt(k, temperature))[0, 16 - k : 17 + k]
    rows = np.asarray(jpm._wrow(k, temperature, 16))[16 - k : 17 + k, 0]
    np.testing.assert_array_equal(got.view(np.int32), cols.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), rows.view(np.int32))


@pytest.mark.parametrize("temperature", [0.25, 0.75, 1.5, 2.0, 3.0, 5.0])
def test_tap_weights_within_an_ulp_of_jax(temperature):
    """At other temperatures XLA's CPU exp differs from torch's by one ulp
    on a few taps (ROADMAP Queue 3); subnormal taps are zero on both."""
    got = np.asarray(tmxu.tap_weights(16, temperature), np.float32)
    want = np.asarray(jpm._wcolt(16, temperature))[0, :33]
    assert np.all((got == 0) == (want == 0))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


@pytest.mark.parametrize("axis", [-1, -2])
def test_band_softmin_matches_jax(axis):
    g = _gray((2, 19, 23), 4, lo=0.0, hi=20.0)
    want = np.asarray(jsoft.band_softmin(jnp.asarray(g), 4, 0.7, axis=axis))
    got = tsoft.band_softmin(torch.from_numpy(g), 4, 0.7, axis=axis).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", [-1, -2])
def test_band_softmin_autograd_function_matches_plain_scan(axis):
    """The custom backward (weights recomputed from the saved output)
    against torch autograd through the streaming scan itself."""
    g = torch.from_numpy(_gray((17, 21), 5, lo=0.0, hi=30.0))
    ct = torch.from_numpy(np.random.default_rng(6).standard_normal((17, 21)).astype(np.float32))
    band, t = 5, 0.9
    x1 = g.clone().requires_grad_()
    (tsoft.band_softmin(x1, band, t, axis=axis) * ct).sum().backward()
    x2 = g.clone().requires_grad_()
    pad = [band, band, 0, 0] if axis == -1 else [0, 0, band, band]
    gp = torch.nn.functional.pad(x2, pad, value=1e30)
    (tsoft._band_softmin_fwd_impl(gp, band, t, axis) * ct).sum().backward()
    # the same softmax weights by two float32 routes: 1e-5 of the scale
    got, want = x1.grad.numpy(), x2.grad.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_composed_field_matches_jax_composed():
    """The port's composed scan oracle against the JAX composed path (the
    JAX package's CPU default without a declared range)."""
    g = _gray((48, 40), 7, lo=0.0, hi=255.0)
    want = np.asarray(jsoft.soft_sdf_field(jnp.asarray(g), 9, tau=2.0, temperature=1.0))
    got = tsoft.soft_sdf_field_composed(torch.from_numpy(g), 9, tau=2.0, temperature=1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_soft_gradient_vs_finite_difference():
    """The port's declared-range field (the kernels' plain versions and
    the hand-written backward) against central differences, with the
    tolerance of tests/test_soft.py's finite-difference check."""
    rng = np.random.default_rng(3)
    h, w = 16, 14
    gray0 = (rng.random((h, w)) * 255).astype(np.float32)
    weights = torch.from_numpy(rng.standard_normal((h, w)).astype(np.float32))
    spread, tau, temp = 5, 4.0, 1.5

    def loss(g):
        s = tsoft.soft_sdf_field(g, spread, tau=tau, temperature=temp, gray_range=(0.0, 255.0))
        return (s * weights).sum()

    x = torch.from_numpy(gray0).requires_grad_()
    loss(x).backward()
    grad = x.grad.numpy()
    eps = 0.25
    for _ in range(12):
        y, xx = rng.integers(0, h), rng.integers(0, w)
        gp = gray0.copy(); gp[y, xx] += eps
        gm = gray0.copy(); gm[y, xx] -= eps
        fd = (loss(torch.from_numpy(gp)).item() - loss(torch.from_numpy(gm)).item()) / (2 * eps)
        assert abs(fd - grad[y, xx]) <= 2e-2 + 0.05 * abs(fd), (y, xx, fd, grad[y, xx])


def test_soft_sdf_field_refuses_undeclared_range():
    """Nothing is refused on one device any more. An undeclared or
    out-of-gamut range runs at every band and shape: through the runtime
    gate where the adaptive kernels' geometry allows (band <= 112, two rows
    or more), else the composed path, held within 1e-4 of JAX's CPU
    soft_sdf_field (its composed scans). Wide taps on a declared range
    (here k = 28 and 29 at tau 2, T 8) take the matrix-product path, held
    within 1e-4 of JAX's soft_mxu.soft_sdf_field_mxu on the CPU."""
    g = _gray((8, 8), 9, lo=-2000.0, hi=2000.0)
    row = _gray((1, 8), 10, lo=-2000.0, hi=2000.0)
    for rng in (None, (-1e9, 1e9)):
        assert tsoft.soft_sdf_field(torch.from_numpy(g), 8, gray_range=rng).shape == (8, 8)
        for x, spread in ((g, 111), (row, 8)):
            want = np.asarray(jsoft.soft_sdf_field(jnp.asarray(x), spread))
            got = tsoft.soft_sdf_field(torch.from_numpy(x), spread, gray_range=rng).numpy()
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    u8 = _gray((40, 36), 11, lo=0.0, hi=255.0)
    u8[10:20, 5:30] = 250.0  # a bar, so that d2 > 0 away from it
    want = np.asarray(jmxu.soft_sdf_field_mxu(jnp.asarray(u8), 302, 2.0, 8.0, 1e-6, True, (0.0, 255.0)))
    got = tsoft.soft_sdf_field(torch.from_numpy(u8), 300, tau=2.0, temperature=8.0, gray_range=(0.0, 255.0))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_soft_sdf_bytes_in_range():
    g = torch.from_numpy(_gray((20, 20), 8, lo=0.0, hi=255.0))
    out = tsoft.soft_sdf_bytes(g, 8, gray_range=(0.0, 255.0))
    assert out.dtype == torch.float32 and float(out.min()) >= 0.0 and float(out.max()) <= 255.0
    assert math.isfinite(float(out.sum()))
