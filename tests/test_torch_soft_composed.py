"""The composed soft path of the PyTorch port (ops/softmin.py, the column
soft-min pair of csrc/softmin.cu, and ops/softsdf.soft_field_cols) and the
declared wide-tap path (ops/soft_mxu.soft_field_wide) against the JAX
package on the CPU: the plain versions against pallas_soft's kernels in
interpret mode, the field and its gradient against JAX's CPU soft_sdf_field
(which takes its composed scans there), SDFGenerator, the CLI and
SoftSDFModel past band 112, and the wide taps against
soft_mxu.soft_sdf_field_mxu. Inputs come from numpy seeds and go to both
sides."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import chaq_sdfgen_tpu.config as jcfg
import chaq_sdfgen_tpu.models.sdf_model as jmodel
import chaq_sdfgen_tpu.models.soft_model as jsm
from chaq_sdfgen_tpu.ops import pallas_soft
from chaq_sdfgen_tpu.ops import soft_mxu as jmxu
from chaq_sdfgen_tpu.ops import softsdf as jsoft
from chaq_sdfgen_tpu_torch import cli as tcli
from chaq_sdfgen_tpu_torch.config import SdfConfig, SoftConfig
from chaq_sdfgen_tpu_torch.models import soft_model as tsm
from chaq_sdfgen_tpu_torch.models.sdf_model import SDFGenerator
from chaq_sdfgen_tpu_torch.ops import cuda_soft_mm, soft_fused, soft_mxu, softmin, softsdf

EPS = 1e-6


def _noise(shape, seed, lo=-2000.0, hi=2000.0):
    return (np.random.default_rng(seed).random(shape) * (hi - lo) + lo).astype(np.float32)


def _disc(shape, seed, lo=0.0, hi=255.0):
    """A disc and a bar (values near hi) on a background near lo, with a
    little noise: d2 well above 0 away from the shapes."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[:h, :w]
    a = np.where((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 4) ** 2, 0.9, 0.04)
    a[h // 5:h // 5 + 3, w // 2:] = 0.8
    a = (a + rng.uniform(-0.03, 0.03, size=shape)).clip(0, 1)
    return (a * (hi - lo) + lo).astype(np.float32)


# ------------------------------------------------ the kernels' plain versions


@pytest.mark.parametrize("band,t", [(3, 0.5), (7, 1.5), (114, 1.0)])
def test_softmin_fwd_plain_matches_pallas(band, t):
    """The shapes of tests/test_pallas_soft.py and band 114, with its
    tolerance; also against the port's streaming scan."""
    rng = np.random.default_rng(band)
    gext = (rng.random((40 + 2 * band, 36)) * 30).astype(np.float32)
    want = np.asarray(pallas_soft.softmin_col_fwd(jnp.asarray(gext), band, t, interpret=True))
    got = softmin.softmin_col_fwd(torch.from_numpy(gext), band, t).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    scan = softsdf._band_softmin_fwd_impl(torch.from_numpy(gext), band, t, 0).numpy()
    np.testing.assert_allclose(got, scan, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("band,t", [(3, 0.5), (5, 1.0), (114, 1.0)])
def test_softmin_bwd_plain_matches_pallas(band, t):
    rng = np.random.default_rng(10 + band)
    h, w = 32, 24
    gext = (rng.random((h + 2 * band, w)) * 20).astype(np.float32)
    s = np.asarray(jsoft._band_softmin_fwd_impl(jnp.asarray(gext), band, t, 0))
    ct = rng.standard_normal((h, w)).astype(np.float32)
    want = np.asarray(pallas_soft.softmin_col_bwd(jnp.asarray(gext), jnp.asarray(s), jnp.asarray(ct), band, t,
                                                  interpret=True))
    got = softmin.softmin_col_bwd(torch.from_numpy(gext), torch.from_numpy(s.copy()), torch.from_numpy(ct),
                                  band, t).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("band", [4, 114])
def test_softmin_fwd_saturated_strip(band):
    """An all-1e30 strip stays finite and above 1e29 (tests/test_pallas_soft.py:34-39)."""
    out = softmin.softmin_col_fwd(torch.full((22 + 2 * band, 16), 1e30), band, 0.5)
    assert out.shape == (22, 16) and bool(torch.isfinite(out).all()) and bool((out > 1e29).all())


def test_softmin_batches_and_edges():
    """A batch is its images one by one; band 0 is the identity; empty
    fields and a too-short gext."""
    rng = np.random.default_rng(4)
    gext = torch.from_numpy((rng.random((3, 2, 30, 9)) * 50).astype(np.float32))
    s = softmin.softmin_col_fwd(gext, 5, 0.7)
    ct = torch.from_numpy(rng.standard_normal((3, 2, 20, 9)).astype(np.float32))
    dg = softmin.softmin_col_bwd(gext, s, ct, 5, 0.7)
    for i in range(3):
        assert torch.equal(s[i, 1], softmin.softmin_col_fwd(gext[i, 1], 5, 0.7))
        assert torch.equal(dg[i, 1], softmin.softmin_col_bwd(gext[i, 1], s[i, 1], ct[i, 1], 5, 0.7))
    assert torch.equal(softmin.softmin_col_fwd(gext, 0, 0.7), gext)
    assert softmin.softmin_col_fwd(torch.zeros((10, 0)), 5, 1.0).shape == (0, 0)
    assert softmin.softmin_col_fwd(torch.zeros((10, 4)), 5, 1.0).shape == (0, 4)
    assert torch.equal(softmin.softmin_col_bwd(torch.ones((10, 4)), torch.zeros((0, 4)), torch.zeros((0, 4)), 5,
                                               1.0), torch.zeros((10, 4)))
    with pytest.raises(ValueError):
        softmin.softmin_col_fwd(torch.zeros((9, 4)), 5, 1.0)


@pytest.mark.parametrize("axis", [-1, -2, 0])
def test_band_softmin_matches_jax_at_a_wide_band(axis):
    """band_softmin along each axis (moved to -2 and back) at band 113,
    value and custom VJP, against JAX's (its scans on the CPU)."""
    rng = np.random.default_rng(7)
    g = (rng.random((2, 23, 19)) * 40).astype(np.float32)
    ct = rng.standard_normal(g.shape).astype(np.float32)

    want, want_g = _jax_value_and_vjp(lambda y: jsoft.band_softmin(y, 113, 0.8, axis=axis), g, ct)
    x = torch.from_numpy(g).requires_grad_()
    got = softsdf.band_softmin(x, 113, 0.8, axis=axis)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5, atol=2e-5)
    assert np.abs(x.grad.numpy() - want_g).max() <= 1e-5 * np.abs(want_g).max()


# ------------------------------------------------------- the composed path


def _jax_value_and_vjp(fn, g, ct):
    """fn(g) and its VJP with ct, under one jax.jit (one compilation)."""
    def both(y, c):
        out, vjp = jax.vjp(fn, y)
        return out, vjp(c)[0]

    out, grad = jax.jit(both)(jnp.asarray(g), jnp.asarray(ct))
    return np.asarray(out), np.asarray(grad)


def _jax_field_and_grad(g, ct, spread, tau, t, test_above=True):
    return _jax_value_and_vjp(
        lambda y: jsoft.soft_sdf_field(y, spread, tau=tau, temperature=t, eps=EPS, test_above=test_above), g, ct)


def _port_field_and_grad(g, ct, spread, tau, t, test_above=True, gray_range=None):
    x = torch.from_numpy(g).requires_grad_()
    got = softsdf.soft_sdf_field(x, spread, tau=tau, temperature=t, eps=EPS, test_above=test_above,
                                 gray_range=gray_range)
    (got * torch.from_numpy(ct)).sum().backward()
    return got.detach().numpy(), x.grad.numpy()


COMPOSED_CASES = [
    # (image, spread, test_above, tau, T): bands 113-130, both senses, both (tau, T)
    ("pm2000", 111, True, 2.0, 1.0),
    ("pm2000", 128, False, 1.0, 0.5),
    ("pm2000", 120, True, 1.0, 0.5),
    ("disc", 111, False, 2.0, 1.0),
    ("disc", 128, True, 2.0, 1.0),
    ("disc", 116, True, 1.0, 0.5),
    ("disc", 124, False, 1.0, 0.5),
]


@pytest.mark.parametrize("kind,spread,test_above,tau,t", COMPOSED_CASES)
def test_composed_field_matches_jax(kind, spread, test_above, tau, t):
    """soft_sdf_field without a range at band > 112 (the composed path)
    against JAX's CPU soft_sdf_field: field within 1e-4, gradient within
    1e-4 of the scale of jax.grad. The disc spans +-2000 as the noise
    does, so that its heights pass the gate's gamut."""
    shape = (30, 34)
    g = _noise(shape, spread) if kind == "pm2000" else _disc(shape, spread, -2000.0, 2000.0)
    ct = np.random.default_rng(spread + 1).standard_normal(shape).astype(np.float32)
    want, want_g = _jax_field_and_grad(g, ct, spread, tau, t, test_above)
    got, got_g = _port_field_and_grad(g, ct, spread, tau, t, test_above)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(got_g - want_g).max() <= 1e-4 * np.abs(want_g).max()


@pytest.mark.parametrize("shape,spread", [((1, 37), 20), ((3, 1, 24), 64), ((2, 20, 24), 114)])
def test_composed_rows_and_batches(shape, spread):
    """One-row inputs (any band) and batches take the composed path; field
    and gradient against JAX's CPU soft_sdf_field as above."""
    g = _noise(shape, len(shape) + spread)
    ct = np.random.default_rng(spread).standard_normal(shape).astype(np.float32)
    want, want_g = _jax_field_and_grad(g, ct, spread, 2.0, 1.0)
    got, got_g = _port_field_and_grad(g, ct, spread, 2.0, 1.0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(got_g - want_g).max() <= 1e-4 * np.abs(want_g).max()


def test_out_of_gamut_declared_range_at_band_120():
    """A declared (0, 255) outside the gamut of tau 0.25, T 0.5 at band
    120: no gate past band 112, so the composed path; JAX's CPU path is
    composed whatever the range."""
    g = _disc((28, 33), 5)
    ct = np.random.default_rng(5).standard_normal(g.shape).astype(np.float32)
    assert soft_mxu.range_stats(120, 0.25, 0.5, (0.0, 255.0)) is None
    want, want_g = _jax_field_and_grad(g, ct, 118, 0.25, 0.5)
    got, got_g = _port_field_and_grad(g, ct, 118, 0.25, 0.5, gray_range=(0.0, 255.0))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(got_g - want_g).max() <= 1e-4 * np.abs(want_g).max()


def _counting(monkeypatch):
    """Record which soft path each call takes, and the column soft-mins."""
    calls = []
    for mod, fn in ((cuda_soft_mm, "soft_field_mm_fused"), (cuda_soft_mm, "soft_field_mm_rt"),
                    (soft_fused, "soft_sdf_field_fused"), (soft_mxu, "soft_field_wide"),
                    (softsdf, "soft_field_cols"), (softmin, "softmin_col_fwd"), (softmin, "softmin_col_bwd")):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _real=real, _fn=fn, **k: (calls.append(_fn), _real(*a, **k))[1])
    return calls


@pytest.mark.parametrize("shape,spread,rng_,tau,t,path", [
    ((12, 14), 64, (0.0, 255.0), 2.0, 1.0, "soft_field_mm_fused"),   # declared, k = 10
    ((12, 14), 64, (0.0, 255.0), 2.0, 8.0, "soft_field_wide"),       # declared, k = 28
    ((12, 14), 64, None, 2.0, 1.0, "soft_field_mm_rt"),              # gate, in gamut
    ((12, 14), 64, (-1e9, 1e9), 2.0, 1.0, "soft_field_mm_rt"),       # gate, in gamut
    ((12, 14), 110, None, 0.25, 0.5, "soft_sdf_field_fused"),        # gate, band 112
    ((12, 14), 111, None, 2.0, 1.0, "soft_field_cols"),              # band 113
    ((12, 14), 111, (0.0, 255.0), 0.25, 0.5, "soft_field_cols"),     # declared, out of gamut
    ((1, 14), 64, None, 2.0, 1.0, "soft_field_cols"),                # one row
    ((2, 1, 14), 8, (-1e9, 1e9), 2.0, 1.0, "soft_field_cols"),       # one-row batch
])
def test_dispatch_takes_jax_order(monkeypatch, shape, spread, rng_, tau, t, path):
    """The dispatch order of JAX softsdf.py:218-372; the composed path
    runs the soft-min twice each way (pass 1 on both fields in one call,
    pass 2 once)."""
    calls = _counting(monkeypatch)
    x = torch.from_numpy(_disc(shape[-2:], 3)).expand(shape).contiguous().requires_grad_()
    softsdf.soft_sdf_field(x, spread, tau=tau, temperature=t, gray_range=rng_).sum().backward()
    paths = [c for c in calls if not c.startswith("softmin_col")]
    assert paths == [path]
    cols = 2 if path == "soft_field_cols" else 0
    assert calls.count("softmin_col_fwd") == calls.count("softmin_col_bwd") == cols


# --------------------------------------------- entry points past band 112


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    alpha = (_disc(shape, seed) + rng.integers(-8, 9, size=shape)).clip(0, 255)
    return np.stack([rng.integers(0, 256, size=shape), alpha], -1).astype(np.uint8)


def test_sdf_generator_and_cli_at_spread_114(tmp_path):
    """SDFGenerator(soft=SoftConfig(gray_range=None)) and the CLI's --soft
    with an undeclared range at spread 114 against the JAX SDFGenerator
    (its CPU composed path): field within 1e-4, bytes within 1."""
    img = _image((26, 30), 8)
    soft = dict(tau=2.0, temperature=1.0)
    jgen = jmodel.SDFGenerator(jcfg.SdfConfig(spread=114), soft=jcfg.SoftConfig(**soft))
    want, want_px = np.asarray(jgen.generate_field(img)), np.asarray(jgen.generate(img))
    gen = SDFGenerator(SdfConfig(spread=114), soft=SoftConfig(gray_range=None, **soft), device="cpu")
    np.testing.assert_allclose(gen.generate_field(img).numpy(), want, atol=1e-4, rtol=0)
    assert np.abs(gen.generate(img).numpy().astype(int) - want_px.astype(int)).max() <= 1
    png, out, npy = tmp_path / "in.png", tmp_path / "out.png", tmp_path / "f.npy"
    Image.fromarray(img, mode="LA").save(png)
    assert tcli.main(["-i", str(png), "-o", str(out), "--platform", "cpu", "--soft", "-s", "114",
                      "--soft-tau", "2", "--soft-temperature", "1", "--gray-range", "-1e9", "1e9",
                      "--soft-field", str(npy)]) == 0
    np.testing.assert_allclose(np.load(npy), want, atol=1e-4, rtol=0)
    assert np.abs(np.asarray(Image.open(out)).astype(int) - want_px.astype(int)).max() <= 1


def test_soft_model_step_at_spread_114():
    """SoftSDFModel(spread=114) (band 116: the composed path) against the
    flax model through params_from_jax: field within 1e-4, loss within
    1e-5 relative, each parameter's gradient within 1e-3 of its size (the
    sums of pixel gradients that agree within 1e-4 of their scale)."""
    rng = np.random.default_rng(9)
    img2ch = np.stack([_noise((2, 22, 20), 9, 0.0, 255.0), _disc((22, 20), 9)[None].repeat(2, 0)], -1)
    target = rng.standard_normal((2, 22, 20)).astype(np.float32)
    jm = jsm.SoftSDFModel(spread=114, soft=jcfg.SoftConfig(tau=2.0, temperature=1.0))
    params = jm.init(jax.random.key(0), jnp.asarray(img2ch))
    tm = tsm.SoftSDFModel(114, SoftConfig(tau=2.0, temperature=1.0), device="cpu")
    tm.load_state_dict(tsm.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))

    @jax.jit
    def jax_step(p, x, y):
        def loss_fn(q):
            f = jm.apply(q, x)
            return jnp.mean((f - y) ** 2), f
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (j_loss, j_field), j_grads = jax_step(params, jnp.asarray(img2ch), jnp.asarray(target))
    field = tm(torch.from_numpy(img2ch))
    np.testing.assert_allclose(field.detach().numpy(), np.asarray(j_field), atol=1e-4, rtol=0)
    loss = torch.mean((field - torch.from_numpy(target)) ** 2)
    loss.backward()
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    for k, p in tm.named_parameters():
        want = np.asarray(j_grads["params"][k])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    step = tsm.make_train_step(tm, tsm.create_train_state(tm, lr=5e-2))
    assert np.isfinite(float(step(torch.from_numpy(img2ch), torch.from_numpy(target))))


# ------------------------------------------------------------- wide taps


@pytest.mark.parametrize("tau,t,k1,k2", [(2.0, 8.0, 28, 29), (1.0, 3.0, 22, 23)])
@pytest.mark.parametrize("test_above", [True, False])
def test_wide_taps_match_jax_mxu(tau, t, k1, k2, test_above):
    """The declared range (0, 255) with tap radii above 16: field within
    1e-4 and gradient within 1e-4 of the scale of JAX's
    soft_mxu.soft_sdf_field_mxu on the CPU (its einsum tail), and of the
    port's shifted-slice form soft_field_collapsed."""
    g = _disc((40, 52), 12)
    ct = np.random.default_rng(13).standard_normal(g.shape).astype(np.float32)
    assert soft_mxu.range_stats(66, tau, t, (0.0, 255.0))[:2] == (k1, k2)

    want, want_g = _jax_value_and_vjp(
        lambda y: jmxu.soft_sdf_field_mxu(y, 66, tau, t, EPS, test_above, (0.0, 255.0)), g, ct)
    got, got_g = _port_field_and_grad(g, ct, 64, tau, t, test_above, gray_range=(0.0, 255.0))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(got_g - want_g).max() <= 1e-4 * np.abs(want_g).max()
    y = torch.from_numpy(g).requires_grad_()
    plain = soft_mxu.soft_field_collapsed(y, k1, k2, soft_mxu.range_stats(66, tau, t, (0.0, 255.0))[2], tau, t,
                                          EPS, test_above)[0]
    (plain * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got, plain.detach().numpy(), atol=1e-4, rtol=0)
    assert np.abs(got_g - y.grad.numpy()).max() <= 1e-4 * np.abs(y.grad.numpy()).max()


def test_wide_taps_batch_and_tf32_refusal():
    """A batch is its images one by one (within float32 rounding of the
    products); the path refuses to run with TF32 products allowed."""
    g = torch.from_numpy(np.stack([_disc((30, 140), 1), _disc((30, 140), 2)]))
    both = soft_mxu.soft_field_wide(g, 66, 2.0, 8.0, EPS)
    for i in range(2):
        np.testing.assert_allclose(both[i].numpy(), soft_mxu.soft_field_wide(g[i], 66, 2.0, 8.0, EPS).numpy(),
                                   atol=1e-5, rtol=0)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="float32"):
            soft_mxu.soft_field_wide(g, 66, 2.0, 8.0, EPS)
    finally:
        torch.set_float32_matmul_precision(before)
