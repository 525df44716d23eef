"""The undeclared-range dispatch of the PyTorch port (ops/softsdf.py: the
runtime gate, then ops/cuda_soft_mm.soft_field_mm_rt or
ops/soft_fused.soft_sdf_field_fused) against the JAX package's gate as it
runs on its accelerator (chaq_sdfgen_tpu/ops/softsdf.py:265-324, replicated
here with the Pallas kernels in interpret mode, as tests/test_soft.py does),
and SDFGenerator and the CLI on that path against the JAX kernels. On the
CPU, JAX's own soft_sdf_field takes its composed path, which clips heights
at (band + 1)^2 where the kernels clip at 1e30, so the kernels are the
reference here; beyond the adaptive kernels' geometry (band > 112, one
row) the port takes that composed path too, and JAX's CPU soft_sdf_field
is the reference there."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from chaq_sdfgen_tpu.ops import merge as jmerge
from chaq_sdfgen_tpu.ops import pallas_soft_fused as JF
from chaq_sdfgen_tpu.ops import pallas_soft_mm as PM
from chaq_sdfgen_tpu.ops import softsdf as jsoft
from chaq_sdfgen_tpu_torch import cli as tcli
from chaq_sdfgen_tpu_torch.config import SdfConfig, SoftConfig
from chaq_sdfgen_tpu_torch.models.sdf_model import SDFGenerator
from chaq_sdfgen_tpu_torch.ops import cuda_soft_mm, soft_fused, softsdf

EPS = 1e-6


def _jax_gate(g, band, tau, t):
    """JAX's gate (softsdf.py:272-286): the shift, or None for the adaptive
    kernels."""
    kk = min(16, band)
    limit = min(140.0 * t, kk * kk - 36.0 * t)
    if not limit > 0:
        return None
    labs = jnp.max(jnp.abs(jnp.asarray(g, jnp.float32) - 127.5)) / jnp.float32(tau)
    h_max = jnp.float32(t) * jax.nn.softplus(labs)
    if not bool(h_max <= jnp.float32(limit)):
        return None
    return float(jnp.maximum(h_max - jnp.float32(60.0 * t), 0.0))


def _jax_gated(g, band, tau, t, test_above=True):
    """JAX's gated dispatch for a 2-D image with the interpret kernels, as
    a function of the image (the branch and the shift, a constant to
    autograd in JAX too, are taken from ``g``)."""
    shift = _jax_gate(g, band, tau, t)
    if shift is not None:
        return lambda y: PM.soft_field_mm_rt(y, jnp.float32(shift), band, tau, t, EPS, test_above,
                                             interpret=True)
    return lambda y: JF.soft_sdf_field_fused(y, band, tau, t, EPS, test_above, True)


def _noise(shape, seed, lo=0.0, hi=255.0):
    return (np.random.default_rng(seed).random(shape) * (hi - lo) + lo).astype(np.float32)


def _with_extreme(shape, seed, value):
    g = _noise(shape, seed)
    g.flat[seed % g.size] = value
    return g


def _ulps(value, n):
    """The float32 ``n`` steps from ``value`` away from zero."""
    v = np.float32(value)
    for _ in range(n):
        v = np.nextafter(v, np.float32(np.copysign(1e30, value)))
    return float(v)


# (name, image, band, tau, T): both sides of h_max = limit, where the f32
# arithmetic lands exactly on the limit (tau 2, T 1: |g - 127.5| = 280 gives
# h_max = 140; one step below -152.5 still rounds to 280), limits at or
# below 0, and the CLI's out-of-gamut tau 0.25
GATE_CASES = [
    ("u8", _noise((30, 40), 1), 66, 2.0, 1.0),
    ("pm2000", _noise((30, 40), 2, -2000, 2000), 66, 2.0, 1.0),
    ("at-limit-above", _with_extreme((30, 40), 3, 407.5), 66, 2.0, 1.0),
    ("past-limit-above", _with_extreme((30, 40), 3, _ulps(407.5, 1)), 66, 2.0, 1.0),
    ("at-limit-below", _with_extreme((30, 40), 4, -152.5), 66, 2.0, 1.0),
    ("at-limit-below-rounded", _with_extreme((30, 40), 4, _ulps(-152.5, 1)), 66, 2.0, 1.0),
    ("past-limit-below", _with_extreme((30, 40), 4, _ulps(-152.5, 2)), 66, 2.0, 1.0),
    ("at-limit-T0.5", _with_extreme((30, 40), 5, 267.5), 66, 1.0, 0.5),
    ("past-limit-T0.5", _with_extreme((30, 40), 5, _ulps(267.5, 1)), 66, 1.0, 0.5),
    ("kk12-in", _noise((30, 40), 6), 12, 2.0, 1.0),
    ("kk12-out", _noise((30, 40), 6), 12, 0.5, 1.0),
    ("limit<=0-band5", _noise((30, 40), 7), 5, 2.0, 1.0),
    ("limit<=0-T8", _noise((30, 40), 8), 66, 2.0, 8.0),
    ("cli-tau0.25", _noise((30, 40), 9), 66, 0.25, 0.5),
    ("u8-T0.5", _noise((30, 40), 10), 66, 1.0, 0.5),
]


@pytest.mark.parametrize("name,g,band,tau,t", GATE_CASES, ids=[c[0] for c in GATE_CASES])
def test_gate_decision_matches_jax(name, g, band, tau, t):
    """The same branch, and the same float32 shift, as JAX's formula."""
    want = _jax_gate(g, band, tau, t)
    got = softsdf.runtime_gate(torch.from_numpy(g), band, tau, t)
    assert got == want
    if "past-limit" in name:
        assert got is None
    if "at-limit" in name:
        assert got is not None


def test_gate_reads_the_whole_batch():
    """Batches run as one: one image out of gamut sends all to the adaptive
    kernels (JAX vmaps its cond, which then takes both branches)."""
    g = np.stack([_noise((20, 24), 1), _noise((20, 24), 2, -2000, 2000)])
    assert softsdf.runtime_gate(torch.from_numpy(g[:1]), 66, 2.0, 1.0) is not None
    assert softsdf.runtime_gate(torch.from_numpy(g), 66, 2.0, 1.0) is None


@pytest.mark.parametrize("kind,branch", [("u8", "rt"), ("pm2000", "fused")])
def test_dispatch_takes_the_gate_branch(monkeypatch, kind, branch):
    called = []
    for mod, fn, tag in ((cuda_soft_mm, "soft_field_mm_rt", "rt"), (soft_fused, "soft_sdf_field_fused", "fused"),
                         (cuda_soft_mm, "soft_field_mm_fused", "declared")):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _real=real, _tag=tag, **k: (called.append(_tag), _real(*a, **k))[1])
    g = _noise((20, 24), 3) if kind == "u8" else _noise((20, 24), 3, -2000, 2000)
    softsdf.soft_sdf_field(torch.from_numpy(g), 14, tau=2.0, temperature=1.0)
    softsdf.soft_sdf_field(torch.from_numpy(g), 14, tau=2.0, temperature=1.0, gray_range=(-1e9, 1e9))
    assert called == [branch, branch]
    softsdf.soft_sdf_field(torch.from_numpy(_noise((20, 24), 3)), 14, tau=2.0, temperature=1.0,
                           gray_range=(0.0, 255.0))
    assert called[-1] == "declared"


def _jax_rt_memos(g, shift, band, tau, t, test_above):
    """The d2 memos of JAX's runtime-shift forward (PM.soft_field_mm_rt's
    kernel, interpret mode), unpadded."""
    kk = min(16, band)
    h, w = g.shape
    hp, wl = max(-(-h // 128) * 128, 256), -(-max(w, 128) // 128) * 128
    gp = jnp.pad(jnp.asarray(g), ((0, hp - h), (0, wl - w)), constant_values=PM._DEAD)
    edge = jnp.full((PM._HK, wl), PM._DEAD, jnp.float32)
    _, d2i, d2o = PM.mm_fused_fwd(gp, edge, edge, jnp.float32(shift), kk, kk, tau, t, EPS, test_above,
                                  True, True)
    return np.asarray(d2i)[:h, :w], np.asarray(d2o)[:h, :w]


KNEE = 1e-3  # |d2| below this marks a sigmoid-knee output


@pytest.mark.parametrize("kind", ["in-gamut", "out-of-gamut"])
@pytest.mark.parametrize("test_above", [True, False])
def test_branches_match_jax_gated(kind, test_above):
    """The cases of tests/test_soft.py:187-192 (128x128, band 16, tau 2,
    T 1): the in-gamut branch equals PM.soft_field_mm_rt and the
    out-of-gamut one soft_sdf_field_fused (interpret mode), the field
    within 1e-4 of either.

    In gamut the gradient is held as the declared path's is
    (test_torch_soft_mm.py): the port's backward given JAX's own forward
    memos within 1e-4 of the scale of jax.grad, and the whole chain within
    1e-4 with the cotangent zeroed at the knee outputs, those whose |d2| in
    JAX's memos is below KNEE = 1e-3 (0.09% of them here). Unmasked, the
    chain reads up to 2.4e-4 of the scale on some hosts: the two forwards
    sum in other orders, so their d2 differ in the last ulp (<= 4.8e-7),
    and at a knee output (d2 ~ 4e-4 here) the gate 0.5/sqrt(d2 + eps) is
    steep enough to turn that into the whole gap (ROADMAP Queue 3). Out of
    gamut the gradient is held within 1e-2 of the scale (JAX's bf16 dS1)."""
    rng = np.random.default_rng(33)
    g = (rng.random((128, 128)) * 255 if kind == "in-gamut" else rng.random((128, 128)) * 4000 - 2000)
    g = g.astype(np.float32)
    ct = rng.standard_normal(g.shape).astype(np.float32)
    band = 16
    fn = _jax_gated(g, band, 2.0, 1.0, test_above)
    want = np.asarray(fn(jnp.asarray(g)))

    def jax_grad(cot):
        return np.asarray(jax.grad(lambda y: jnp.vdot(fn(y), jnp.asarray(cot)))(jnp.asarray(g)))

    def port_grad(cot):
        x = torch.from_numpy(g).requires_grad_()
        got = softsdf.soft_sdf_field(x, band - 2, tau=2.0, temperature=1.0, test_above=test_above)
        (got * torch.from_numpy(cot)).sum().backward()
        return got.detach().numpy(), x.grad.numpy()

    got, got_g = port_grad(ct)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if kind == "out-of-gamut":
        want_g = jax_grad(ct)
        assert np.abs(got_g - want_g).max() <= 1e-2 * np.abs(want_g).max()
        return
    shift = _jax_gate(g, band, 2.0, 1.0)
    d2i, d2o = _jax_rt_memos(g, shift, band, 2.0, 1.0, test_above)
    want_g = jax_grad(ct)
    given = cuda_soft_mm.mm_fused_bwd(torch.from_numpy(ct), torch.from_numpy(d2i.copy()),
                                      torch.from_numpy(d2o.copy()), torch.from_numpy(g), shift, 16, 16,
                                      2.0, 1.0, EPS, test_above).numpy()
    assert np.abs(given - want_g).max() <= 1e-4 * np.abs(want_g).max()
    knee = (np.abs(d2i) < KNEE) | (np.abs(d2o) < KNEE)
    assert 0 < knee.mean() < 2e-3
    cot = np.where(knee, 0, ct).astype(np.float32)
    want_g = jax_grad(cot)
    assert np.abs(port_grad(cot)[1] - want_g).max() <= 1e-4 * np.abs(want_g).max()


def test_rt_branch_is_the_declared_kernels_with_the_gate_shift():
    g = torch.from_numpy(_noise((40, 50), 11))
    shift = softsdf.runtime_gate(g, 18, 2.0, 1.0)
    a = cuda_soft_mm.soft_field_mm_rt(g, shift, 18, 2.0, 1.0, EPS)
    b = cuda_soft_mm.mm_fused_fwd(g, shift, 16, 16, 2.0, 1.0, EPS, memos=False)
    assert torch.equal(a, b)
    assert cuda_soft_mm.soft_field_mm_rt_ok((40, 50), 18) and cuda_soft_mm.soft_field_mm_rt_ok((40, 50), 200)
    assert not cuda_soft_mm.soft_field_mm_rt_ok((50,), 18)


def _jax_composed(g, spread, tau, t, test_above=True):
    """JAX's soft_sdf_field on the CPU, its composed scan path, as a
    function of the image."""
    return lambda y: jsoft.soft_sdf_field(y, spread, tau=tau, temperature=t, eps=EPS, test_above=test_above)


@pytest.mark.parametrize("spread,shape,rng_", [(111, (20, 24), None), (64, (1, 24), None),
                                               (64, (3, 1, 24), (-1e9, 1e9))])
def test_refuses_outside_the_adaptive_geometry(spread, shape, rng_):
    """Band above 112 and fewer than 2 rows, where the adaptive kernels'
    geometry ends: the port takes the composed path there, as JAX does
    (TPU kernels 12-13, csrc/softmin.cu in the port). Field within 1e-4 and
    gradient within 1e-4 of the scale of JAX's CPU soft_sdf_field (its
    composed scans) on noise in +-2000."""
    rng = np.random.default_rng(spread + len(shape))
    g = (rng.random(shape) * 4000 - 2000).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    fn = _jax_composed(g, spread, 2.0, 1.0)

    @jax.jit
    def value_and_vjp(y, c):
        out, vjp = jax.vjp(fn, y)
        return out, vjp(c)[0]

    want, want_g = (np.asarray(a) for a in value_and_vjp(jnp.asarray(g), jnp.asarray(ct)))
    x = torch.from_numpy(g).requires_grad_()
    got = softsdf.soft_sdf_field(x, spread, tau=2.0, temperature=1.0, gray_range=rng_)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)
    assert np.abs(x.grad.numpy() - want_g).max() <= 1e-4 * np.abs(want_g).max()


def test_declared_in_gamut_range_still_takes_single_rows():
    g = torch.from_numpy(_noise((1, 24), 12))
    assert softsdf.soft_sdf_field(g, 64, tau=2.0, temperature=1.0, gray_range=(0.0, 255.0)).shape == (1, 24)


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[:h, :w]
    alpha = np.where((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 4) ** 2, 230, 10)
    alpha[h // 5:h // 5 + 3, w // 2:] = 200
    alpha = (alpha + rng.integers(-8, 9, size=shape)).clip(0, 255)
    return np.stack([rng.integers(0, 256, size=shape), alpha], -1).astype(np.uint8)


def _jax_bytes(field, spread):
    v = jmerge.soft_remap(jnp.asarray(field), spread, False, clamp="hard")
    return np.asarray(jnp.clip(v, 0.0, 255.0).astype(jnp.uint8))


@pytest.mark.parametrize("tau", [1.0, 0.25])
def test_sdf_generator_undeclared_range(tau):
    """SDFGenerator(soft=SoftConfig(gray_range=None)) on the CPU: tau 1
    takes the runtime-shift kernels (h_max 63.75 <= 70), tau 0.25 the
    adaptive ones; the field within 1e-4 and the bytes within 1 of JAX's
    gated kernels plus soft_remap."""
    img = _image((40, 52), 7)
    spread = 12
    gen = SDFGenerator(SdfConfig(spread=spread), soft=SoftConfig(tau=tau, gray_range=None), device="cpu")
    field = gen.generate_field(img).numpy()
    gray = img[..., 1].astype(np.float32)
    want = np.asarray(_jax_gated(gray, spread + 2, tau, 0.5)(jnp.asarray(gray)))
    np.testing.assert_allclose(field, want, atol=1e-4, rtol=0)
    got = gen.generate(img).numpy()
    assert np.abs(got.astype(int) - _jax_bytes(want, spread).astype(int)).max() <= 1


def test_cli_soft_out_of_gamut_tau(tmp_path):
    """--platform cpu --soft --soft-tau 0.25: out of the declared range's
    gamut, through the gate to the adaptive kernels; field within 1e-4 and
    bytes within 1 of the JAX kernels plus soft_remap."""
    png, out, npy = tmp_path / "in.png", tmp_path / "out.png", tmp_path / "f.npy"
    img = _image((48, 64), 3)
    Image.fromarray(img, mode="LA").save(png)
    assert tcli.main(["-i", str(png), "-o", str(out), "--platform", "cpu", "--soft", "--soft-tau", "0.25",
                      "-s", "12", "--soft-field", str(npy)]) == 0
    gray = img[..., 1].astype(np.float32)
    assert _jax_gate(gray, 14, 0.25, 0.5) is None
    want = np.asarray(JF.soft_sdf_field_fused(jnp.asarray(gray), 14, 0.25, 0.5, EPS, True, True))
    np.testing.assert_allclose(np.load(npy), want, atol=1e-4, rtol=0)
    px = np.asarray(Image.open(out))
    assert np.abs(px.astype(int) - _jax_bytes(want, 12).astype(int)).max() <= 1


def test_cli_soft_refuses_band_above_112(tmp_path):
    """--soft --soft-tau 0.25 -s 111: out of the declared range's gamut at
    band 113, past the adaptive kernels, so the composed path; field within
    1e-4 and bytes within 1 of JAX's CPU soft_sdf_field (its composed
    scans) plus soft_remap."""
    png, out, npy = tmp_path / "in.png", tmp_path / "out.png", tmp_path / "f.npy"
    img = _image((20, 24), 4)
    Image.fromarray(img, mode="LA").save(png)
    assert tcli.main(["-i", str(png), "-o", str(out), "--platform", "cpu", "--soft", "--soft-tau", "0.25",
                      "-s", "111", "--soft-field", str(npy)]) == 0
    gray = img[..., 1].astype(np.float32)
    want = np.asarray(jax.jit(_jax_composed(gray, 111, 0.25, 0.5))(jnp.asarray(gray)))
    np.testing.assert_allclose(np.load(npy), want, atol=1e-4, rtol=0)
    px = np.asarray(Image.open(out))
    assert np.abs(px.astype(int) - _jax_bytes(want, 111).astype(int)).max() <= 1
