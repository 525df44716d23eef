"""The port's sharded soft field (parallel/sharded.sharded_soft_sdf_field)
on logical CPU shards, against the JAX package's on its virtual CPU
devices (tests/conftest.py) with each tier forced as the JAX tests force
it (Pallas in interpret mode), and against the port's own single-device
field: the declared kernels with shard halos (tier 1a, 'y' and ('y', 'x')
meshes), the shard-local two-conv split (1b: rows 17-18 at k2 <= 16, row
19 at k2 > 16), the adaptive kernels ('window' and 'split'), the composed
scan; the halo exchanges' VJPs; the plain versions of rows 17-19 against
JAX's kernels; and the entry points (SDFGenerator, SoftSDFModel, the CLI).

Tolerances: fields within JAX's own (rtol and atol 1e-5,
tests/test_sharded.py:350), but tier 1a within the 1e-4 that holds the
port's single-device declared kernels to JAX's (tests/test_torch_soft_mm.py:
47): 1a is that field bit for bit, and it differs from JAX's by up to 1.1e-5
at a knee (ROADMAP Queue 3 item 4). Gradients of a random linear loss within
1e-4 of the scale, the cotangent zeroed at sigmoid-knee outputs (|d2| <
1e-3 in the single-device memos, ROADMAP Queue 3 item 1). JAX's adaptive
kernels store dS1 as bf16, so their gradient is held at JAX's own 1e-2 of
the scale (tests/test_pallas_fused.py:147), and the adaptive tier's
gradient at 1e-4 against JAX's float32 composed tier, which computes the
same field where the composed path's height clip (band + 1)^2 does not bind.
Every JAX call runs under jax.jit: an eager shard_map compiles op by op."""

import functools

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import chaq_sdfgen_tpu.config as jcfg
import chaq_sdfgen_tpu.models.sdf_model as jmodel
import chaq_sdfgen_tpu.models.soft_model as jsm
from chaq_sdfgen_tpu.ops import pallas_band_conv as PC
from chaq_sdfgen_tpu.ops import soft_mxu as JM
from chaq_sdfgen_tpu.parallel import mesh as jmesh
from chaq_sdfgen_tpu.parallel import sharded as jsharded

from chaq_sdfgen_tpu_torch import cli as tcli
from chaq_sdfgen_tpu_torch.config import SdfConfig, ShardingConfig, SoftConfig
from chaq_sdfgen_tpu_torch.models import soft_model as tsm
from chaq_sdfgen_tpu_torch.models.sdf_model import SDFGenerator
from chaq_sdfgen_tpu_torch.ops import band_conv, cuda_soft_mm, soft_fused, soft_mxu, softsdf
from chaq_sdfgen_tpu_torch.parallel import cuda_halo, halo, mesh, sharded

TAU, EPS = 2.0, 1e-6
U8 = (0.0, 255.0)
KNEE = 1e-3  # |d2| below this marks a sigmoid-knee output


def _blobs(shape, seed, cell=8):
    """A smooth image in [0, 255]: bilinear noise on a ``cell`` grid, steep
    around 127.5, so that every tap radius sees strokes and open space."""
    rng = np.random.default_rng(seed)
    *lead, h, w = shape
    lo = rng.random((*lead, h // cell + 2, w // cell + 2))
    y, x = np.arange(h) / cell, np.arange(w) / cell
    y0, x0 = y.astype(int), x.astype(int)
    fy, fx = (y - y0)[:, None], (x - x0)[None, :]
    v = (lo[..., y0, :][..., x0] * (1 - fy) * (1 - fx) + lo[..., y0 + 1, :][..., x0] * fy * (1 - fx)
         + lo[..., y0, :][..., x0 + 1] * (1 - fy) * fx + lo[..., y0 + 1, :][..., x0 + 1] * fy * fx)
    return np.clip((v - 0.5) * 1020 + 127.5, 0, 255).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tmesh(shape, names=("y",)):
    return mesh.make_mesh(shape, names, devices="cpu")


def _jmesh(shape, names=("y",)):
    return jmesh.make_mesh(shape, names)


def _grad(fn, g, w):
    """d(sum(w * fn(g)))/dg by torch autograd."""
    x = _t(g).requires_grad_()
    (fn(x) * _t(w)).sum().backward()
    return x.grad.numpy()


def _jgrad(fn, g, w):
    return np.asarray(jax.jit(jax.grad(lambda x: jnp.vdot(fn(x), jnp.asarray(w))))(jnp.asarray(g)))


def _d2(g, spread, t, gray_range):
    """The single-device d2 memos of both fields (the knee rule's)."""
    band = spread + 2
    x = _t(g)
    if gray_range is not None:
        k1, k2, shift = soft_mxu.range_stats(band, TAU, t, gray_range)
        return [m.numpy() for m in soft_mxu.soft_field_collapsed(x, k1, k2, shift, TAU, t, EPS)[1:]]
    d2 = soft_fused.f2_plain(soft_fused.f1_plain(x, band, TAU, t), band, t, EPS)[1]
    return [d2[..., 0, :, :].numpy(), d2[..., 1, :, :].numpy()]


def _knee_masked(w, g, spread, t, gray_range):
    d2i, d2o = _d2(g, spread, t, gray_range)
    knee = (np.abs(d2i) < KNEE) | (np.abs(d2o) < KNEE)
    assert knee.mean() < 5e-3
    return np.where(knee, 0, w).astype(np.float32)


# (shape, mesh shape, axis names, spread, T, keyword arguments of both
# packages, the port's single-device twin, forward bitwise)
CASES = {
    "1a": ((512, 48), (4,), ("y",), 6, 1.0, dict(gray_range=U8, use_mm=True), "mm", True),
    "1a-2d": ((256, 256), (2, 2), ("y", "x"), 6, 1.0, dict(gray_range=U8, use_mm=True, x_axis="x"), "mm", True),
    "1b": ((48, 40), (4,), ("y",), 6, 1.0, dict(gray_range=U8, use_mm=True), "mm", False),
    "1b-wide": ((48, 40), (4,), ("y",), 30, 8.0, dict(gray_range=U8, use_mm=True), "wide", False),
    "2-window": ((64, 40), (4,), ("y",), 6, 1.0, dict(use_fused=True, fused_impl="window"), "fused", True),
    "2-split": ((64, 40), (4,), ("y",), 6, 1.0, dict(use_fused=True, fused_impl="split"), "fused", True),
    "3": ((60, 40), (4,), ("y",), 6, 1.0, {}, "cols", True),
}


def _single(kind, spread, t, test_above=True):
    band = spread + 2
    if kind == "mm":
        return lambda x: cuda_soft_mm.soft_field_mm_fused(x, band, TAU, t, EPS, test_above)
    if kind == "wide":
        return lambda x: softsdf.soft_sdf_field(x, spread, tau=TAU, temperature=t, eps=EPS, test_above=test_above,
                                                gray_range=U8)
    if kind == "fused":
        return lambda x: soft_fused.soft_sdf_field_fused(x, band, TAU, t, EPS, test_above)
    return lambda x: softsdf.soft_field_cols(x, band, TAU, t, EPS, test_above)


def _port(case, halo_impl="ppermute", test_above=True):
    shape, mshape, names, spread, t, kw, _, _ = CASES[case]
    m = _tmesh(mshape, names)
    return functools.partial(sharded.sharded_soft_sdf_field, spread=spread, mesh=m, tau=TAU, temperature=t,
                             eps=EPS, test_above=test_above, halo=halo_impl, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_tier_matches_jax(case):
    """Field and gradient of each tier against JAX's sharded function with
    the same tier forced; the launch-free dispatch is read from the kernel
    wrappers' plain versions (these tensors live on the CPU)."""
    shape, mshape, names, spread, t, kw, _, _ = CASES[case]
    g = _blobs(shape, 1)
    w = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jm = _jmesh(mshape, names)

    def jfn(x):
        return jsharded.sharded_soft_sdf_field(x, spread, jm, tau=TAU, temperature=t, eps=EPS, interpret=True,
                                               **kw)

    port = _port(case)
    got = port(_t(g)).numpy()
    tol = 1e-4 if case.startswith("1a") else 1e-5
    np.testing.assert_allclose(got, np.asarray(jax.jit(jfn)(jnp.asarray(g))), atol=tol, rtol=1e-5)
    cot = _knee_masked(w, g, spread, t, kw.get("gray_range"))
    grad = _grad(port, g, cot)
    want = _jgrad(jfn, g, cot)
    scale = np.abs(want).max()
    assert scale > 0
    if not kw.get("use_fused"):
        np.testing.assert_allclose(grad, want, atol=1e-4 * scale, rtol=0)
        return
    np.testing.assert_allclose(grad, want, atol=1e-2 * scale, rtol=0)  # JAX's bf16 dS1
    band = spread + 2
    assert (band + 1) ** 2 > t * (127.5 / TAU + 1)  # the composed path's clip does not bind
    composed = _jgrad(lambda x: jsharded.sharded_soft_sdf_field(x, spread, jm, tau=TAU, temperature=t, eps=EPS,
                                                                use_fused=False), g, cot)
    np.testing.assert_allclose(grad, composed, atol=1e-4 * np.abs(composed).max(), rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_tier_matches_one_device(case):
    """Against the port's single-device twin: the forward bit for bit
    where each output pixel sums the same taps in the same order (every
    tier but 1b, whose rows conv is a matrix product), the gradient bit
    for bit in 1a on a 'y' mesh, else within 1e-6 of the scale."""
    shape, mshape, names, spread, t, kw, kind, bitwise = CASES[case]
    g = _blobs(shape, 3)
    w = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    port, single = _port(case), _single(kind, spread, t)
    got, want = port(_t(g)).numpy(), single(_t(g)).numpy()
    if bitwise:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    gg, gw = _grad(port, g, w), _grad(single, g, w)
    if case == "1a":
        np.testing.assert_array_equal(gg, gw)
    else:
        np.testing.assert_allclose(gg, gw, atol=1e-6 * np.abs(gw).max(), rtol=0)


@pytest.mark.parametrize("case,n", [("1a", 4), ("1b", 4), ("2-window", 4), ("2-split", 16), ("3", 4)])
def test_rdma_equals_ppermute(case, n):
    """The rdma halo (plain versions of the kernels on the CPU, its VJP
    round the reverse ring) against ppermute: forward exact, gradient rtol
    1e-6; 16 shards of 4 rows at band 8 make the halos two hops."""
    shape, _, _, spread, t, kw, _, _ = CASES[case]
    g = _blobs(shape, 5)
    w = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    outs = []
    for impl in ("ppermute", "rdma"):
        fn = functools.partial(sharded.sharded_soft_sdf_field, spread=spread, mesh=_tmesh((n,)), tau=TAU,
                               temperature=t, eps=EPS, halo=impl, **kw)
        outs.append((fn(_t(g)).numpy(), _grad(fn, g, w)))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    assert np.abs(outs[0][1]).max() > 0
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("impl", ["ppermute", "rdma"])
@pytest.mark.parametrize("band", [3, 9])  # one hop, two hops over 6-row shards
def test_halo_exchange_vjp_scatter_adds(impl, band):
    """The VJP of both halo exchanges: each halo row's cotangent added back
    to the row it came from, the fill taking none."""
    rng = np.random.default_rng(band)
    n, h, w = 4, 6, 5
    x = rng.standard_normal((2, n * h, w)).astype(np.float32)
    cts = rng.standard_normal((n, 2, h + 2 * band, w)).astype(np.float32)
    blocks = [_t(b).requires_grad_() for b in np.split(x, n, axis=-2)]
    exchange = halo.exchange_row_halo if impl == "ppermute" else cuda_halo.exchange_row_halo_rdma
    ext = exchange(blocks, band, 7.0)
    sum((e * _t(c)).sum() for e, c in zip(ext, cts)).backward()
    want = np.zeros_like(x)
    for i in range(n):
        for r in range(h + 2 * band):
            y = i * h - band + r
            if 0 <= y < n * h:
                want[:, y] += cts[i, :, r]
    got = np.concatenate([b.grad.numpy() for b in blocks], axis=-2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_batch_axis_and_test_above():
    """A (4, H, W) batch over ('data', 'y') in each undeclared tier and in
    1a: each image equals its single-device field; test_above=False against
    JAX's sharded field."""
    g = _blobs((4, 64, 40), 7)
    m = _tmesh((2, 2), ("data", "y"))
    for kw, kind in ((dict(use_fused=True, fused_impl="window"), "fused"),
                     (dict(use_fused=True, fused_impl="split"), "fused"), (dict(use_fused=False), "cols")):
        got = sharded.sharded_soft_sdf_field(_t(g), 6, m, tau=TAU, temperature=1.0, eps=EPS, batch_axis="data", **kw)
        np.testing.assert_array_equal(got.numpy(), _single(kind, 6, 1.0)(_t(g)).numpy())
    g = _blobs((2, 256, 40), 8)
    got = sharded.sharded_soft_sdf_field(_t(g), 6, m, tau=TAU, temperature=1.0, eps=EPS, batch_axis="data",
                                         gray_range=U8)
    np.testing.assert_array_equal(got.numpy(), _single("mm", 6, 1.0)(_t(g)).numpy())
    g = _blobs((48, 40), 9)
    for kw in (dict(gray_range=U8, use_mm=True), dict(use_fused=True, fused_impl="window")):
        got = sharded.sharded_soft_sdf_field(_t(g), 6, _tmesh((4,)), tau=TAU, temperature=1.0, eps=EPS,
                                             test_above=False, **kw)
        want = jax.jit(lambda x: jsharded.sharded_soft_sdf_field(
            x, 6, _jmesh((4,)), tau=TAU, temperature=1.0, eps=EPS, test_above=False, interpret=True, **kw))(
            jnp.asarray(g))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_refusals():
    g = _t(_blobs((48, 40), 10))
    m2 = _tmesh((2, 2), ("y", "x"))
    with pytest.raises(sharded.XShardingRefused, match="fused-mm tier"):  # JAX's y-only adaptive and composed tiers
        sharded.sharded_soft_sdf_field(g, 6, m2, x_axis="x")
    with pytest.raises(sharded.XShardingRefused, match="128-aligned tile width"):
        sharded.sharded_soft_sdf_field(g, 6, m2, x_axis="x", gray_range=U8, tau=TAU, temperature=1.0)
    with pytest.raises(ValueError, match="use_mm"):
        sharded.sharded_soft_sdf_field(g, 6, _tmesh((4,)), use_mm=True)
    with pytest.raises(ValueError, match="fused_impl"):
        sharded.sharded_soft_sdf_field(g, 6, _tmesh((4,)), use_fused=True, fused_impl="ring")
    with pytest.raises(ValueError, match="not divisible"):
        sharded.sharded_soft_sdf_field(g[:46], 6, _tmesh((4,)))


# ------------------------------------------------------ rows 17-19, plain


@pytest.mark.parametrize("k", [5, 16])
def test_band_conv_plain_versions_match_jax(k):
    """The plain versions of rows 17-19 against JAX's p2_fused_fwd,
    p2_fused_bwd and cols_conv in interpret mode on a (128, 128) slab: the
    port takes the halo'd slab and returns its interior (forward) or takes
    the interior and returns the slab (backward)."""
    t, shift = 1.0, 3.0
    rng = np.random.default_rng(k)
    a_in = (rng.random((128, 128)) * 2).astype(np.float32)
    a_out = (rng.random((128, 128)) * 2).astype(np.float32)
    a_out[40:60, :30] = 0.0  # dead windows
    h = 128 - 2 * k
    jf, jd2i, jd2o = (np.asarray(a) for a in PC.p2_fused_fwd(jnp.asarray(a_in), jnp.asarray(a_out), k, t, shift,
                                                              EPS, True))
    tf, td2i, td2o = band_conv.p2_fused_fwd(_t(a_in), _t(a_out), k, t, shift, EPS)
    for got, want in ((tf, jf), (td2i, jd2i), (td2o, jd2o)):
        np.testing.assert_allclose(got.numpy(), want[k : k + h], rtol=1e-5, atol=1e-5)
    ct = rng.standard_normal((h, 128)).astype(np.float32)
    ct_slab = np.zeros((128, 128), np.float32)
    ct_slab[k : k + h] = ct
    jdi, jdo = PC.p2_fused_bwd(jnp.asarray(ct_slab), jnp.asarray(jd2i), jnp.asarray(jd2o), k, t, shift, EPS, True)
    tdi, tdo = band_conv.p2_fused_bwd(_t(ct), td2i, td2o, k, t, shift, EPS)
    for got, want in ((tdi, jdi), (tdo, jdo)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    e = rng.standard_normal((128, 128)).astype(np.float32)
    want = np.asarray(PC.cols_conv(jnp.asarray(e), k, t, True))
    np.testing.assert_allclose(band_conv.cols_conv(_t(e), k, t).numpy(), want[k : k + h], rtol=1e-5, atol=1e-5)
    back = band_conv.cols_conv(_t(e[k : k + h]), k, t, -k, 128).numpy()
    slab = np.zeros_like(e)
    slab[k : k + h] = e[k : k + h]
    np.testing.assert_allclose(back, np.asarray(PC.cols_conv(jnp.asarray(slab), k, t, True)), rtol=1e-5,
                               atol=1e-5)


def test_cols_conv_wide_taps_and_sym_functions():
    """Row 19 at k = 29 (beyond the TPU kernel's 16) against JAX's window
    einsum, and the two self-adjoint Functions' gradients against torch
    autograd of their plain versions."""
    k, t = 29, 8.0
    rng = np.random.default_rng(11)
    e = rng.standard_normal((100, 40)).astype(np.float32)
    want = np.asarray(JM._conv_cols(jnp.asarray(np.pad(e, ((0, 156), (0, 88)))), JM._band_matrix(k, t), k))
    np.testing.assert_allclose(band_conv.cols_conv(_t(e), k, t).numpy(), want[k : 100 - k, :40], rtol=1e-5,
                               atol=1e-5)
    w = rng.standard_normal((100 - 2 * k, 40)).astype(np.float32)
    plain = lambda x: band_conv.cols_conv_plain(x, k, t, k, 100 - 2 * k)  # noqa: E731
    np.testing.assert_array_equal(_grad(lambda x: soft_mxu.conv_cols_sym(x, k, t), e, w), _grad(plain, e, w))
    a = (rng.random((2, 52, 40)) * 2).astype(np.float32)
    w = rng.standard_normal((32, 40)).astype(np.float32)
    got = _grad(lambda x: soft_mxu.pass2_fused_sym(x[0], x[1], 10, 1.0, 3.0, EPS), a, w)
    want = _grad(lambda x: band_conv.p2_fused_fwd_plain(x[0], x[1], 10, 1.0, 3.0, EPS, memos=False), a, w)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


# ----------------------------------------------------------- entry points


def _image(shape=(64, 40), seed=12):
    alpha = _blobs(shape, seed).astype(np.uint8)
    return np.stack([np.full(shape, 255, np.uint8), alpha], -1)


@pytest.mark.parametrize("sh,rng", [(((4,), ("y",), None, "rdma"), (0.0, 255.0)),
                                    (((4,), ("y",), None, "ppermute"), None),
                                    (((2, 2), ("data", "y"), "data", "ppermute"), (0.0, 255.0))])
def test_sdf_generator_sharded_soft_matches_jax(sh, rng):
    """SDFGenerator(soft, sharding).generate_field against the JAX
    SDFGenerator's on the same mesh shape, and generate byte for byte the
    port's unsharded bytes where the forward is bitwise (declared range on
    128-row shards: tier 1a; undeclared: the adaptive kernels)."""
    shape, names, data, impl = sh
    img = _image((512, 40) if rng is not None and not data else (256, 40) if data else (64, 40))
    if data:
        img = np.stack([img, _image(img.shape[:2], 13)])
    cfg = SdfConfig(spread=6)
    soft = dict(tau=TAU, temperature=1.0, gray_range=rng)
    gen = SDFGenerator(cfg, soft=SoftConfig(**soft), device="cpu",
                       sharding=ShardingConfig(shape, names, data_axis=data, halo_impl=impl))
    jgen = jmodel.SDFGenerator(jcfg.SdfConfig(spread=6), soft=jcfg.SoftConfig(**soft),
                               sharding=jcfg.ShardingConfig(shape, names, data_axis=data, halo_impl=impl))
    field = gen.generate_field(img).numpy()
    np.testing.assert_allclose(field, np.asarray(jgen.generate_field(img)), atol=1e-5, rtol=1e-5)
    gray = _t(img[..., 1].astype(np.float32))
    want = (cuda_soft_mm.soft_field_mm_fused(gray, 8, TAU, 1.0, EPS) if rng is not None
            else soft_fused.soft_sdf_field_fused(gray, 8, TAU, 1.0, EPS))
    np.testing.assert_array_equal(field, want.numpy())
    np.testing.assert_array_equal(gen.generate(img).numpy(),
                                  SDFGenerator(cfg, soft=SoftConfig(**soft), device="cpu").generate(img).numpy()
                                  if rng is not None else gen.generate(img).numpy())


def test_soft_model_on_a_mesh_matches_jax_and_one_device():
    """SoftSDFModel(mesh=...) against the flax model on a JAX 'y' mesh (the
    undeclared adaptive tier; JAX forced onto its kernels in interpret mode
    as tests/test_torch_soft_model.py does), and one Adam step on a batch
    over ('data', 'y') against the same step on one device (parameters
    within 1e-6 of their size)."""
    soft = SoftConfig(tau=TAU, temperature=1.0)
    img = _image((32, 24), 14).astype(np.float32)
    tm = tsm.SoftSDFModel(6, soft, mesh=_tmesh((2,)))
    jm = jsm.SoftSDFModel(spread=6, soft=jcfg.SoftConfig(tau=TAU, temperature=1.0), mesh=_jmesh((2,)))
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(img))
    orig = jsm.sharded_soft_sdf_field
    try:
        jsm.sharded_soft_sdf_field = lambda *a, **k: orig(*a, **k, use_fused=True, interpret=True)
        want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(img)))
    finally:
        jsm.sharded_soft_sdf_field = orig
    np.testing.assert_allclose(tm(_t(img)).detach().numpy(), want, atol=1e-5, rtol=1e-5)

    batch = np.stack([img, _image((32, 24), 15).astype(np.float32)])
    target = np.random.default_rng(16).standard_normal(batch.shape[:-1]).astype(np.float32)
    m = _tmesh((2, 2), ("data", "y"))
    steps = []
    for model in (tsm.SoftSDFModel(6, soft, mesh=m, batch_axis="data"), tsm.SoftSDFModel(6, soft, device="cpu")):
        assert model.threshold_bias.device == m.devices.flat[0]
        opt = tsm.create_train_state(model, lr=1e-2)
        loss = tsm.make_train_step(model, opt)(_t(batch), _t(target))
        steps.append((float(loss), [p.detach().numpy().copy() for p in model.parameters()]))
    assert steps[0][0] == pytest.approx(steps[1][0], rel=1e-6)
    for a, b in zip(steps[0][1], steps[1][1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * max(np.abs(b).max(), 1.0))


@pytest.fixture(scope="module")
def input_png(tmp_path_factory):
    path = tmp_path_factory.mktemp("soft_shard_cli") / "in.png"
    Image.fromarray(_image((64, 48), 17), mode="LA").save(path)
    return str(path)


@pytest.mark.parametrize("flags", [["--shard-y", "4", "--halo-impl", "rdma"],
                                   ["--shard-y", "4", "--gray-range", "-1000000000", "1000000000"]])
def test_cli_soft_over_a_mesh_equals_one_device(tmp_path, input_png, flags):
    """--soft with --shard-y: the bytes and the raw field of the unsharded
    run (tier 1b on 16-row shards, and the adaptive tier)."""
    outs = []
    for extra in (flags, [f for f in flags if f not in ("--shard-y", "4", "--halo-impl", "rdma")]):
        out, npy = str(tmp_path / f"o{len(outs)}.png"), str(tmp_path / f"f{len(outs)}.npy")
        argv = ["-i", input_png, "-o", out, "--platform", "cpu", "--soft", "--soft-tau", "2",
                "--soft-temperature", "1", "-s", "6", "--soft-field", npy, *extra]
        assert tcli.main(argv) == 0
        outs.append((np.asarray(Image.open(out)), np.load(npy)))
    np.testing.assert_allclose(outs[0][1], outs[1][1], atol=1e-5, rtol=0)
    assert np.abs(outs[0][0].astype(int) - outs[1][0].astype(int)).max() <= 1


def test_cli_names_only_the_mesh_refusal(tmp_path, input_png, monkeypatch, capsys):
    """The CLI ends a --soft run over a refused mesh with one line and exit
    1 (sharded.XShardingRefused, a NotImplementedError); any other
    NotImplementedError is not reported as that refusal."""
    out = str(tmp_path / "o.png")
    argv = ["-i", input_png, "-o", out, "--platform", "cpu", "--soft", "--shard-y", "2", "--shard-x", "2",
            "--gray-range", "-1000000000", "1000000000"]
    assert tcli.main(argv) == 1
    assert "--soft over this mesh: x-axis" in capsys.readouterr().err
    assert issubclass(sharded.XShardingRefused, NotImplementedError)

    def elsewhere(self, img):
        raise NotImplementedError("another path")

    monkeypatch.setattr(SDFGenerator, "generate", elsewhere)
    with pytest.raises(NotImplementedError, match="another path"):
        tcli.main(["-i", input_png, "-o", out, "--platform", "cpu", "--soft", "--shard-y", "2"])
