"""The port's sharded hard tier (chaq_sdfgen_tpu_torch/parallel) on logical
CPU shards, byte for byte against the JAX package on its 8 virtual CPU
devices (tests/conftest.py), at <= 64x96: the halo exchanges against
JAX's under shard_map, the rdma exchange's plain version against
pallas_halo in interpret mode, the sharded EXACT, BRUTE and JFA pipelines
against JAX's sharded and single-device ones, and the model and CLI
entry points against the unsharded port. Every JAX call runs under
jax.jit: an eager shard_map compiles op by op (tens of seconds)."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from chaq_sdfgen_tpu.models.sdf_model import hard_sdf_exact_from_bool
from chaq_sdfgen_tpu.ops import brute as jbrute
from chaq_sdfgen_tpu.ops import jfa as jjfa
from chaq_sdfgen_tpu.parallel import halo as jhalo
from chaq_sdfgen_tpu.parallel import mesh as jmesh
from chaq_sdfgen_tpu.parallel import sharded as jsharded
from chaq_sdfgen_tpu.parallel.pallas_halo import exchange_row_halo_rdma as j_rdma

from chaq_sdfgen_tpu_torch import cli as tcli
from chaq_sdfgen_tpu_torch.config import SdfConfig, ShardingConfig, SoftConfig
from chaq_sdfgen_tpu_torch.models.sdf_model import SDFGenerator
from chaq_sdfgen_tpu_torch.parallel import cuda_halo, halo, mesh, sharded


def _mask(shape, seed, density=0.3):
    return np.random.default_rng(seed).random(shape) < density


def _tmesh(shape, names=("y",)):
    return mesh.make_mesh(shape, names, devices="cpu")


def _jmesh(shape, names=("y",)):
    return jmesh.make_mesh(shape, names)


def _jit(fn, *args):
    return np.asarray(jax.jit(fn)(*(jnp.asarray(a) for a in args)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _blocks(x, n, dim=0):
    """x split into n blocks along dim, as torch tensors (one chain)."""
    return [_t(p) for p in np.split(x, n, axis=dim)]


def _shard_map(fn, m, spec):
    return jax.shard_map(fn, mesh=m, in_specs=(spec,), out_specs=spec, check_vma=False)


# ---------------------------------------------------------------- the mesh


def test_make_mesh_shapes_and_refusals(monkeypatch):
    m = _tmesh((2, 4), ("y", "x"))
    assert m.shape == {"y": 2, "x": 4} and all(d.type == "cpu" for d in m.devices.flat)
    assert mesh.make_mesh(devices="cpu").shape == {"y": mesh.CPU_SHARDS}  # jax_num_cpu_devices=8
    one_card = mesh.make_mesh((3,), devices=["cuda:0"] * 3)  # logical shards of one card
    assert [str(d) for d in one_card.devices.flat] == ["cuda:0"] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh.make_mesh((2,))  # distinct cards by default, as JAX's jax.devices()
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        ShardingConfig((2, 2), ("y", "x")).build_mesh()
    with pytest.raises(ValueError):
        mesh.make_mesh((2, 2), ("y",), devices="cpu")


@pytest.mark.parametrize("spec_axes", [("data", "y", None), (None, "y", "x"), ("data", None, "x")])
def test_shard_and_unshard_round_trip(spec_axes):
    names = tuple(a for a in spec_axes if a is not None)
    m = _tmesh((2, 2), names)
    x = torch.arange(4 * 8 * 6).view(4, 8, 6)
    blocks = mesh.shard(x, m, spec_axes)
    assert blocks.shape == (2, 2)
    assert torch.equal(mesh.unshard(blocks, m, spec_axes), x)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard(torch.zeros(4, 8, 5), _tmesh((2, 3), ("y", "x")), (None, "y", "x"))


# ---------------------------------------------------------------- halos


@pytest.mark.parametrize("n,band", [(4, 3), (4, 20), (8, 17)])
def test_exchange_row_halo_matches_jax(n, band):
    g = np.random.default_rng(band).random((8 * n, 24)).astype(np.float32)
    m, fill = _jmesh((n,)), -7.25
    parts = _shard_map(lambda x: jhalo.exchange_row_halo_parts(x, band, "y", fill), m, P("y", None))
    ext = _shard_map(lambda x: jhalo.exchange_row_halo(x, band, "y", fill), m, P("y", None))
    j_up, j_dn = (np.asarray(a) for a in jax.jit(parts)(jnp.asarray(g)))
    ups, dns = halo.exchange_row_halo_parts(_blocks(g, n), band, fill)
    np.testing.assert_array_equal(torch.cat(ups).numpy(), j_up)
    np.testing.assert_array_equal(torch.cat(dns).numpy(), j_dn)
    np.testing.assert_array_equal(torch.cat(halo.exchange_row_halo(_blocks(g, n), band, fill)).numpy(),
                                  _jit(ext, g))


@pytest.mark.parametrize("n,band", [(4, 5), (4, 13)])
def test_exchange_col_halo_matches_jax(n, band):
    g = np.random.default_rng(n + band).integers(0, 3, (12, 6 * n)).astype(np.uint8)
    f = _shard_map(lambda x: jhalo.exchange_col_halo(x, band, "x", 2), _jmesh((n,), ("x",)), P(None, "x"))
    got = torch.cat(halo.exchange_col_halo(_blocks(g, n, 1), band, 2), dim=1)
    np.testing.assert_array_equal(got.numpy(), _jit(f, g))


@pytest.mark.parametrize("offset", [3, -13, 40])
def test_fetch_row_and_col_slab_match_jax(offset):
    g = np.random.default_rng(abs(offset)).integers(-1, 1000, (32, 24)).astype(np.int32)
    fr = _shard_map(lambda x: jhalo.fetch_row_slab(x, offset, "y", -1), _jmesh((4,)), P("y", None))
    got = torch.cat(halo.fetch_row_slab(_blocks(g, 4), offset, -1))
    np.testing.assert_array_equal(got.numpy(), _jit(fr, g))
    fc = _shard_map(lambda x: jhalo.fetch_col_slab(x, offset, "x", -1), _jmesh((4,), ("x",)), P(None, "x"))
    got = torch.cat(halo.fetch_col_slab(_blocks(g, 4, 1), offset, -1), dim=1)
    np.testing.assert_array_equal(got.numpy(), _jit(fc, g))


@pytest.mark.parametrize("n,band", [(4, 3), (8, 8), (8, 9), (8, 17)])
def test_rdma_plain_matches_jax_interpret(n, band):
    """The kernels' plain versions through the multi-hop chain, against
    pallas_halo.exchange_row_halo_rdma in interpret mode
    (tests/test_pallas_halo.py cases)."""
    g = np.random.default_rng(n * band).random((8 * n, 24)).astype(np.float32)
    fill = -7.25
    f = _shard_map(lambda x: j_rdma(x, band, "y", fill, True), _jmesh((n,)), P("y", None))
    before = dict(cuda_halo.LAUNCHES)
    got = torch.cat(cuda_halo.exchange_row_halo_rdma(_blocks(g, n), band, fill))
    assert cuda_halo.LAUNCHES == before  # CPU blocks: the plain versions, no launch
    np.testing.assert_array_equal(got.numpy(), _jit(f, g))


def test_halo_kernels_plain_versions():
    g = [torch.full((2, 4, 5), i, dtype=torch.uint16) for i in range(3)]
    ups, dns = cuda_halo.halo_slab(g, 2, 65535)
    assert [int(u[0, 0, 0]) for u in ups] == [65535, 0, 1] and [int(d[0, 0, 0]) for d in dns] == [1, 2, 65535]
    up, dn = cuda_halo.halo_ring_shift(g, g)
    assert [int(u[0, 0, 0]) for u in up] == [2, 0, 1] and [int(d[0, 0, 0]) for d in dn] == [1, 2, 0]
    with pytest.raises(ValueError):
        cuda_halo.halo_slab(g, 5, 0)  # band above the shard's height: the multi-hop chain's job
    # the rdma exchange is differentiable: its VJP adds each halo row's cotangent to its owner's
    blocks = [torch.arange(12.0).view(4, 3).add(10 * i).requires_grad_() for i in range(2)]
    ext = cuda_halo.exchange_row_halo_rdma(blocks, 2, 0.0)
    sum(e.sum() for e in ext).backward()
    assert blocks[0].grad.tolist() == [[1.0] * 3, [1.0] * 3, [2.0] * 3, [2.0] * 3]
    assert blocks[1].grad.tolist() == [[2.0] * 3, [2.0] * 3, [1.0] * 3, [1.0] * 3]
    assert cuda_halo._fill_word(255, torch.uint8) == 0xFFFFFFFF
    assert cuda_halo._fill_word(7, torch.uint16) == 0x00070007
    assert cuda_halo._fill_word(-1, torch.int32) == 0xFFFFFFFF


# ---------------------------------------------------------------- EXACT


@pytest.mark.parametrize("n,shape,spread", [(2, (64, 40), 9), (4, (64, 40), 9), (8, (64, 40), 9),
                                            (8, (64, 32), 18)])
def test_sharded_exact_matches_jax_sharded(n, shape, spread):
    """test_sharded.py:25-44 (n 2/4/8; band 20 over 8-row shards, multi-hop),
    both halo implementations against JAX's ppermute run."""
    b = _mask(shape, n + spread)
    jm = _jmesh((n,))
    want = _jit(lambda x: jsharded.sharded_hard_sdf_bytes(x, spread, jm, use_pallas=False), b)
    for impl in ("ppermute", "rdma"):
        got = sharded.sharded_hard_sdf_bytes(_t(b), spread, _tmesh((n,)), halo=impl)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,spread", [(4, 5), (8, 18)])
def test_sharded_exact_rdma_matches_jax_rdma(n, spread):
    """Against JAX's rdma run (its remote-copy kernels in interpret mode):
    one hop, and band 20 over 8-row shards (3 ring shifts)."""
    b = _mask((8 * n, 32), n * spread)
    jm = _jmesh((n,))
    want = _jit(lambda x: jsharded.sharded_hard_sdf_bytes(x, spread, jm, use_pallas=False, halo="rdma"), b)
    got = sharded.sharded_hard_sdf_bytes(_t(b), spread, _tmesh((n,)), halo="rdma")
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_exact_batched_data_y_mesh():
    b = _mask((4, 32, 24), 1, 0.4)
    jm = _jmesh((2, 4), ("data", "y"))
    want = _jit(lambda x: jsharded.sharded_hard_sdf_bytes(x, 6, jm, batch_axis="data", use_pallas=False), b)
    got = sharded.sharded_hard_sdf_bytes(_t(b), 6, _tmesh((2, 4), ("data", "y")), batch_axis="data")
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_exact_sparse_seed_across_seam():
    """test_sharded.py:459-476 at 64x96: a lone seed 14 rows below shard 0's
    seam, inside the spread, with a halo (band 26) taller than a shard."""
    b = np.zeros((64, 96), bool)
    b[30, 40] = True
    jm = _jmesh((4,))
    want = _jit(lambda x: jsharded.sharded_hard_sdf_bytes(x, 24, jm, use_pallas=False), b)
    for impl in ("ppermute", "rdma"):
        got = sharded.sharded_hard_sdf_bytes(_t(b), 24, _tmesh((4,)), halo=impl)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ny,nx,shape,spread,asymmetric", [
    (2, 4, (64, 96), 9, False),    # wide tiles
    (4, 2, (64, 48), 5, False),    # tall tiles
    (2, 4, (64, 96), 24, False),   # band 26 > W_local 24: the column halo hops 2 shards
    (2, 2, (48, 96), 11, True),    # asymmetric, not square
])
def test_sharded_exact_2d_matches_jax(ny, nx, shape, spread, asymmetric):
    """test_mesh_2d.py:30-72 at <= 64x96, against JAX's single-device XLA
    pipeline (which those tests hold equal to JAX's 2-D sharded run)."""
    b = _mask(shape, ny * 10 + nx + spread)
    want = _jit(lambda x: hard_sdf_exact_from_bool(x, spread, asymmetric=asymmetric, use_pallas=False), b)
    for impl in ("ppermute", "rdma"):
        got = sharded.sharded_hard_sdf_bytes(_t(b), spread, _tmesh((ny, nx), ("y", "x")), asymmetric=asymmetric,
                                             x_axis="x", halo=impl)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_exact_u16_and_single_row_strips():
    """Band 302 (uint16 strips) over 4 shards of 16 rows (hops 19), and
    shard heights of 1 row: any shard height, any band."""
    b = _mask((64, 40), 3, 0.02)
    want = _jit(lambda x: hard_sdf_exact_from_bool(x, 300, use_pallas=False), b)
    np.testing.assert_array_equal(sharded.sharded_hard_sdf_bytes(_t(b), 300, _tmesh((4,))).numpy(), want)
    small = _mask((8, 24), 4)
    want = _jit(lambda x: hard_sdf_exact_from_bool(x, 5, use_pallas=False), small)
    for impl in ("ppermute", "rdma"):
        got = sharded.sharded_hard_sdf_bytes(_t(small), 5, _tmesh((8,)), halo=impl)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- BRUTE


def _jbrute(b, spread, **kw):
    return _jit(lambda x: jbrute.brute_sdf_bytes(x, spread, use_pallas=False, **kw), b)


@pytest.mark.parametrize("n,shape,spread,kw,seed_at", [
    (2, (64, 40), 9, {}, None),
    (4, (64, 40), 9, {}, None),
    (8, (64, 32), 20, {}, None),                                   # spread > 8-row shards
    (4, (32, 24), 7, {"invert": True, "asymmetric": True}, None),
    (2, (64, 32), 30, {}, (33, 10)),                               # lone seed just below the seam
])
def test_sharded_brute_1d_matches_jax(n, shape, spread, kw, seed_at):
    """test_sharded.py:478-511, against JAX's single-device XLA pipeline."""
    if seed_at is None:
        b = _mask(shape, n + spread, 0.35)
    else:
        b = np.zeros(shape, bool)
        b[seed_at] = True
    want = _jbrute(b, spread, **kw)
    for impl in ("ppermute", "rdma"):
        got = sharded.sharded_brute_sdf_bytes(_t(b), spread, _tmesh((n,)), halo=impl, **kw)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_brute_batched_data_y_mesh():
    b = _mask((4, 32, 24), 7, 0.35)
    got = sharded.sharded_brute_sdf_bytes(_t(b), 6, _tmesh((2, 4), ("data", "y")), batch_axis="data")
    np.testing.assert_array_equal(got.numpy(), _jbrute(b, 6))


def test_sharded_brute_matches_jax_sharded_interpret():
    """One case against JAX's sharded BRUTE itself (its halo-operand Pallas
    kernel, pallas_brute.py:622, in interpret mode)."""
    b = _mask((32, 24), 12, 0.35)
    jm = _jmesh((2,))
    want = _jit(lambda x: jsharded.sharded_brute_sdf_bytes(x, 5, jm), b)
    np.testing.assert_array_equal(sharded.sharded_brute_sdf_bytes(_t(b), 5, _tmesh((2,))).numpy(), want)


@pytest.mark.parametrize("ny,nx,shape,spread,kw,seed_at", [
    (2, 4, (64, 96), 9, {}, None),
    (4, 2, (64, 48), 5, {}, None),
    (2, 4, (64, 96), 30, {}, None),                                # spread 30 > W_local 24
    (2, 2, (64, 64), 25, {}, (30, 29)),                            # crosses both seams
    (2, 2, (48, 96), 11, {"invert": True, "asymmetric": True}, None),
])
def test_sharded_brute_2d_matches_jax(ny, nx, shape, spread, kw, seed_at):
    """test_mesh_2d.py:75-135 at <= 64x96, against JAX's single-device XLA
    pipeline."""
    if seed_at is None:
        b = _mask(shape, ny * 100 + nx + spread)
    else:
        b = np.zeros(shape, bool)
        b[seed_at] = True
    got = sharded.sharded_brute_sdf_bytes(_t(b), spread, _tmesh((ny, nx), ("y", "x")), x_axis="x", **kw)
    np.testing.assert_array_equal(got.numpy(), _jbrute(b, spread, **kw))


# ---------------------------------------------------------------- JFA


@pytest.mark.parametrize("shape,seed", [((2,), 2), ((8,), 8), ((8,), "stride"), ((2, 4), 6), ((4, 2), 6)])
def test_sharded_jfa_matches_jax_sharded(shape, seed):
    """test_sharded.py:290-330 and 529-545: 1-D n 2/8, strides up to 32
    over 8-row shards (multi-hop), and 2-D tile meshes (column slabs past
    the tile width)."""
    if seed == "stride":
        b = _mask((64, 32), 99, 0.02)
        b[3, 5] = True
    else:
        b = _mask((64, 48), seed, 0.15)
    x_axis = "x" if len(shape) == 2 else None
    names = ("y", "x") if x_axis else ("y",)
    jm = _jmesh(shape, names)
    want = _jit(lambda x: jsharded.sharded_jfa_distance(x, jm, x_axis=x_axis), b)
    got = sharded.sharded_jfa_distance(_t(b), _tmesh(shape, names), x_axis=x_axis)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_jfa_corner_seed_matches_jax():
    b = np.zeros((32, 32), bool)
    b[3, 2] = True
    want = _jit(jjfa.jfa_distance, b)
    got = sharded.sharded_jfa_distance(_t(b), _tmesh((4, 2), ("y", "x")), x_axis="x")
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- model, CLI, refusals


def _image(shape=(64, 96), seed=3):
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[:h, :w]
    alpha = np.where((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 4) ** 2, 230, 10)
    alpha[h // 5 : h // 5 + 3, w // 2 :] = 200
    alpha = (alpha + rng.integers(-8, 9, size=shape)).clip(0, 255)
    return np.stack([rng.integers(0, 256, size=shape), alpha], -1).astype(np.uint8)


@pytest.mark.parametrize("algorithm", ["exact", "brute", "jfa"])
def test_sdf_generator_sharded_equals_unsharded(algorithm):
    img = _image()
    cfg = SdfConfig(spread=7, algorithm=algorithm, invert=algorithm == "brute")
    want = SDFGenerator(cfg, device="cpu").generate(img)
    for sh in (ShardingConfig((4,), ("y",)), ShardingConfig((2, 2), ("y", "x"), halo_impl="rdma")):
        gen = SDFGenerator(cfg, sharding=sh, device="cpu")
        assert gen._mesh.devices.size == np.prod(sh.mesh_shape)
        assert torch.equal(gen.generate(img), want)
    if algorithm != "jfa":  # the data axis: hard and BRUTE
        batch = np.stack([img, _image(seed=4)])
        sh = ShardingConfig((2, 2), ("data", "y"), data_axis="data")
        assert torch.equal(SDFGenerator(cfg, sharding=sh, device="cpu").generate(batch),
                           SDFGenerator(cfg, device="cpu").generate(batch))


@pytest.fixture(scope="module")
def input_png(tmp_path_factory):
    path = tmp_path_factory.mktemp("shard_cli") / "in.png"
    Image.fromarray(_image(shape=(48, 64)), mode="LA").save(path)
    return str(path)


@pytest.mark.parametrize("flags", [["--shard-y", "4"], ["--shard-y", "2", "--shard-x", "2", "--halo-impl", "rdma"],
                                   ["--algorithm", "brute", "--shard-y", "2", "--halo-impl", "rdma", "-s", "9"],
                                   ["--algorithm", "jfa", "--shard-y", "4", "--shard-x", "2"]])
def test_cli_shard_flags_equal_unsharded(tmp_path, input_png, flags):
    base = [f for f in flags if f in ("--algorithm", "brute", "jfa", "-s", "9")]
    outs = []
    for extra in (flags, base):
        out = str(tmp_path / f"o{len(outs)}.png")
        assert tcli.main(["-i", input_png, "-o", out, "--platform", "cpu", *extra]) == 0
        outs.append(np.asarray(Image.open(out)))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_cli_shard_refusals(tmp_path, input_png, monkeypatch, capsys):
    out = str(tmp_path / "o.png")
    # --soft over a 2-D mesh with an undeclared range: JAX's refusal, one line
    assert tcli.main(["-i", input_png, "-o", out, "--platform", "cpu", "--soft", "--shard-y", "2", "--shard-x", "2",
                      "--gray-range", "-1000000000", "1000000000"]) == 1
    assert "requires the fused-mm tier" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    assert tcli.main(["-i", input_png, "-o", out, "--shard-y", "2"]) == 1
    assert "need 2 devices, have 1" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tcli.main(["-i", input_png, "-o", out, "--shard-y", "2", "--device", "1"]) == 1
    assert "--device selected cuda:1" in capsys.readouterr().err


def test_sharded_refusals():
    b = torch.from_numpy(_mask((32, 24), 1))
    with pytest.raises(ValueError, match="not divisible"):  # W % n_x, which JAX's BRUTE does not check
        sharded.sharded_brute_sdf_bytes(b[:, :22].contiguous(), 5, _tmesh((2, 4), ("y", "x")), x_axis="x")
    with pytest.raises(ValueError, match="not divisible"):
        sharded.sharded_hard_sdf_bytes(b[:, :22].contiguous(), 5, _tmesh((2, 4), ("y", "x")), x_axis="x")
    with pytest.raises(ValueError, match="not divisible"):
        sharded.sharded_hard_sdf_bytes(b[:30], 5, _tmesh((4,)))
    with pytest.raises(ValueError, match="spread <= 254"):
        sharded.sharded_brute_sdf_bytes(b, 255, _tmesh((2,)))
    with pytest.raises(ValueError, match="8-aligned"):
        sharded.sharded_brute_sdf_bytes(b, 5, _tmesh((8,)))
    with pytest.raises(ValueError, match="halo"):
        sharded.sharded_hard_sdf_bytes(b, 5, _tmesh((2,)), halo="nccl")
    # the sharded soft field is ported: its only refusal is JAX's, a 2-D mesh outside the declared tier
    gray = b.float() * 255
    assert torch.equal(sharded.sharded_soft_sdf_field(gray, 5, _tmesh((2,))),
                       sharded.sharded_soft_sdf_field(gray, 5, _tmesh((1,))))
    with pytest.raises(NotImplementedError, match="fused-mm tier"):
        sharded.sharded_soft_sdf_field(gray, 5, _tmesh((2, 2), ("y", "x")), x_axis="x")
    gen = SDFGenerator(soft=SoftConfig(), sharding=ShardingConfig((2,)), device="cpu")
    img = np.stack([np.full((32, 24), 255, np.uint8), (b.numpy() * 255).astype(np.uint8)], -1)
    np.testing.assert_allclose(gen.generate_field(img).numpy(),
                               SDFGenerator(soft=SoftConfig(), device="cpu").generate_field(img).numpy(),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="not the mesh's first card"):
        SDFGenerator(sharding=ShardingConfig((2,)), device="cuda:1")
