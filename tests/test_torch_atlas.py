"""The port's batched glyph atlas (models/atlas.py) and the batched tier's
mesh helpers (parallel/distributed.py) against the JAX package's, on the
CPU: atlas_sdf byte for byte over the flags, one device and a ('data',
'y') mesh of logical CPU shards, the spread sweep, and the errors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chaq_sdfgen_tpu.config as jcfg
from chaq_sdfgen_tpu.models import atlas as jatlas
from chaq_sdfgen_tpu.models.sdf_model import hard_sdf_exact as j_hard_sdf_exact
from chaq_sdfgen_tpu_torch.config import SdfConfig, ShardingConfig
from chaq_sdfgen_tpu_torch.models import atlas
from chaq_sdfgen_tpu_torch.parallel import distributed
from chaq_sdfgen_tpu_torch.parallel.mesh import make_mesh


def _stack(n=2, h=64, w=96, seed=9):
    """Seeded noise in both channels (tests/test_dynamic_spread.py:113-123)."""
    return (np.random.default_rng(seed).random((n, h, w, 2)) * 255).astype(np.uint8)


def _glyphs(n=4, h=32, w=24, seed=0):
    """40% set alpha, gray 128 (tests/test_atlas_distributed.py:18-23)."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, h, w, 2), dtype=np.uint8)
    imgs[..., 1] = np.where(rng.random((n, h, w)) < 0.4, 255, 0)
    imgs[..., 0] = 128
    return imgs


FLAGS = [
    dict(spread=6),
    dict(spread=12, asymmetric=True),
    dict(spread=9, invert=True),
    dict(spread=20, channel="luminance"),
    dict(spread=4, asymmetric=True, invert=True, channel="luminance"),
]


@pytest.mark.parametrize("kw", FLAGS)
def test_atlas_matches_jax(kw):
    """Byte for byte JAX atlas_sdf on a (2, 64, 96, 2) stack, and each image
    byte for byte JAX hard_sdf_exact (use_pallas=False)."""
    imgs = _stack()
    got = atlas.atlas_sdf(imgs, SdfConfig(**kw), device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (2, 64, 96) and got.device.type == "cpu"
    want = np.asarray(jatlas.atlas_sdf(jnp.asarray(imgs), jcfg.SdfConfig(**kw)))
    np.testing.assert_array_equal(got.numpy(), want)
    cfg = jcfg.SdfConfig(**kw)
    for i in range(2):
        one = j_hard_sdf_exact(jnp.asarray(imgs[i]), cfg.spread, asymmetric=cfg.asymmetric,
                               channel=cfg.channel_offset, test_above=not cfg.invert, use_pallas=False)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(one))


def test_atlas_takes_a_tensor_and_the_glyph_stack():
    """A torch stack in, and the JAX distributed test's 40% glyphs, byte
    for byte per-image JAX hard_sdf_exact."""
    imgs = _glyphs()
    got = atlas.atlas_sdf(torch.from_numpy(imgs), SdfConfig(spread=6), device="cpu").numpy()
    for i in range(4):
        want = j_hard_sdf_exact(jnp.asarray(imgs[i]), spread=6, use_pallas=False)
        np.testing.assert_array_equal(got[i], np.asarray(want))


@pytest.mark.parametrize("kw", FLAGS[:2])
def test_atlas_over_a_mesh_equals_one_device(kw):
    """A (2, 4) ('data', 'y') mesh of logical CPU shards, given as a mesh
    and as a ShardingConfig, and a ('y',) mesh: the unsharded bytes."""
    imgs = _stack(n=4, h=64, w=48, seed=3)
    cfg = SdfConfig(**kw)
    want = atlas.atlas_sdf(imgs, cfg, device="cpu")
    mesh = make_mesh((2, 4), ("data", "y"), devices="cpu")
    assert torch.equal(atlas.atlas_sdf(imgs, cfg, mesh=mesh), want)
    sharding = ShardingConfig((2, 4), ("data", "y"), data_axis="data")
    assert torch.equal(atlas.atlas_sdf(imgs, cfg, sharding=sharding, device="cpu"), want)
    assert torch.equal(atlas.atlas_sdf(imgs, cfg, mesh=make_mesh((4,), devices="cpu")), want)


def test_atlas_errors():
    """atlas.py:41-46 and test_atlas_distributed.py:45-57: the shape, mesh
    with sharding, and check_mesh's batch 3 and height 30."""
    cpu_mesh = make_mesh((2, 4), ("data", "y"), devices="cpu")
    with pytest.raises(ValueError, match="gray\\+alpha"):
        atlas.atlas_sdf(np.zeros((4, 8, 8), np.uint8), SdfConfig(), device="cpu")
    with pytest.raises(ValueError, match="gray\\+alpha"):
        atlas.atlas_sdf_spread_sweep(np.zeros((4, 8, 8, 3), np.uint8), [4], device="cpu")
    with pytest.raises(ValueError, match="either mesh or sharding"):
        atlas.atlas_sdf(_glyphs(), SdfConfig(), mesh=cpu_mesh, sharding=ShardingConfig(), device="cpu")
    distributed.check_mesh(cpu_mesh, batch=4, height=32)
    with pytest.raises(ValueError, match="batch 3"):
        distributed.check_mesh(cpu_mesh, batch=3, height=32)
    with pytest.raises(ValueError, match="height 30"):
        distributed.check_mesh(cpu_mesh, batch=4, height=30)
    with pytest.raises(ValueError, match="batch 3"):
        atlas.atlas_sdf(_glyphs(n=3), SdfConfig(spread=4), mesh=cpu_mesh)
    with pytest.raises(ValueError, match="height 30"):
        atlas.atlas_sdf(_glyphs(h=30), SdfConfig(spread=4), mesh=cpu_mesh)


def test_global_mesh(monkeypatch):
    """('data', 'y') over the host's devices; y_per_host must divide them;
    several processes are refused; with no card only "cpu" runs."""
    mesh = distributed.global_mesh(y_per_host=4, devices="cpu")
    assert mesh.shape == {"data": 2, "y": 4} and mesh.axis_names == ("data", "y")
    assert distributed.global_mesh(devices="cpu").shape == {"data": 1, "y": 8}
    assert distributed.global_mesh(2, devices=["cpu"] * 6).shape == {"data": 3, "y": 2}
    with pytest.raises(ValueError, match="does not divide"):
        distributed.global_mesh(y_per_host=3, devices="cpu")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="11c"):
        distributed.global_mesh(devices="cpu")
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.global_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        atlas.atlas_sdf(_glyphs(), SdfConfig())


def test_sweep_matches_jax():
    """tests/test_dynamic_spread.py:113-123: spreads [5, 14, 30] byte for
    byte JAX's atlas_sdf_spread_sweep (one band, 32, for all three) and
    the port's atlas_sdf at each spread."""
    imgs, spreads = _stack(), [5, 14, 30]
    got = atlas.atlas_sdf_spread_sweep(imgs, spreads, device="cpu")
    assert got.shape == (3, 2, 64, 96) and got.dtype == torch.uint8
    want = np.asarray(jatlas.atlas_sdf_spread_sweep(jnp.asarray(imgs), spreads))
    np.testing.assert_array_equal(got.numpy(), want)
    for i, s in enumerate(spreads):
        assert torch.equal(got[i], atlas.atlas_sdf(imgs, SdfConfig(spread=s), device="cpu"))


@pytest.mark.parametrize("kw", [dict(), dict(asymmetric=True, invert=True, channel="luminance")])
def test_sweep_to_uint16_strips_equals_per_spread(kw):
    """Spreads up to 300 (band 304: uint16 strips in pass 1 for every
    spread) byte for byte atlas_sdf at each spread (uint8 strips below
    spread 253); a single-row stack keeps the reference's no-sqrt quirk."""
    spreads = [1, 8, 64, 300]
    assert atlas.sweep_band(spreads) == 304
    for imgs in (_stack(), _stack(h=1, seed=4)):
        got = atlas.atlas_sdf_spread_sweep(imgs, spreads, SdfConfig(**kw), device="cpu")
        for i, s in enumerate(spreads):
            assert torch.equal(got[i], atlas.atlas_sdf(imgs, SdfConfig(spread=s, **kw), device="cpu")), s


def test_sweep_band():
    """An explicit band at least max(spreads) + 2 gives the same bytes; a
    smaller one is refused."""
    imgs = _stack()
    want = atlas.atlas_sdf_spread_sweep(imgs, [3, 10], device="cpu")
    assert atlas.sweep_band([3, 10]) == 16
    assert torch.equal(atlas.atlas_sdf_spread_sweep(imgs, [3, 10], band=12, device="cpu"), want)
    with pytest.raises(ValueError, match="below max"):
        atlas.atlas_sdf_spread_sweep(imgs, [3, 10], band=11, device="cpu")
