"""The batched atlas (models/atlas.py) with algorithm="brute", on the CPU:
byte for byte per-image SDFGenerator(BRUTE) and sdfref's OpenCL oracle over
the flags, on one device and over a ('data', 'y') mesh of logical CPU
shards; JFA and the BRUTE sweep refused; EXACT's bytes unchanged; the
BRUTE spans under a profiler. Imports torch, numpy, sdfref and the port
only."""

import numpy as np
import pytest
import torch

from chaq_sdfgen_tpu_torch.config import Algorithm, SdfConfig, ShardingConfig
from chaq_sdfgen_tpu_torch.models import atlas
from chaq_sdfgen_tpu_torch.models.sdf_model import SDFGenerator
from chaq_sdfgen_tpu_torch.ops import cuda_brute
from chaq_sdfgen_tpu_torch.parallel.mesh import make_mesh
from chaq_sdfgen_tpu_torch.utils import profiling
from sdfref import oracle


def _stack(n=2, h=64, w=96, seed=9, share=0.3):
    """Scattered set pixels in alpha and gray (``share`` of them), so
    distances run past a few pixels and some pixels find nothing."""
    rng = np.random.default_rng(seed)
    img = np.where(rng.random((n, h, w, 2)) < share, 255, 0).astype(np.uint8)
    img[:, h // 3, :, 1] = 200  # a bar, so rows far from seeds have neighbours
    return img


FLAGS = [
    dict(spread=6),
    dict(spread=12, asymmetric=True),
    dict(spread=9, invert=True),
    dict(spread=20, channel="luminance"),
    dict(spread=5, asymmetric=True, invert=True, channel="luminance"),
]


def _opencl(img, cfg: SdfConfig) -> np.ndarray:
    return oracle.sdf_pipeline_opencl(img, cfg.spread, cfg.asymmetric, cfg.channel_offset == 0, cfg.invert)


@pytest.mark.parametrize("kw", FLAGS)
def test_brute_atlas_is_the_opencl_binary(kw):
    """(2, 64, 96, 2) sparse strokes: byte for byte per-image
    SDFGenerator(BRUTE).generate and the OpenCL oracle."""
    imgs = _stack(share=0.05)
    cfg = SdfConfig(algorithm="brute", **kw)
    got = atlas.atlas_sdf(imgs, cfg, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (2, 64, 96) and got.device.type == "cpu"
    gen = SDFGenerator(cfg, device="cpu")
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(), gen.generate(imgs[i]).numpy())
        np.testing.assert_array_equal(got[i].numpy(), _opencl(imgs[i], cfg))


def test_brute_atlas_differs_from_exact_where_the_binaries_do():
    """The diagonal quirk and the -n rule: BRUTE's bytes are not EXACT's on
    the same stack, so the algorithm reaches the pipeline."""
    imgs = _stack(share=0.05)
    brute = atlas.atlas_sdf(imgs, SdfConfig(spread=9, invert=True, algorithm="brute"), device="cpu")
    exact = atlas.atlas_sdf(imgs, SdfConfig(spread=9, invert=True), device="cpu")
    assert int((brute != exact).sum()) > 0


@pytest.mark.parametrize("kw", [FLAGS[0], FLAGS[3]])
def test_brute_atlas_over_a_mesh_equals_one_device(kw):
    """A (2, 2) ('data', 'y') mesh of logical CPU shards, given as a mesh
    and as a ShardingConfig: the one-device bytes."""
    imgs = _stack(share=0.05, seed=3)
    cfg = SdfConfig(algorithm="brute", **kw)
    want = atlas.atlas_sdf(imgs, cfg, device="cpu")
    mesh = make_mesh((2, 2), ("data", "y"), devices="cpu")
    assert torch.equal(atlas.atlas_sdf(imgs, cfg, mesh=mesh), want)
    sharding = ShardingConfig((2, 2), ("data", "y"), data_axis="data")
    assert torch.equal(atlas.atlas_sdf(imgs, cfg, sharding=sharding, device="cpu"), want)


def test_jfa_and_the_brute_sweep_are_refused():
    imgs = _stack()
    with pytest.raises(ValueError, match="exact and brute"):
        atlas.atlas_sdf(imgs, SdfConfig(algorithm=Algorithm.JFA), device="cpu")
    with pytest.raises(ValueError, match="exact and brute"):
        atlas.atlas_sdf(imgs, SdfConfig(algorithm="jfa"), mesh=make_mesh((2, 2), ("data", "y"), devices="cpu"))
    for algorithm in ("brute", "jfa"):
        with pytest.raises(ValueError, match="runs exact, not"):
            atlas.atlas_sdf_spread_sweep(imgs, [4, 8], SdfConfig(algorithm=algorithm), device="cpu")


@pytest.mark.parametrize("kw", [dict(spread=6), dict(spread=9, invert=True)])
def test_exact_atlas_is_unchanged(kw):
    """EXACT still takes its own path: per-image SDFGenerator(EXACT) bytes,
    and no BRUTE pass is entered."""
    imgs = _stack(share=0.05)
    cfg = SdfConfig(**kw)
    calls = dict(cuda_brute.LAUNCHES)
    got = atlas.atlas_sdf(imgs, cfg, device="cpu")
    gen = SDFGenerator(cfg, device="cpu")
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(), gen.generate(imgs[i]).numpy())
        want = oracle.sdf_pipeline_openmp(imgs[i], cfg.spread, cfg.asymmetric, cfg.channel_offset,
                                           not cfg.invert)
        np.testing.assert_array_equal(got[i].numpy(), want)
    assert cuda_brute.LAUNCHES == calls


BRUTE_SPANS = ("sdf.threshold", "sdf.brute_rows", "sdf.brute_scan")


@pytest.mark.parametrize("on_mesh", [False, True])
def test_brute_spans_nest_under_the_profiler(on_mesh):
    """Under torch.profiler a BRUTE atlas call records sdf.atlas and, inside
    it on its thread, the threshold and BRUTE op spans (on a mesh the scan
    is the halo scan, one a shard); no EXACT op span. The launches' spans
    are the card's (tests/test_torch_cuda_kernels.py)."""
    imgs = _stack(share=0.05)
    cfg = SdfConfig(spread=6, algorithm="brute")
    mesh = make_mesh((2, 2), ("data", "y"), devices="cpu") if on_mesh else None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        atlas.atlas_sdf(imgs, cfg, mesh=mesh, device=None if on_mesh else "cpu")
    events = [e for e in prof.events() if e.name.startswith(("sdf.", "launch."))]
    names = [e.name for e in events]
    assert names.count("sdf.atlas") == 1, names
    top = next(e for e in events if e.name == "sdf.atlas")
    for name in BRUTE_SPANS:
        held = [e for e in events if e.name == name]
        assert held, f"{name} not in {names}"
        for e in held:
            assert e.thread == top.thread
            assert top.time_range.start <= e.time_range.start <= e.time_range.end <= top.time_range.end
    assert names.count("sdf.brute_scan") == (4 if on_mesh else 1)
    assert not {"sdf.edt_rows", "sdf.edt_band"} & set(names)


def test_brute_spans_cost_one_check_without_a_profiler(monkeypatch):
    """With no profiler running the BRUTE sites never enter
    record_function (patched here to raise)."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    assert not profiling.recording()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    atlas.atlas_sdf(_stack(), SdfConfig(spread=6, algorithm="brute"), device="cpu")
    atlas.atlas_sdf(_stack(), SdfConfig(spread=6, algorithm="brute"), mesh=make_mesh((2, 2), ("data", "y"),
                                                                                      devices="cpu"))
