"""The ``brute_s64`` configuration on the CPU: its plain reference against
sdfref's OpenCL oracle byte for byte, a small run of its cell, the control
and the short-reach fault against its limit, a planted fault, and the
readers of its cell on synthetic traces."""

import io
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import brute, manifest, roofline, runner, spans, trace
from benchmark.harness.runner import LayerContext
from chaq_sdfgen_tpu_torch.models import atlas
from sdfref import oracle

REF = manifest.load_module(manifest.reference_path("brute_sdf"), "test_ref_brute_sdf")
SDF = {"spread": 64, "asymmetric": False, "channel": "alpha", "invert": False, "algorithm": "brute"}
CELL = "brute_s64.atlas_glyph"
SMALL = {"config": {"size": [128, 128]}, "traffic": {"channels": {"alpha": {"cell": 64, "margin": 8}}},
         "spec": {"sample": 4}}
SEED = 2**31 + 99


def _opencl(img: np.ndarray, cfg: dict) -> np.ndarray:
    return oracle.sdf_pipeline_opencl(img, cfg["spread"], cfg["asymmetric"], cfg["channel"] == "luminance",
                                      cfg["invert"])


def _image(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (64, 64, 2), dtype=np.uint8)
    img = np.zeros((64, 64, 2), np.uint8)
    yy, xx = np.mgrid[:64, :64]
    for _ in range(3):  # a few discs and a bar
        cy, cx, r = rng.integers(8, 56), rng.integers(8, 56), rng.integers(2, 9)
        img[..., 1][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 255
    img[rng.integers(0, 64), :, 1] = 255
    return img


@pytest.mark.parametrize("kind,seed", [("glyph", 1), ("noise", 2)])
@pytest.mark.parametrize("spread", [8, 64])
@pytest.mark.parametrize("asym", [False, True])
def test_reference_is_the_opencl_binary(kind, seed, spread, asym):
    img = _image(kind, seed + spread)
    cfg = dict(SDF, spread=spread, asymmetric=asym)
    got = REF.sdf_bytes(torch.from_numpy(img), cfg).numpy()
    np.testing.assert_array_equal(got, _opencl(img, cfg))


@pytest.mark.parametrize("cfg", [dict(SDF, spread=12, invert=True),
                                 dict(SDF, spread=10, asymmetric=True, invert=True, channel="luminance")])
def test_reference_follows_the_flags(cfg):
    img = _image("glyph", 5)
    img[..., 0] = img[..., 1][::-1]
    got = REF.sdf_bytes(torch.from_numpy(img), cfg).numpy()
    np.testing.assert_array_equal(got, _opencl(img, cfg))


def test_reference_skips_the_exact_diagonal():
    """The only seed nearer than 5 lies on the diagonal (3, 3) of the pixel:
    the binary never probes it, so the pixel's distance is 5, to the seed
    at (0, 5); and a pixel whose only seed is diagonal finds nothing."""
    img = np.zeros((24, 24, 2), np.uint8)
    img[10, 10, 1] = img[13, 18, 1] = 255
    cfg = dict(SDF, spread=8)
    got = REF.sdf_bytes(torch.from_numpy(img), cfg).numpy()
    np.testing.assert_array_equal(got, _opencl(img, cfg))
    five = ((np.float32(-(np.float32(5.0) - np.float32(1.0))) + np.float32(8.0)) * np.float32(255.0)) / np.float32(16.0)
    assert got[13, 13] == np.uint8(five)
    lone = np.zeros((24, 24, 2), np.uint8)
    lone[10, 10, 1] = 255
    assert REF.sdf_bytes(torch.from_numpy(lone), cfg).numpy()[13, 13] == 0  # -INF, clamped


def test_reference_takes_a_batch():
    imgs = np.stack([_image("glyph", 6), _image("noise", 7)])
    got = REF.sdf_bytes(torch.from_numpy(imgs), dict(SDF, spread=8)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], _opencl(imgs[i], dict(SDF, spread=8)))


def _run():
    return runner.run_cell(CELL, SEED, 0.2, False, "cpu", overrides=SMALL, out=io.StringIO(),
                           preloaded=frozenset(sys.modules))


def test_a_small_run_of_the_cell_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "hard_gpix_per_s", "hard_p95_ms"}


@pytest.mark.parametrize("kind", ["control", "short_band"])
def test_the_control_and_the_short_reach_fail_the_limit(kind):
    _, driver = runner.prepare(CELL, SEED, "cpu", SMALL, io.StringIO())
    assert not all(c.passes for c in driver.readings(kind))


def test_an_altered_byte_makes_correct_false(monkeypatch):
    fn = atlas.atlas_sdf

    def broken(*a, **k):
        out = fn(*a, **k).clone()
        out.view(-1)[out.numel() // 3] ^= 1
        return out

    monkeypatch.setattr(atlas, "atlas_sdf", broken)
    result = _run()
    assert result["correct"] is False and result["checks"]["wrong_bytes"]["value"] > 0


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": float(ts), "dur": float(dur), "tid": tid}


def _brute_call(t0):
    """One call: entry 40 us, threshold 5 (no launch), rows 10 with a 4 us
    launch, scan 12 with a 6 us launch; the entry's own time is 13 us."""
    return [_span("sdf.atlas", t0, 40), _span("sdf.threshold", t0 + 2, 5),
            _span("sdf.brute_rows", t0 + 10, 10), _span("launch.chaq_brute_rows", t0 + 14, 4),
            _span("sdf.brute_scan", t0 + 25, 12), _span("launch.chaq_brute_scan_bytes", t0 + 28, 6)]


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "brute_scan_staged", "ts": float(ts), "dur": float(dur)}


def _read(name, events, units, pixels=4 * 4096 * 4096):
    tr = trace.parse([_span(trace.WINDOW, 100.0, 100.0)] + events)
    reader = manifest.load_module(manifest.reader_path(name), "metric_" + name)
    return reader.read(LayerContext(tr, units, pixels, {}, lambda msg: None))


def test_the_span_readers_split_a_brute_call():
    ev = _brute_call(110) + _brute_call(155)
    got = {m: _read(m, ev, 2) for m in ("brute.entry_self_us", "brute.ops_self_us", "hard.launch_host_us")}
    assert got == {"brute.entry_self_us": pytest.approx(13.0), "brute.ops_self_us": pytest.approx(17.0),
                   "hard.launch_host_us": pytest.approx(10.0)}
    assert sum(got.values()) == pytest.approx(40.0)  # the three layers make up the entry


@pytest.mark.parametrize("name", ["brute.entry_self_us", "brute.ops_self_us"])
def test_a_program_without_brute_spans_reads_none(name):
    # the parent's atlas: EXACT's op spans for any algorithm
    exact = [_span("sdf.atlas", 110, 40), _span("sdf.threshold", 112, 5), _span("sdf.edt_rows", 120, 10),
             _span("sdf.edt_band", 135, 12)]
    assert _read(name, exact, 1) is None
    assert _read(name, _brute_call(110), 0) is None


def test_the_roofline_counts_bytes_over_device_time():
    # the cell is read by hard.kernel_roofline_pct: the bytes floor binds
    # BRUTE's tail (~25 operations a pixel) as it binds EXACT's pass 2 (55)
    npix = 4 * 4096 * 4096
    floor_s, bound = roofline.hard_floor(npix)
    assert bound == "bytes" and floor_s == pytest.approx(3 * npix / 3.35e12)
    # two calls, 60 us of BRUTE kernels in all: 30 us a call
    got = _read("hard.kernel_roofline_pct", [_kernel(110, 25), _kernel(150, 35)], 2)
    assert got == pytest.approx(100.0 * floor_s / 30e-6)
    assert _read("hard.kernel_roofline_pct", [], 2) is None


def test_the_brute_op_patterns():
    assert spans.matches("sdf.brute_rows", brute.OPS) and spans.matches("sdf.brute_scan", brute.OPS)
    assert spans.matches("sdf.threshold", brute.OPS) and not spans.matches("sdf.edt_band", brute.OPS)
