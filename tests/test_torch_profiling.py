"""The port's timing and tracing (utils/profiling.py: its spans too) and
the CLI's --soft-prec, on the CPU."""

import glob
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from chaq_sdfgen_tpu.ops import merge as jmerge
from chaq_sdfgen_tpu.ops import pallas_soft_mm as jpm
import chaq_sdfgen_tpu_torch.cli as tcli
from chaq_sdfgen_tpu_torch import SDFGenerator, SdfConfig, SoftConfig, SoftSDFModel, create_train_state, make_train_step
from chaq_sdfgen_tpu_torch.models.atlas import atlas_sdf
from chaq_sdfgen_tpu_torch.utils import profiling


def test_kernel_timer_emits_the_reference_line():
    lines = []
    with profiling.kernel_timer("Atlas", emit=lines.append):
        torch.ones(64).sum()
    assert len(lines) == 1 and lines[0].startswith("Atlas timing: ") and lines[0].endswith(" sec")
    assert float(lines[0].split()[2]) >= 0.0


def test_kernel_timer_prints_by_default(capsys):
    with profiling.kernel_timer():
        pass
    out = capsys.readouterr().out
    assert out.startswith("Kernel timing: ") and out.strip().endswith("sec")


def test_time_compiled_is_a_positive_best_of_n():
    calls = []

    def fn(x):
        calls.append(1)
        return torch.cumsum(x, 0)

    best = profiling.time_compiled(fn, torch.ones(1 << 16), iters=4, warmup=2)
    assert 0.0 < best < 10.0 and len(calls) == 6
    assert profiling.time_compiled(lambda: None, iters=1, warmup=0) > 0.0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """One JSON file in the directory, which parses and names an aten:: op."""
    path = str(tmp_path / "trace")
    with profiling.device_trace(path):
        torch.matmul(torch.ones(32, 32), torch.ones(32, 32))
    files = glob.glob(os.path.join(path, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


HARD_OPS = ("sdf.threshold", "sdf.edt_rows", "sdf.edt_band")
SOFT_PARTS = ("soft.front_end", "soft.gate", "soft.backward")
# each call, the outer span and what it holds; the soft steps' field path is
# the gate's decision: in gamut (0-255) the declared pair with a runtime
# shift, out of it (+-2040) the adaptive kernels
SPAN_CASES = {
    "atlas": ("sdf.atlas", HARD_OPS, ()),
    "generate": ("sdf.generate", HARD_OPS, ()),
    "soft_u8": ("soft.step", SOFT_PARTS + ("soft.field.mm_rt",), ("soft.field.fused",)),
    "soft_pm2040": ("soft.step", SOFT_PARTS + ("soft.field.fused",), ("soft.field.mm_rt",)),
}


@pytest.fixture(scope="module")
def span_calls():
    """The calls of SPAN_CASES at a small size on the CPU (spread 14: band
    16, the gate's full tap radius)."""
    img = np.random.default_rng(7).integers(0, 256, (2, 24, 32, 2), dtype=np.uint8)
    cfg = SdfConfig(spread=6)
    gen = SDFGenerator(cfg, device="cpu")
    model = SoftSDFModel(14, SoftConfig(tau=2.0, temperature=1.0), device="cpu")
    step = make_train_step(model, create_train_state(model))
    x = torch.from_numpy(img).to(torch.float32)
    target = torch.zeros(2, 24, 32)
    return {
        "atlas": lambda: atlas_sdf(img, cfg, device="cpu"),
        "generate": lambda: gen.generate(img[0]),
        "soft_u8": lambda: step(x, target),
        "soft_pm2040": lambda: step((x - 127.5) * 16.0, target),
    }


@pytest.mark.parametrize("case", list(SPAN_CASES))
def test_spans_nest_under_the_profiler(span_calls, case):
    """Under torch.profiler the call records its spans, each inside the
    outer span on the same thread, and only the field path the gate took."""
    outer, inner, absent = SPAN_CASES[case]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        span_calls[case]()
    events = [e for e in prof.events() if e.name.startswith(("sdf.", "soft.", "launch."))]
    names = [e.name for e in events]
    assert names.count(outer) == 1, names
    top = next(e for e in events if e.name == outer)
    for name in inner:
        held = [e for e in events if e.name == name]
        assert held, f"{name} not in {names}"
        for e in held:
            assert e.thread == top.thread
            assert top.time_range.start <= e.time_range.start <= e.time_range.end <= top.time_range.end
    assert not set(absent) & set(names)


@pytest.mark.parametrize("case", list(SPAN_CASES))
def test_spans_cost_one_check_without_a_profiler(span_calls, case, monkeypatch):
    """With no profiler running a span is the shared null context: the
    same calls never enter record_function (patched here to raise)."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    assert not profiling.recording()
    assert profiling.span("sdf.atlas") is profiling.span("soft.gate") is profiling._NULL
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    span_calls[case]()


@pytest.fixture(scope="module")
def square_png(tmp_path_factory):
    """tests/test_cli_io.py:231-233: a 64x64 square."""
    img = np.zeros((64, 64), np.uint8)
    img[20:44, 20:44] = 255
    path = tmp_path_factory.mktemp("prec") / "in.png"
    Image.fromarray(img).save(path)
    return str(path)


def test_cli_soft_prec_high_is_within_two_levels(tmp_path, square_png):
    """--soft-prec high within 2 byte levels of the port's default and of
    the JAX CLI's default as it runs on its accelerator (test_cli_io.py's
    contract, 223-245): the JAX pair of declared kernels, pallas_soft_mm in
    interpret mode. The JAX CLI on the CPU takes its composed path, which
    differs from those kernels at the default T 0.5 (ROADMAP Queue 3 item
    2). The port's CLI touches no environment variable."""
    env = dict(os.environ)
    px = {}
    for name, extra in (("default", []), ("high", ["--soft-prec", "high"]), ("highest", ["--soft-prec", "highest"])):
        out = tmp_path / f"{name}.png"
        assert tcli.main(["-i", square_png, "-o", str(out), "-s", "12", "-l", "--soft",
                          "--platform", "cpu", *extra]) == 0
        px[name] = np.asarray(Image.open(out)).astype(int)
    assert dict(os.environ) == env
    gray = np.asarray(Image.open(square_png)).astype(np.float32)
    field = jpm.soft_field_mm_fused(jnp.asarray(gray), 14, 1.0, 0.5, 1e-6, interpret=True)
    v = jmerge.soft_remap(field, 12, False, clamp="hard")
    want = np.asarray(jnp.clip(v, 0.0, 255.0).astype(jnp.uint8)).astype(int)
    assert (px["highest"] == px["default"]).all()
    assert np.abs(px["high"] - px["default"]).max() <= 2
    assert np.abs(px["high"] - want).max() <= 2
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["--soft-prec", "low"])
