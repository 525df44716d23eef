"""The program spans' exclusive host time and the five readers of it, on
synthetic chrome-trace events."""

import pytest

from benchmark.harness import manifest, spans, trace
from benchmark.harness.runner import LayerContext


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": float(ts), "dur": float(dur), "tid": tid}


def _window(events, start=100.0, dur=100.0):
    return trace.parse([_span(trace.WINDOW, start, dur)] + events)


def _hard_call(t0):
    """One call: entry 40 us, threshold 5 (no launch), rows 10 with a 4 us
    launch, band 12 with a 6 us launch; the entry's own time is 13 us."""
    return [_span("sdf.generate", t0, 40), _span("sdf.threshold", t0 + 2, 5),
            _span("sdf.edt_rows", t0 + 10, 10), _span("launch.chaq_edt_rows", t0 + 14, 4),
            _span("sdf.edt_band", t0 + 25, 12), _span("launch.chaq_edt_band_bytes", t0 + 28, 6)]


def _read(name, tr, units):
    reader = manifest.load_module(manifest.reader_path(name), "metric_" + name)
    return reader.read(LayerContext(tr, units, 1, {}, lambda msg: None))


def test_nesting_on_one_thread_splits_the_entry_by_layer():
    tr = _window(_hard_call(110) + _hard_call(155))
    assert spans.exclusive_s(tr, spans.HARD_ENTRY, spans.HARD_OPS + spans.LAUNCH) == pytest.approx(2 * 13e-6)
    assert spans.exclusive_s(tr, spans.HARD_OPS, spans.LAUNCH) == pytest.approx(2 * 17e-6)
    assert spans.exclusive_s(tr, spans.LAUNCH) == pytest.approx(2 * 10e-6)
    got = {m: _read(m, tr, 2) for m in ("hard.entry_self_us", "hard.ops_self_us", "hard.launch_host_us")}
    assert got == {"hard.entry_self_us": pytest.approx(13.0), "hard.ops_self_us": pytest.approx(17.0),
                   "hard.launch_host_us": pytest.approx(10.0)}
    assert sum(got.values()) == pytest.approx(40.0)  # the three layers make up the entry


def test_a_child_on_another_thread_is_not_taken_out():
    # the step on thread 1 waits while a launch of its backward runs on thread 2
    ev = [_span("soft.step", 110, 50), _span("soft.gate", 120, 8), _span("soft.backward", 135, 20),
          _span("launch.chaq_soft_b1", 140, 5, tid=2), _span("soft.gate", 170, 4, tid=2)]
    tr = _window(ev)
    assert spans.exclusive_s(tr, ("soft.step",), ("soft.gate",)) == pytest.approx(42e-6)
    assert spans.exclusive_s(tr, ("soft.step",), ("launch.*",)) == pytest.approx(50e-6)
    assert _read("soft.step_host_ms", tr, 1) == pytest.approx(42e-3)
    assert _read("soft.gate_host_ms", tr, 2) == pytest.approx(6e-3)  # both threads' gates, per step


def test_a_span_cut_by_the_window_counts_its_part_inside():
    ev = [_span("sdf.atlas", 80, 40), _span("launch.chaq_edt_rows", 90, 20),  # 100-120 inside
          _span("sdf.atlas", 180, 40), _span("launch.chaq_edt_rows", 195, 10)]  # 180-200 inside
    tr = _window(ev)
    assert spans.exclusive_s(tr, spans.HARD_ENTRY) == pytest.approx(40e-6)
    assert spans.exclusive_s(tr, spans.HARD_ENTRY, spans.LAUNCH) == pytest.approx((10 + 15) * 1e-6)
    assert spans.exclusive_s(tr, spans.LAUNCH) == pytest.approx((10 + 5) * 1e-6)
    # a span of the set inside another of it counts once
    nested = _window([_span("sdf.edt_band", 110, 20), _span("sdf.edt_rows", 115, 5)])
    assert spans.exclusive_s(nested, spans.HARD_OPS) == pytest.approx(20e-6)


@pytest.mark.parametrize("name", ["hard.entry_self_us", "hard.ops_self_us", "hard.launch_host_us",
                                  "soft.gate_host_ms", "soft.step_host_ms"])
def test_no_span_reads_none(name):
    # the parent's trace: torch's own ops, none of the program's spans
    ops = [{"ph": "X", "cat": "cpu_op", "name": "aten::gt", "ts": 120.0, "dur": 5.0, "tid": 1}]
    assert _read(name, _window(ops), 3) is None
    assert _read(name, _window(_hard_call(110) + [_span("soft.step", 110, 20)]), 0) is None
    # spans outside the window are not in it
    assert _read(name, _window(_hard_call(300) + [_span("soft.gate", 10, 5), _span("soft.step", 5, 20)]), 3) is None


def test_patterns():
    assert spans.matches("sdf.edt_band", spans.HARD_OPS) and spans.matches("launch.chaq_soft_f1", spans.LAUNCH)
    assert not spans.matches("sdf.edt", spans.HARD_OPS) and not spans.matches("sdf.atlas", spans.HARD_OPS)
