"""The rooflines' arithmetic and the reduction of a trace."""

import pytest

from benchmark.harness import roofline, trace


def test_hard_floor_is_bytes_bound_at_the_atlas_shape():
    npix = 4 * 4096 * 4096
    floor_s, bound = roofline.hard_floor(npix)
    assert bound == "bytes"
    assert floor_s == pytest.approx(3 * npix / 3.35e12)
    assert floor_s * 1e3 == pytest.approx(0.0601, abs=1e-4)
    assert roofline.band_bytes_flops(npix) == 55 * npix


def test_floor_takes_the_larger_bound():
    assert roofline.floor_seconds(3.35e12, 0.0) == (1.0, "bytes")
    assert roofline.floor_seconds(0.0, 67e12) == (1.0, "operations")
    assert roofline.floor_seconds(3.35e12, 2 * 67e12)[1] == "operations"


def test_soft_floor_counts_input_and_target_once():
    npix = 2 * 4096 * 4096
    assert roofline.soft_step_floor(npix) == (12 * npix / 3.35e12, "bytes")
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(1.0, 0.0) is None


def _events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 100.0, "dur": 100.0, "tid": 1}]
    ev += [{"ph": "X", "cat": "kernel", "name": "k_a", "ts": 110.0, "dur": 20.0},
           {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 125.0, "dur": 10.0},  # overlaps k_a
           {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 150.0, "dur": 5.0},
           {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 180.0, "dur": 10.0},
           {"ph": "X", "cat": "kernel", "name": "before", "ts": 10.0, "dur": 5.0}]
    ev += [{"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 140.0, "dur": 20.0, "tid": 1},
           {"ph": "X", "cat": "cpu_op", "name": "aten::_local_scalar_dense", "ts": 141.0, "dur": 18.0, "tid": 1},
           {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 162.0, "dur": 3.0, "tid": 1}]
    return ev


def test_trace_busy_idle_and_breakdown():
    tr = trace.parse(_events())
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx((25 + 5 + 10) * 1e-6)  # the union, outside events dropped
    assert tr.device_s == pytest.approx((20 + 10 + 5 + 10) * 1e-6)
    assert tr.idle_share() == pytest.approx(0.6)
    assert tr.top_device_ops()[0] == ["k_a", pytest.approx(30e-6)]
    assert tr.host_seconds(["aten::_local_scalar_dense", "aten::item"]) == pytest.approx(18e-6)
    gaps = dict((name, sec) for name, sec in tr.idle_gaps())
    # gaps: 100-110 (no op), 135-150 (mid 142.5: _local_scalar_dense), 155-180 (mid 167.5: none), 190-200
    assert gaps["aten::_local_scalar_dense"] == pytest.approx(15e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)
    assert len(tr.top_device_ops()) <= 10 and len(tr.idle_gaps()) <= 10


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        trace.parse([e for e in _events() if e["name"] != trace.WINDOW])
