"""The program's own spans in a traced window: exclusive host time.

The port marks its host work with torch.profiler ranges (its
``utils/profiling.span``: ``sdf.atlas``, ``sdf.threshold``,
``launch.<entry>``, ``soft.step``, ...), which a ``--trace 1`` run finds
among ``Trace.host_ops`` as user annotations, each with its thread. A
reader asks for the time inside some spans and outside others on the same
thread: a span's own time, its children's taken out. Spans are clipped to
the window; spans of one set that overlap on a thread (a span inside
another of the set) count once. A program without such spans reads None."""

from __future__ import annotations

import collections

from benchmark.harness.trace import Trace


# the port's span names the readers share
HARD_ENTRY = ("sdf.atlas", "sdf.generate")
HARD_OPS = ("sdf.threshold", "sdf.edt_*")
LAUNCH = ("launch.*",)


def matches(name: str, patterns) -> bool:
    """Whether ``name`` is one of ``patterns``; a pattern ending in ``*``
    matches every name that starts with the rest of it."""
    return any(name.startswith(p[:-1]) if p.endswith("*") else name == p for p in patterns)


def _by_thread(trace, patterns) -> dict:
    """{thread: disjoint sorted [start, end]} of the host ops named by
    ``patterns``, clipped to the window (merged as the device's busy time
    is, by ``Trace.busy_intervals``)."""
    found = collections.defaultdict(list)
    for name, s, d, tid in trace.host_ops:
        if matches(name, patterns):
            found[tid].append((name, s, d))
    merged = {tid: Trace(trace.start_us, trace.end_us, ops, []).busy_intervals() for tid, ops in found.items()}
    return {tid: m for tid, m in merged.items() if m}


def _overlap(a: list, b: list) -> float:
    """The measure of the intersection of two disjoint sorted lists."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total


def exclusive_s(trace, spans, children=()):
    """Seconds of the window inside the host ops named by ``spans`` and
    outside those named by ``children`` on the same thread (a child on
    another thread takes nothing out); None where no op named by ``spans``
    falls in the window."""
    outer = _by_thread(trace, spans)
    if not outer:
        return None
    inner = _by_thread(trace, children) if children else {}
    total = 0.0
    for tid, a in outer.items():
        total += sum(e - s for s, e in a) - _overlap(a, inner.get(tid, []))
    return total / 1e6


def per_unit(ctx, spans, children=(), scale: float = 1.0):
    """exclusive_s over the window's units, times ``scale``; None without
    units or spans."""
    if ctx.units == 0:
        return None
    sec = exclusive_s(ctx.trace, spans, children)
    return None if sec is None else scale * sec / ctx.units
