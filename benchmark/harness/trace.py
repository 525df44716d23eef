"""The ``--trace 1`` run's reading of the card: torch.profiler with CPU and
CUDA activities over a steady sub-window, exported as a chrome trace into a
temporary file (under TMPDIR, deleted once read), and reduced to what the
per-layer readers and the result's ``device`` and ``breakdown`` need."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

WINDOW = "bench.window"  # the annotation around the traced sub-window
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SCAN = 200  # host ops looked back over to find the one holding a gap


@dataclasses.dataclass
class Trace:
    """Events of the traced window, times in microseconds of the trace's
    clock: device operations (name, start, duration) and host operations
    (name, start, duration, thread)."""

    start_us: float
    end_us: float
    device_ops: list
    host_ops: list

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end)."""
        spans = sorted((max(s, self.start_us), min(s + d, self.end_us)) for _, s, d in self.device_ops)
        merged = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device."""
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    @property
    def device_s(self) -> float:
        """The summed time of every device operation in the window."""
        return sum(d for _, _, d in self.device_ops) / 1e6

    def idle_share(self):
        return 1.0 - self.busy_s / self.window_s if self.window_s > 0 else None

    def host_seconds(self, names) -> float:
        """Summed duration of the host operations called any of ``names``
        (the first name found in the trace; later names are its fallbacks,
        so that an op and the op it calls are not both counted)."""
        for name in names:
            found = [d for n, _, d, _ in self.host_ops if n == name]
            if found:
                return sum(found) / 1e6
        return 0.0

    def top_device_ops(self, n: int = 10) -> list:
        """[[name, seconds], ...]: the device operations that took most time."""
        total = collections.Counter()
        for name, _, d in self.device_ops:
            total[name] += d / 1e6
        return [[name, sec] for name, sec in total.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """[[label, seconds], ...]: the device's idle time in the window,
        summed by the host operation in progress at each gap's middle (the
        innermost one, over every thread: the latest to start), the longest
        first."""
        busy = self.busy_intervals()
        edges = [self.start_us] + [v for s, e in busy for v in (s, e)] + [self.end_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        ops = sorted((s, s + d, name) for name, s, d, _ in self.host_ops if name != WINDOW)
        starts = [s for s, _, _ in ops]
        total = collections.Counter()
        for s, e in gaps:
            mid = (s + e) / 2
            label = "host (no operation traced)"
            # the innermost op holding mid: the latest-starting one that has not ended
            last = bisect.bisect_right(starts, mid) - 1
            for i in range(last, max(-1, last - SCAN), -1):
                if ops[i][1] >= mid:
                    label = ops[i][2]
                    break
            total[label] += (e - s) / 1e6
        return [[label, sec] for label, sec in total.most_common(n)]


def parse(events: list) -> Trace:
    """A Trace from a chrome trace's ``traceEvents``: the window is the
    annotation WINDOW; events outside it are dropped."""
    window = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError(f"no {WINDOW!r} annotation in the trace")
    start = float(window[0]["ts"])
    end = start + float(window[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s + d < start or s > end:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append((e["name"], s, d))
        elif e.get("cat") in HOST_CATS:
            host.append((e["name"], s, d, e.get("tid")))
    return Trace(start, end, dev, host)


def capture(body) -> Trace:
    """Run ``body(annotate)`` under torch.profiler (CPU and CUDA); the body
    wraps its steady sub-window in ``annotate()``. Returns that window's
    Trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        body(lambda: record_function(WINDOW))
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return parse(events)
