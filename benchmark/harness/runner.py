"""One run of one cell: set-up, the measured (or traced) window, the check
against the plain reference, and the result's line.

A driver (benchmark/drivers/<name>.py) exposes ``make(run)``, which returns
an object with:
  setup()           inputs made from the seed, the program's entry built and
                    every shape of the cell warmed up (counted in setup_s)
  begin_window()    counters and spans reset
  step()            one unit of work (a call, a training step)
  drain()           wait for the device
  units             units done since begin_window()
  pixels_per_unit   the work of a unit, for the readers' rooflines
  spans             {name: [seconds, ...]} recorded around the entry
  end_to_end(window_s) -> {metric: value}
  release()         free the program's state (answers kept for the check)
  check() -> [Check]               the numbers compared, each with its limit
  readings(kind) -> [Check]        the same with ``kind`` in the program's
                                   place (the control, or a planted fault)
"""

from __future__ import annotations

import copy
import dataclasses
import sys
import time

import torch

from benchmark.harness import device as card
from benchmark.harness import isolation, manifest, trace

TRACE_SECONDS = 2.0  # the traced sub-window
TRACE_WARM_SECONDS = 0.5  # steps under the profiler before it


@dataclasses.dataclass
class Check:
    """A number compared and its limit: it passes at or under the limit."""

    name: str
    value: float
    limit: float

    @property
    def passes(self) -> bool:
        return self.value <= self.limit


class IsolationError(RuntimeError):
    pass


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell's files, the seed, the device and
    the reference module."""

    cell: manifest.Cell
    seed: int
    device: torch.device
    reference: object
    out: object = sys.stderr

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def spec(self) -> dict:
        return self.cell.spec

    def limit(self, name: str) -> float:
        return float(self.cell.spec["limits"][name])

    def log(self, msg: str) -> None:
        print(msg, file=self.out, flush=True)


@dataclasses.dataclass
class LayerContext:
    """What a per-layer reader (benchmark/metrics/<name>.py, ``read(ctx)``)
    is given: the traced window and the units done in it."""

    trace: trace.Trace
    units: int
    pixels_per_unit: int
    spans: dict
    log: object


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def prepare(name: str, seed: int, device, overrides: dict = None, out=sys.stderr):
    """(Run, driver) of the cell ``name``; ``overrides`` ({"config": {...},
    "traffic": {...}, "spec": {...}}) changes its files' values (the tests'
    small sizes)."""
    cell = manifest.resolve(manifest.load(), name)
    for part, over in (overrides or {}).items():
        setattr(cell, part, _merge(getattr(cell, part), over))
    reference = manifest.load_module(cell.reference_path, "reference_" + cell.config["reference"])
    run = Run(cell, int(seed), torch.device(device), reference, out)
    driver = manifest.load_module(cell.driver_path, "driver_" + cell.spec["driver"]).make(run)
    return run, driver


def window(driver, seconds: float) -> float:
    driver.begin_window()
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        driver.step()
    driver.drain()
    return time.perf_counter() - t0


def _isolated(run: Run, when: str, preloaded=frozenset()) -> None:
    bad = isolation.forbidden(set(sys.modules) - set(preloaded))
    if bad:
        run.log(f"isolation: {', '.join(bad)} loaded {when}")
        raise IsolationError(f"modules {bad} loaded {when}")


def run_cell(name: str, seed: int, seconds: float, traced: bool, device="cuda", t_start: float = None,
             overrides: dict = None, out=sys.stderr, preloaded=frozenset()) -> dict:
    """One run: the result's line as a dict (``checks`` last). ``t_start``
    is the process's start on the host clock (setup_s runs from it);
    ``preloaded``: modules loaded before the run, left out of its isolation
    check (the tests' process)."""
    t_start = time.perf_counter() if t_start is None else t_start
    run, driver = prepare(name, seed, device, overrides, out)
    cell = run.cell
    on_card = run.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(run.device)
    run.log(f"before set-up: {time.perf_counter() - t_start:.3f} s (imports, the card's context)")
    driver.setup()
    _isolated(run, "after set-up", preloaded)
    setup_s = time.perf_counter() - t_start
    run.log(f"cell {name} seed {seed}: set-up {setup_s:.3f} s")

    metrics, device_extra, breakdown = {}, {}, None
    if traced:
        def body(annotate):
            window(driver, min(TRACE_WARM_SECONDS, seconds))
            with annotate():
                window(driver, min(TRACE_SECONDS, seconds))

        tr = trace.capture(body)
        ctx = LayerContext(tr, driver.units, driver.pixels_per_unit, driver.spans, run.log)
        run.log(f"traced window: {tr.window_s:.6f} s, {driver.units} units, device busy {tr.busy_s:.6f} s")
        for m in cell.per_layer:
            reader = manifest.load_module(manifest.reader_path(m["name"]), "metric_" + m["name"])
            value = reader.read(ctx)
            if value is None:
                run.log(f"metric {m['name']}: nothing to read")
            else:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        window_s = window(driver, seconds)
        values = driver.end_to_end(window_s)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
        run.log(f"window {window_s:.6f} s, {driver.units} units")
    attempted = driver.units
    peak = torch.cuda.max_memory_allocated(run.device) if on_card else 0

    driver.release()
    checks = driver.check()
    correct = all(c.passes for c in checks)
    if on_card:
        run.log(f"card: {torch.cuda.get_device_name(run.device)}, {torch.cuda.device_count()} visible, "
                f"{cell.chips} used; {card.power_limit()}")
    _isolated(run, "before the result", preloaded)
    for c in checks:
        run.log(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.passes else 'FAILED'}")
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": sum(not c.passes for c in checks),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else run.device.type,
            "kind": torch.cuda.get_device_name(run.device) if on_card else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
            **device_extra,
        },
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result
