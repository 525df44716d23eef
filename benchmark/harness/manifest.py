"""BENCHMARK.json: read it, hold it to the benchmark's rules, and find each
cell's files by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything else is found from those names, so that a later change adds a
configuration, a mix, a cell or a per-layer metric by adding files:

  benchmark/workloads/<cell>.json     the cell: its driver, sample, limits
  benchmark/configs/<config>.json     the configuration (``file`` in configs)
  benchmark/traffic/<traffic>.json    the mix, read by harness/traffic.py
  benchmark/drivers/<driver>.py       the loop around the program's entry
  benchmark/reference/<ref>.py        the plain reference the config names
  benchmark/metrics/<metric>.py       one reader per per-layer metric
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load(path: str = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _metric_cells(manifest: dict, metric: dict) -> list:
    """The cells a metric is reported in: its ``workloads``, else every cell
    (an end-to-end metric) or every cell that reports its ``moves``."""
    if "workloads" in metric:
        return list(metric["workloads"])
    if "moves" in metric:
        target = next(m for m in manifest["end_to_end"] if m["name"] == metric["moves"])
        return _metric_cells(manifest, target)
    return [w["name"] for w in manifest["workloads"]]


def problems(manifest: dict) -> list:
    """Every breach of the benchmark's rules found in ``manifest`` (empty
    when it keeps them), file lookups by name included."""
    out = []

    def need(cond, msg):
        if not cond:
            out.append(msg)

    need(set(manifest) == TOP_KEYS, f"top-level keys {sorted(manifest)}")
    cmd, paths = manifest.get("command", []), manifest.get("paths", [])
    need(isinstance(cmd, list) and 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd), "command")
    need(isinstance(paths, list) and 1 <= len(paths) <= 16, "paths: 1 to 16 directories")
    for p in paths:
        need(PATH.fullmatch(p) is not None and not p.startswith("/") and ".." not in p.split("/"),
             f"path {p!r}")
    rs = manifest.get("run_seconds")
    need(isinstance(rs, int) and 1 <= rs <= 51, f"run_seconds {rs!r}")

    names = set()
    for group, keys in (("configs", CONFIG_KEYS), ("workloads", CELL_KEYS), ("end_to_end", E2E_KEYS),
                        ("per_layer", LAYER_KEYS)):
        for entry in manifest.get(group, []):
            extra = set(entry) - keys - ({"workloads"} if group in ("end_to_end", "per_layer") else set())
            need(keys <= set(entry) and not extra, f"{group} entry {entry.get('name')!r} keys {sorted(entry)}")
            name = entry.get("name", "")
            need(NAME.fullmatch(name) is not None, f"name {name!r}")
            if group in ("end_to_end", "per_layer"):
                need(name not in names, f"metric {name!r} twice")
                names.add(name)
    for group in ("configs", "workloads"):
        seen = [e["name"] for e in manifest.get(group, [])]
        need(len(seen) == len(set(seen)), f"{group}: a name twice")

    configs = {c["name"]: c for c in manifest.get("configs", [])}
    cells = manifest.get("workloads", [])
    need(1 <= len(configs) <= 24 and 1 <= len(cells) <= 24, "1 to 24 configs and cells")
    for c in configs.values():
        need(_line(c["source"]) and _line(c["why"]), f"config {c['name']}: source, why")
        need(isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
             and all(NAME.fullmatch(k) for k in c["reduced"]), f"config {c['name']}: reduced")
        need(any(c["file"].startswith(p.rstrip("/") + "/") for p in paths), f"config {c['name']}: file not under paths")
        need(os.path.isfile(os.path.join(ROOT, c["file"])), f"config {c['name']}: {c['file']} missing")
        need(any(w["config"] == c["name"] for w in cells), f"config {c['name']} used by no cell")
    files = [c["file"] for c in configs.values()]
    need(len(files) == len(set(files)), "two configs share a file")
    pairs = [(w["config"], w["traffic"]) for w in cells]
    need(len(pairs) == len(set(pairs)), "a (config, traffic) pair twice")
    four = sum(1 for w in cells if w.get("chips") == 4)
    need(four <= max(1, len(cells) // 4), "too many four-chip cells")

    e2e = {m["name"]: m for m in manifest.get("end_to_end", [])}
    need("setup_s" in e2e, "no setup_s")
    need(1 <= len(e2e) <= 16, "1 to 16 end-to-end metrics")
    need(1 <= len(manifest.get("per_layer", [])) <= 128, "1 to 128 per-layer metrics")
    for m in list(e2e.values()) + manifest.get("per_layer", []):
        need(UNIT.fullmatch(m.get("unit", "")) is not None, f"{m['name']}: unit {m.get('unit')!r}")
        need(m.get("better") in ("lower", "higher"), f"{m['name']}: better")
        need(m.get("source") in SOURCES, f"{m['name']}: source")
        for cell in m.get("workloads", []):
            need(cell in {w["name"] for w in cells}, f"{m['name']}: unknown cell {cell}")
    for m in e2e.values():
        need(m["source"] in ("host_clock", "device_trace"), f"{m['name']}: end-to-end source")
        need(isinstance(m["bound"], (int, float)) and 0.01 <= m["bound"] <= 0.25, f"{m['name']}: bound")
    for m in manifest.get("per_layer", []):
        need(_line(m["layer"]), f"{m['name']}: layer")
        need(m["moves"] in e2e, f"{m['name']}: moves {m['moves']!r}")
        if m["moves"] in e2e:
            moved = set(_metric_cells(manifest, e2e[m["moves"]]))
            for cell in _metric_cells(manifest, m):
                need(cell in moved, f"{m['name']}: {cell} does not report {m['moves']}")
        need(os.path.isfile(reader_path(m["name"])), f"{m['name']}: no reader")

    for w in cells:
        name = w["name"]
        need(w["config"] in configs, f"{name}: unknown config")
        need(NAME.fullmatch(w.get("traffic", "")) is not None, f"{name}: traffic name")
        need(w.get("chips") in (1, 4), f"{name}: chips")
        need(_line(w.get("why")), f"{name}: why")
        reported = [m["name"] for m in e2e.values() if name in _metric_cells(manifest, m)]
        need("setup_s" in reported and len(reported) >= 2, f"{name}: setup_s and one more end-to-end metric")
        need(any(name in _metric_cells(manifest, m) for m in manifest.get("per_layer", [])),
             f"{name}: no per-layer metric")
        if w["config"] in configs and w["traffic"]:
            try:
                cell = resolve(manifest, name)
            except (OSError, KeyError, ValueError) as e:
                need(False, f"{name}: {e}")
                continue
            for path in (cell.driver_path, cell.reference_path):
                need(os.path.isfile(path), f"{name}: {os.path.relpath(path, ROOT)} missing")
    return out


@dataclasses.dataclass
class Cell:
    """A cell and everything found for it by name."""

    name: str
    chips: int
    entry: dict  # its entry in ``workloads``
    spec: dict  # benchmark/workloads/<cell>.json
    config: dict  # the configuration's file
    traffic: dict  # benchmark/traffic/<traffic>.json
    end_to_end: list  # the end-to-end metrics it reports
    per_layer: list  # the per-layer metrics it reports
    driver_path: str
    reference_path: str


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "workloads", f"{name}.json")


def traffic_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "traffic", f"{name}.json")


def driver_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "drivers", f"{name}.py")


def reference_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "reference", f"{name}.py")


def reader_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "metrics", f"{name}.py")


def resolve(manifest: dict, name: str) -> Cell:
    """The cell called ``name`` with its files read; KeyError for a name
    that is not a cell."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell named {name!r} in BENCHMARK.json")
    config_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    spec = _read(cell_path(name))
    config = _read(os.path.join(ROOT, config_entry["file"]))
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        entry=entry,
        spec=spec,
        config=config,
        traffic=_read(traffic_path(entry["traffic"])),
        end_to_end=[m for m in manifest["end_to_end"] if name in _metric_cells(manifest, m)],
        per_layer=[m for m in manifest["per_layer"] if name in _metric_cells(manifest, m)],
        driver_path=driver_path(spec["driver"]),
        reference_path=reference_path(config["reference"]),
    )


def load_module(path: str, label: str):
    """Import a file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location("benchmark_" + re.sub(r"\W", "_", label), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
