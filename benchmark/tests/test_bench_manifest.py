"""BENCHMARK.json keeps the benchmark's rules, and every file of every cell
is found by its name."""

import json
import os

import pytest

from benchmark.harness import manifest


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_manifest_keeps_the_rules(bench):
    assert manifest.problems(bench) == []


def test_names_and_units_keep_their_characters():
    for good in ("setup_s", "hard.kernel_roofline_pct", "exact_s64.atlas_glyph", "_x-1.2"):
        assert manifest.NAME.fullmatch(good)
    for bad in ("a b", "a,b", "a/b", "-lead", "μs", "x" * 65, ""):
        assert not manifest.NAME.fullmatch(bad)
    for good in ("Gpix/s", "%", "ms", "us", "tokens/s"):
        assert manifest.UNIT.fullmatch(good)
    for bad in ("tokens per second", "μs", "", "x" * 17):
        assert not manifest.UNIT.fullmatch(bad)


def test_each_moves_target_is_reported_where_its_metric_is(bench):
    for m in bench["per_layer"]:
        cells = manifest._metric_cells(bench, m)
        target = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(cells) <= set(manifest._metric_cells(bench, target)), m["name"]


def test_a_broken_manifest_is_caught(bench):
    broken = json.loads(json.dumps(bench))
    broken["per_layer"][0]["moves"] = "soft_step_ms"  # a hard metric moving a soft-only metric
    broken["end_to_end"][1]["bound"] = 0.5
    broken["workloads"][0]["chips"] = 2
    found = manifest.problems(broken)
    assert any("does not report soft_step_ms" in p for p in found)
    assert any("bound" in p for p in found)
    assert any("chips" in p for p in found)


@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(bench, cell):
    c = manifest.resolve(bench, cell)
    assert c.spec["name"] == cell
    assert c.traffic["name"] == c.entry["traffic"]
    assert c.config["name"] == c.entry["config"]
    for path in (c.driver_path, c.reference_path):
        assert os.path.isfile(path)
    for m in c.per_layer:
        assert os.path.isfile(manifest.reader_path(m["name"]))
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert set(c.spec["limits"]), "a cell states the limit of each number it compares"


def test_config_files_state_source_deployment_and_cuts(bench):
    for entry in bench["configs"]:
        with open(os.path.join(manifest.ROOT, entry["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
        assert cfg["reduced"] == entry["reduced"]
        for key in ("deployment", "guarantees", "precision", "assumed", "size", "reference"):
            assert key in cfg, (entry["name"], key)
