"""BENCHMARK.json against the benchmark's own files: every name and unit
in its characters, every configuration, workload and metric found by
name, every per-layer metric reported where the metric it moves is."""
from __future__ import annotations

import json
import re

from perfbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_names_units_and_files():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + metrics]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for m in metrics:
        assert hasattr(harness.load_part("metrics", m["name"]), "read")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_cell_reports_its_metrics():
    for w in BENCH["workloads"]:
        cell = harness.find_cell(w["name"], BENCH)
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in BENCH["per_layer"]:
            if w["name"] in m.get("workloads", []):
                assert m["moves"] in cell.end_to_end
        wl = cell.workload
        assert wl["loop"] in harness.LOOPS
        harness.load_part("traffic", wl["prompts"]["generator"])
        if wl["loop"] == "open":
            harness.load_part("traffic", wl["arrivals"]["generator"])
