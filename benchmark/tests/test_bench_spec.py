"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness, parts

SPEC = json.loads((harness.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    # A full check of 24 cells, with its allowances, fits in 12 hours.
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(SPEC["command"]) <= 32 and all(map(_line, SPEC["command"]))
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
    assert len((harness.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/")
        body = json.loads((harness.REPO / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])


def test_workloads():
    ws = SPEC["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])


def test_metrics():
    e2e, layer = SPEC["end_to_end"], SPEC["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    assert "setup_s" in names
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in e2e if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    e2e_cells = {m["name"]: set(m.get("workloads", cells)) for m in e2e}
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e_cells
        # Every cell a metric lists reports the metric it moves.
        assert set(m.get("workloads", cells)) <= e2e_cells[m["moves"]]
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(name):
    cell = harness.load_cell(name)
    assert cell.traffic["input"] and cell.traffic["entry"]
    assert int(cell.traffic["pool"]) >= 2
    assert cell.config["guarantees"]


@pytest.mark.parametrize(
    "name", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_metric_files_found_by_name(name):
    assert callable(harness.load_metric(name))


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_parts_found_by_name(name):
    """The maker, the entry and the configuration's text or pixels of every
    cell are files found by the names its files give."""
    cell = harness.load_cell(name)
    assert callable(parts.load("makers", cell.traffic["input"]).make)
    entry = harness.load_entry(cell.traffic["entry"])
    assert callable(entry.call) and callable(entry.outputs)
    source = [("texts", cell.config.get("text")),
              ("pixels", cell.config.get("pixels"))]
    assert [callable(parts.load(k, n).make) for k, n in source if n] == [True]


def test_an_unknown_part_is_named():
    with pytest.raises(KeyError, match="entries/no_such_entry.py"):
        parts.load("entries", "no_such_entry")
