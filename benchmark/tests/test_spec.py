"""BENCHMARK.json against the benchmark's contract, and every file of a
cell found by name."""

import json
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["config"] for c in SPEC["workloads"]]
    names += [c["traffic"] for c in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads"):
        got = [c["name"] for c in SPEC[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in SPEC["workloads"] + SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for c in SPEC["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    ends = {m["name"] for m in SPEC["end_to_end"]}
    assert {"samples_per_s", "subint_ms_p95", "setup_s"} <= ends
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in ends
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.cell_of(SPEC, cell)
    cfg = harness.config_of(SPEC, c["config"])
    traffic = harness.traffic_of(c["traffic"])
    system = harness.module("systems", cfg["system"])
    reference = harness.module("reference", cfg["reference"])
    assert traffic["feed"] in system.FEEDS
    assert callable(system.make_feed) and callable(reference.expected)
    assert set(reference.LIMITS) and callable(reference.compare)
    layer = [m for m in SPEC["per_layer"] if cell in m["workloads"]]
    assert layer, "every cell reports a per-layer metric"
    for m in layer:
        assert callable(harness.module("metrics", m["name"]).read)


def test_config_files_state_their_cuts():
    for c in SPEC["configs"]:
        cfg = harness.config_of(SPEC, c["name"])
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert set(cfg["assumed"]) <= set(cfg)


def test_check_fits_the_budget():
    # a full check of 24 cells at this length: 2 + 14 x cells runs of
    # run_seconds + 60, 2 x 90 s of compile a cell, 1200 s spare
    total = (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200
    assert total <= 43200


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (harness.HERE / "metrics").glob("*.py")))
def test_reader_finds_nothing_in_an_empty_run(name):
    from types import SimpleNamespace
    run = SimpleNamespace(trace=None, spans={}, work=(0.0, 0.0))
    assert harness.module("metrics", name).read(run) is None
