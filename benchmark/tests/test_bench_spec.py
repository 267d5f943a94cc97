"""BENCHMARK.json against the benchmark's contract, and every cell resolved
to its files by name."""

import json
import os
import re

import pytest

import harness

SPEC = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 << 10
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][:2] == ["python3", "benchmark/run.py"]
    assert all(_line(w) for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43 200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_units(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert _line(e[key]), (e["name"], key)


def test_metrics_bounds_and_coverage():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        reported = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reported, m["name"]
    for cell in cells:
        own = [m for m in SPEC["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(own) >= 2, cell
        assert any(cell in m["workloads"] for m in SPEC["per_layer"]), cell


def test_configs_and_cells():
    configs = {c["name"]: c for c in SPEC["configs"]}
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(configs)
    assert len({c["file"] for c in SPEC["configs"]}) == len(configs)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        body = harness.load_json(harness.ROOT, c["file"])
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_by_name(cell):
    spec = harness.cell_spec(cell)
    config, traffic, work = spec["config"], spec["traffic"], spec["work"]
    gen = harness.load_part("gen", config["generator"]["name"])
    assert callable(gen.generate)
    driver = harness.load_part("drivers", traffic["driver"])
    assert all(callable(getattr(driver, f)) for f in ("setup", "window", "teardown"))
    assert callable(harness.load_part("reference", traffic["reference"]).answer)
    for m in spec["per_layer"]:
        assert callable(harness.load_part("metrics", m["name"]).read)
    assert work["kernels"] and work["work_bytes"]
    assert "{input}" in traffic["argv"] and "{output}" in traffic["argv"]


def test_every_metric_has_a_reader():
    for m in SPEC["per_layer"]:
        assert os.path.exists(os.path.join(harness.BENCH, "metrics", m["name"] + ".py"))


def test_layers_are_named_in_perf_md():
    with open(os.path.join(harness.ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in SPEC["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]
