"""BENCHMARK.json against the files the harness finds by name, and the
shape of the file the benchmark's contract asks for."""

import json
import os
import re

import pytest

from portbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = registry.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
    assert os.path.getsize(os.path.join(registry.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    doc = registry.config(entry["name"])
    assert doc["name"] == entry["name"] and doc["source"] == entry["source"]
    assert doc["reduced"] == entry["reduced"] and "yaml" in doc and "assumed" in doc
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_found_by_name(entry):
    cell = registry.cell(entry["name"])
    assert hasattr(registry.driver(cell["kind"]), "run")
    assert registry.config(entry["config"])["name"] == entry["config"]
    assert "kind" in registry.traffic(entry["traffic"])
    assert entry["chips"] in (1, 4) and len(entry["why"]) <= 200
    assert cell["limits"], "every cell compares at least one number"
    e2e = registry.cell_metrics(BENCH, entry["name"], trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per = registry.cell_metrics(BENCH, entry["name"], trace=True)
    assert per and all(m["moves"] in names for m in per)


def test_config_and_traffic_pairs_once():
    pairs = [(e["config"], e["traffic"]) for e in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(e["chips"] == 4 for e in BENCH["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_entry(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_found_by_name(m):
    reader = registry.metric(m["name"])
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        m["layer"], m["unit"], m["source"], m["moves"])
    assert reader.read({}) is None, "a reader with nothing to read returns nothing"
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for cell in m.get("workloads", []):
        assert m["moves"] in {e["name"] for e in registry.cell_metrics(BENCH, cell, False)}


def test_layers_spelled_alike():
    by_module = {}
    for m in BENCH["per_layer"]:
        by_module.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_module.values())


def test_cell_files_parse():
    for d in ("configs", "traffic", "workloads"):
        for f in os.listdir(os.path.join(registry.HERE, d)):
            with open(os.path.join(registry.HERE, d, f)) as fh:
                json.load(fh)


HELD = [f[:-5] for f in sorted(os.listdir(os.path.join(registry.HERE, "workloads")))
        if "held_out" in registry.cell(f[:-5])]


@pytest.mark.parametrize("name", HELD)
def test_held_out_cell_found_by_name(name):
    """A cell left out of BENCHMARK.json keeps its parts, its reason and
    the entries that bring it back; ``benchmark(held_out=True)`` lists it
    with the metrics it reports, and the plain file does not."""
    held = registry.cell(name)["held_out"]
    assert held["reason"] and name not in {e["name"] for e in BENCH["workloads"]}
    full = registry.benchmark(held_out=True)
    entry = registry.entry(full, "workloads", name)
    assert registry.config(entry["config"]) and registry.traffic(entry["traffic"])
    assert entry["chips"] in (1, 4) and len(entry["why"]) <= 200
    reported = {m["name"] for m in registry.cell_metrics(full, name, False)
                + registry.cell_metrics(full, name, True)}
    assert set(held["metrics"]) <= reported and "setup_s" in reported
    for m in held.get("per_layer", []):
        assert registry.metric(m["name"]).MOVES == m["moves"]
