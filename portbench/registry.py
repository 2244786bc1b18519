"""Finding a cell's parts by name.

``BENCHMARK.json`` at the repository root names the cells, configurations
and metrics; each part is a file of its own under ``portbench/``:
``workloads/<cell>.json`` (the driver's ``kind``, the configuration, the
traffic mix and the cell's own parameters), ``configs/<config>.json``,
``traffic/<mix>.json``, ``metrics/<metric>.py`` and ``drivers/<kind>.py``.
A new part is a new file and a new entry in ``BENCHMARK.json``.

A cell that ``BENCHMARK.json`` leaves out while the program fails it keeps
its file, with a ``held_out`` section: the reason, the cell's entry and
the metrics it reports. ``benchmark(held_out=True)`` adds those cells back,
so that ``run.py`` and the tests still run them; bringing a cell back is
adding its entries to ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark(held_out: bool = False) -> dict:
    """``BENCHMARK.json``; with ``held_out``, the held-out cells added to
    its cells and to the metrics each reports (a metric that only they
    report comes whole from the cell's file)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if not held_out:
        return bench
    listed = {e["name"] for e in bench["workloads"]}
    for fname in sorted(os.listdir(os.path.join(HERE, "workloads"))):
        name = fname[:-len(".json")]
        h = cell(name).get("held_out")
        if h is None or name in listed:
            continue
        bench["workloads"].append({"name": name, **h["entry"]})
        known = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
        bench["per_layer"] += [dict(m, workloads=[]) for m in h.get("per_layer", [])
                               if m["name"] not in known]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in h["metrics"] and "workloads" in m:
                m["workloads"].append(name)
    return bench


def entry(bench: dict, section: str, name: str) -> dict:
    for e in bench[section]:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {section} entry named {name!r}")


def cell(name: str) -> dict:
    return _json("workloads", f"{name}.json")


def config(name: str) -> dict:
    return _json("configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def metric(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py`` (the
    name may hold dots, so it is loaded from its path), with its LAYER,
    UNIT, SOURCE, MOVES and ``read(readings)``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, name: str, trace: bool) -> list:
    """The metric entries a run of cell ``name`` reports: its end-to-end
    metrics (those without ``workloads`` and those that list it), or with
    ``trace`` its per-layer metrics (those that list it, and those without
    ``workloads`` whose ``moves`` the cell reports)."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in mine)]
