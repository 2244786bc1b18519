#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. With
``--trace 0`` the result's metrics are the cell's end-to-end metrics of
``BENCHMARK.json``; with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of part of the run and from the harness's own spans
and counters. Every run checks the outputs of the timed path against the
plain reference under ``portbench/reference`` and prints each number
compared beside its limit, last on standard error and last in the result
line. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, then ``checks``.

Exits non-zero with no result line when no CUDA card is available (or
fewer than the cell asks for), when a run fails, and when, after the
window, the process has loaded JAX, flax or the JAX package.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "fateavatar_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port's runs may not load,
    compared whole (``fateavatar_tpu_torch`` is not ``fateavatar_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def make_ctx(name: str, seed: int, seconds: float, trace: bool, device, tmp: str,
             overrides: dict | None = None, t_start: float | None = None) -> SimpleNamespace:
    """What a driver reads of cell ``name``: its file, configuration and mix
    (``overrides``, ``{"config": {...}, "traffic": {...}}``, merged into the
    configuration's ``yaml`` and the mix: the CPU tests' tiny sizes), the
    seed, the window's seconds, the device and the run's temporary
    directory."""
    from portbench import registry

    entry = registry.entry(registry.benchmark(held_out=True), "workloads", name)
    over = overrides or {}
    config = registry.config(entry["config"])
    config = {**config, "yaml": _merge(config["yaml"], over.get("config", {}))}
    return SimpleNamespace(name=name, cell=registry.cell(name), config=config,
                           mix=_merge(registry.traffic(entry["traffic"]),
                                      over.get("traffic", {})),
                           seed=int(seed), seconds=float(seconds), trace=bool(trace),
                           device=device, tmp=tmp,
                           t_start=time.perf_counter() if t_start is None else t_start)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             overrides: dict | None = None, t_start: float | None = None) -> dict:
    """One run of cell ``name``: the result line as a dict. ``device``
    defaults to the first card; ``overrides`` as :func:`make_ctx` takes
    them."""
    import torch

    from portbench import check, registry

    bench = registry.benchmark(held_out=True)
    entry = registry.entry(bench, "workloads", name)
    cell = registry.cell(name)
    dev = torch.device(device or "cuda")
    # the reference's float32 is float32: no TF32 in its matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix=f"portbench_{name}_")
    try:
        ctx = make_ctx(name, seed, seconds, trace, dev, tmp, overrides, t_start)
        out = registry.driver(cell["kind"]).run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    correct, checks = check.verdict(out["numbers"], cell["limits"])
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for m in registry.cell_metrics(bench, name, trace):
        if not trace:
            v = out["e2e"].get(m["name"])
        else:
            reader = registry.metric(m["name"])
            for key in ("LAYER", "UNIT", "SOURCE", "MOVES"):
                want = {"LAYER": m["layer"], "UNIT": m["unit"], "SOURCE": m["source"],
                        "MOVES": m["moves"]}[key]
                if getattr(reader, key) != want:
                    raise ValueError(f"metrics/{m['name']}.py: {key} {getattr(reader, key)!r}, "
                                     f"BENCHMARK.json says {want!r}")
            v = reader.read(out["readings"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    cuda = dev.type == "cuda"
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": int(entry["chips"]), "memory_peak_bytes": int(out["memory_peak"])}
    if trace:
        r = out["readings"]
        device_info["busy_s"] = r.get("busy_s")
        device_info["window_s"] = r.get("trace_window_s")
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device_info}
    if trace and "breakdown" in out["readings"]:
        result["breakdown"] = out["readings"]["breakdown"]
    r = out["readings"]
    if "latencies_ms" in r:
        print("portbench: call latencies ms " + " ".join(f"{x:.1f}" for x in r["latencies_ms"]),
              file=sys.stderr)
    for k, v in sorted(r.get("kernels", {}).items(), key=lambda kv: -kv[1])[:40]:
        print(f"portbench: kernel {v * 1e3:.3f} ms {k[:160]}", file=sys.stderr)
    result["readings"] = {k: v for k, v in r.items()
                          if k not in ("kernels", "breakdown", "blend_fwd_work",
                                       "blend_bwd_work", "latencies_ms")}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import registry

    entry = registry.entry(registry.benchmark(held_out=True), "workloads", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"portbench: cell {args.workload} needs {entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start)
    result["device"]["power"] = power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; the port's runs may not",
              file=sys.stderr)
        return 4
    r = result["readings"]
    print(f"portbench: {args.workload} seed {args.seed}: "
          + ", ".join(f"{k} {v}" for k, v in r.items()), file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
