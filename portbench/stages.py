#!/usr/bin/env python3
"""Where a cell's time goes, read from the program's own tracing
(``fateavatar_tpu_torch/utils/profiling.py``): the stage marks inside its
CUDA graphs, its spans and its counters. Not a benchmark run: it reports no
result line and decides nothing.

    python3 portbench/stages.py --workload <cell> --seed <n> [--reps 300]

from the root of a checkout, on a machine with an NVIDIA card. It builds the
cell as its driver does (tracing off, so the driver's graph holds no mark),
then in one process:

* the cost of tracing: the same work timed in turns with tracing off and on
  (off, on, on, off), host clock closed by a synchronize; a training cell
  replays its step's graph captured without and with marks ``--reps``
  times a turn, the reenact cell serves ``--calls`` of its clips a turn;
* a traced window under ``torch.profiler`` with tracing on: each stage's
  device ms a pass from the marks (``profiling.stage_ms``) against the
  device's busy time (the union of the profiler's kernel intervals), the
  ``stage_mark`` kernels' own device time, the top kernels of each stage
  (each kernel put under the mark before it), the idle gaps split by the
  innermost ``fa.`` span over them (:func:`idle_by_span`), and the
  program's counters over the window;
* a graph captured with tracing off replayed under the profiler: the
  ``stage_mark`` kernels it launched (none) and the marks it wrote (none);
* in the reenact cell, each call's drain ms (the program's
  ``reenact.drain_s`` history, tracing off) with the call's frames dropped
  at once and kept as the driver keeps them (two frames a call, each
  holding its ring copy), in turns drop, keep, keep, drop, and every
  call's drain ms in the order the process made them.

Prints one JSON object on standard output. To be deleted once the
benchmark's drivers read ``profiling.stage_ms()`` and ``timing.py`` has
``idle_by_span`` (PERF.md, Open questions).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARK = "stage_mark"
OUTSIDE = "(outside spans)"
AFTER_END = "(after end)"


class Unannotated:
    """A ``torch.profiler`` trace without the device-side copies of the
    program's ``fa.`` ranges (the profiler's GPU user annotations, which
    span the kernels of their range): what ``portbench/timing.py`` reads as
    device work."""

    def __init__(self, prof):
        self.prof = prof

    def events(self):
        from torch.autograd import DeviceType

        return [e for e in self.prof.events()
                if not (e.device_type == DeviceType.CUDA and e.name.startswith("fa."))]


def device_ops(prof) -> list:
    """Sorted (start us, end us, name) of the kernels, copies and fills of a
    trace, the ``fa.`` ranges' device copies left out."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in Unannotated(prof).events() if e.device_type == DeviceType.CUDA)


def idle_by_span(prof) -> dict:
    """Idle seconds between the device work of a ``torch.profiler`` trace,
    each stretch of a gap put under the innermost (shortest) ``fa.`` span
    that covers it, else under ``(outside spans)``: {name: seconds}."""
    from torch.autograd import DeviceType

    from portbench import timing

    gaps, end = [], None
    for a, b in timing.device_intervals(Unannotated(prof)):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == DeviceType.CPU and e.name.startswith("fa.")]
    out: dict = {}
    for a, b in gaps:
        cuts = sorted({a, b, *(t for s0, s1, _ in spans for t in (s0, s1) if a < t < b)})
        for x0, x1 in zip(cuts, cuts[1:]):
            over = [(s1 - s0, name) for s0, s1, name in spans if s0 <= x0 and s1 >= x1]
            name = min(over)[1] if over else OUTSIDE
            out[name] = out.get(name, 0.0) + (x1 - x0) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def by_stage(prof, seq, top: int = 6) -> dict:
    """Each device op of the trace put under the stage of the mark before
    it, the k-th ``stage_mark`` kernel being the k-th mark of ``seq`` (the
    ring's marks of the same window, in device order; what follows an
    ``end`` goes under ``(after end)``): {stage: {"ms": device ms, "top":
    [[kernel, ms], ...]}}."""
    stages = iter(s for _, s in seq)
    cur, out = None, {}
    for a, b, name in device_ops(prof):
        if name == MARK:
            cur = next(stages, None)
            cur = AFTER_END if cur == "end" else cur
            continue
        if cur is None:
            continue
        st = out.setdefault(cur, {})
        st[name] = st.get(name, 0.0) + (b - a) * 1e-3
    return {s: {"ms": sum(k.values()),
                "top": [[n[:90], v] for n, v in sorted(k.items(), key=lambda kv: -kv[1])[:top]]}
            for s, k in out.items()}


def traced(fn, device) -> dict:
    """``fn()`` under the profiler with tracing on, the marks reset before:
    its window, device busy time, marks, stage ms, mark kernels, stages'
    kernels, idle by span and counter deltas."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fateavatar_tpu_torch.utils import profiling
    from portbench import timing

    torch.cuda.synchronize(device)
    profiling.reset()
    c0 = profiling.counters()
    with profiling.tracing(), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = fn()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    seq = profiling.marks()
    ks = timing.kernel_seconds(Unannotated(prof))
    gaps = idle_by_span(prof)
    idle = sum(gaps.values())
    stages = by_stage(prof, seq)
    sms = profiling.stage_ms()
    return {"units": n, "window_s": window,
            "busy_s": timing.device_union_us(Unannotated(prof)) * 1e-6,
            "marks": len(seq), "stage_ms": sms,
            # the partition: marks' ms against the device ms of the ops
            # between a pass's first mark and its end, a unit (step, frame)
            "stage_sum_ms_a_unit": sum(ms * k for ms, k in sms.values()) / n,
            "ops_in_stages_ms_a_unit": sum(v["ms"] for s, v in stages.items()
                                           if s != AFTER_END) / n,
            "mark_kernels": sum(1 for e in prof.events() if e.name == MARK),
            "mark_device_ms": ks.get(MARK, 0.0) * 1e3,
            "by_stage": stages, "idle_s": idle,
            "idle_named_share": 1.0 - gaps.get(OUTSIDE, 0.0) / idle if idle else None,
            "idle_by_span": gaps, "counters": profiling.counters(c0)}


def unmarked(fn, device) -> dict:
    """``fn()`` (work captured with tracing off) under the profiler with
    tracing off: the mark kernels it launched and the marks it wrote."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fateavatar_tpu_torch.utils import profiling

    torch.cuda.synchronize(device)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    return {"mark_kernels": sum(1 for e in prof.events() if e.name == MARK),
            "marks": len(profiling.marks())}


def turns(work: dict, order=("off", "on", "on", "off")) -> dict:
    """Seconds of each ``work[side]()`` (which synchronizes), run in the
    turns ``order``: {side: [s, ...]}."""
    out: dict = {}
    for side in order:
        t0 = time.perf_counter()
        work[side]()
        out.setdefault(side, []).append(time.perf_counter() - t0)
    return out


def train(ctx, reps: int) -> dict:
    import torch

    from fateavatar_tpu_torch.utils import cuda_build, profiling
    from fateavatar_tpu_torch.utils.graphs import Graph
    from portbench import registry
    from portbench.drivers import train as T

    dev = ctx.device
    fam = registry.driver(ctx.cell["kind"])
    cuda_build.build_all([*T.KERNEL_LIBS, "stage_mark"])
    trainer, scan, keep = fam.build(ctx)
    n = len(trainer.train_dataset)
    off = scan.graph
    with profiling.tracing():
        on = Graph(scan.body, off.buffers, "the scan epoch's step, marked")
        scan.cursor.zero_()
        on()

    def replays(graph, k):
        def run():
            done = 0
            while done < k:
                scan.cursor.zero_()
                for _ in range(min(k - done, n)):
                    graph()
                done += min(k - done, n)
            torch.cuda.synchronize(dev)
            return k
        return run

    out = {"turns_s": turns({"off": replays(off, reps), "on": replays(on, reps)}),
           "reps": reps}
    out["traced"] = traced(replays(on, 20), dev)
    out["unmarked"] = unmarked(replays(off, 20), dev)
    out["passes_a_step"] = max(1, off.launches_per_replay.get("blend_instances_fwd", 1))
    return out


def reenact(ctx, calls: int) -> dict:
    import numpy as np

    from fateavatar_tpu_torch.utils import cuda_build, profiling
    from portbench.drivers import reenact as R

    dev = ctx.device
    cuda_build.build_all(["blend_instances", "stage_mark"])
    reenactor, cam, keep = R.build(ctx)
    traffic = keep["traffic"]
    R._serve(reenactor, traffic, 0, cam)
    k = [1]
    kept = []

    def serve(n, keep=False):
        def run():
            frames = 0
            for _ in range(n):
                got = R._serve(reenactor, traffic, k[0] % len(traffic["lengths"]), cam)
                if keep:
                    kept.append((got[len(got) // 2], got[-1]))
                frames += len(got)
                k[0] += 1
            return frames
        return run

    def on(n):
        def run():
            with profiling.tracing():
                return serve(n)()
        return run

    c0 = profiling.counters()
    captures, restore = R._time_captures(dev)
    try:
        t = turns({"off": serve(calls), "on": on(calls)})
    finally:
        restore()
    c = profiling.counters(c0)
    out = {"turns_s": t, "calls_a_turn": calls, "frames_a_call": traffic["lengths"][0],
           "capture_ms_harness": float(np.mean([m for _, m in captures])) if captures else None,
           "capture_ms_program": 1e3 * c.get("graph.capture_s", 0.0) / c["reenact.calls"],
           "drain_ms_program": 1e3 * c["reenact.drain_s"] / c["reenact.calls"],
           "drains_a_call": c["reenact.drains"] / c["reenact.calls"],
           "overflow": c["reenact.overflow"]}
    out["traced"] = traced(serve(1), dev)
    out["last_overflow"] = reenactor.last_overflow
    out["unmarked"] = unmarked(serve(1), dev)
    drain_ms: dict = {}
    for side in ("drop", "keep", "keep", "drop"):
        serve(calls, keep=side == "keep")()
        drain_ms.setdefault(side, []).extend(
            1e3 * s for s in profiling.history("reenact.drain_s")[-calls:])
    out["drain_ms_a_call"] = drain_ms
    # every call of the process in order: set-up's, the turns', the traced
    # and unmarked calls', then the drop / keep turns'
    out["drain_ms_by_call"] = [1e3 * s for s in profiling.history("reenact.drain_s")]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--reps", type=int, default=300, help="replays a turn (training)")
    ap.add_argument("--calls", type=int, default=4, help="calls a turn (reenact)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench.run import make_ctx, power_limit

    if not torch.cuda.is_available():
        print("portbench/stages.py: needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="portbench_stages_")
    try:
        ctx = make_ctx(args.workload, args.seed, 0.0, True, torch.device("cuda"), tmp)
        if ctx.cell["kind"] == "reenact":
            out = reenact(ctx, args.calls)
        else:
            out = train(ctx, args.reps)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(workload=args.workload, seed=args.seed, device=power_limit())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
