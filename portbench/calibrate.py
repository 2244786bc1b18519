#!/usr/bin/env python3
"""Readings for a cell's limits: the program's numbers over many seeds and
the control's, in one process on the card (the benchmark's own runs do not
run this).

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 [--control] [--seconds 12]

The program's readings are the numbers one run compares, taken from the
timed path at the cell's own sizes: for a training cell its first three
steps through the scan epoch's graph (no window is needed), for a
reenactment cell a short window of clips at the cell's own load. The
control is the reference put in the program's place, one precision step
below the configuration's (bfloat16 for its float32 work, float8 e4m3
operands for its bfloat16 VGG convolutions), compared with the float32
reference on the same inputs. One JSON line per seed and kind.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_readings(ctx, control: bool) -> dict:
    import torch

    from portbench.drivers import train as T
    from portbench.reference import fateavatar as ref

    fam = T if ctx.cell["kind"] == "train" else importlib.import_module(
        f"portbench.drivers.{ctx.cell['kind']}")
    trainer, scan, keep = fam.build(ctx)
    out = {}
    if not control:
        prog = T.first_steps(trainer, scan)
        prog = {**prog, "mu1": T._host(prog["mu1"]), "p3": T._host(prog["p3"])}
    del trainer, scan
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    refr = fam.reference_steps(keep, ctx.device)
    refr = (refr[0], T._host(refr[1]), T._host(refr[2]))
    params0 = fam.initial(keep)
    if control:
        low = fam.reference_steps(keep, ctx.device, dtype=torch.bfloat16, f8=True)
        prog = {"mu1": {k: v.float().cpu() * (1 - ref.B1) for k, v in low[1].items()},
                "p3": {k: v.float().cpu() for k, v in low[2].items()}, "losses": low[0]}
    out = T.compare(prog, refr, params0)
    return out


def reenact_readings(ctx, control: bool) -> dict:
    import numpy as np
    import torch

    from portbench.drivers import reenact as R

    reenactor, cam, keep = R.build(ctx)
    traffic = keep["traffic"]
    pos_rng = np.random.default_rng(ctx.seed)
    kept, k = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        c = k % len(traffic["lengths"])
        frames = R._serve(reenactor, traffic, c, cam)
        j = int(pos_rng.integers(len(frames)))
        kept.append((c, j, frames[j], len(frames) - 1, frames[-1]))
        k += 1
    del reenactor
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    if not control:
        return {**R.compare(keep, kept, ctx.seed, ctx.device), "clips": len(kept)}
    av_lo = R._ref_avatar(keep, ctx.device, torch.bfloat16)
    lo = []
    for c, j, _, last, _ in kept:
        lo.append((c, j, R.reference_frame(av_lo, keep, c, j, ctx.device, torch.bfloat16)
                   .mul(255).round().clamp(0, 255).to(torch.uint8).cpu().numpy(),
                   last, R.reference_frame(av_lo, keep, c, last, ctx.device, torch.bfloat16)
                   .mul(255).round().clamp(0, 255).to(torch.uint8).cpu().numpy()))
    return {**R.compare(keep, lo, ctx.seed, ctx.device), "clips": len(kept)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import registry
    from portbench.run import make_ctx

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = registry.cell(args.workload)["kind"]
    fn = reenact_readings if kind == "reenact" else train_readings
    for seed in (int(s) for s in args.seeds.split(",")):
        tmp = tempfile.mkdtemp(prefix="portbench_cal_")
        try:
            ctx = make_ctx(args.workload, seed, args.seconds, False, torch.device("cuda"), tmp)
            t0 = time.perf_counter()
            r = fn(ctx, args.control)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "kind": "control" if args.control else "program",
                          "s": round(time.perf_counter() - t0, 1), **r}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
