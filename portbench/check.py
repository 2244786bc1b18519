"""The comparisons that decide ``correct``: gaps between the program's
numbers and the plain reference's, each held to a limit that the cell's
file states (``limits``), set from measured readings of sound runs and of a
control (PERF.md gives them)."""

from __future__ import annotations

import statistics

import torch

# a leaf whose reference gradient is below this share of the median leaf's
# gradient norm moves under Adam by round-off alone, and is not compared
NOUGHT_SHARE = 1e-3


def leaf_gaps(prog: dict, ref: dict, floor_from: dict) -> tuple:
    """The worst gap of norms over the leaves: max over leaves of
    | |prog| - |ref| | / max(|ref|, median leaf |ref|), the leaves whose
    ``floor_from`` norm is under ``NOUGHT_SHARE`` of the median left out.
    Returns (worst gap, its leaf)."""
    norms = {k: float(torch.linalg.norm(v.double())) for k, v in ref.items()}
    gnorms = {k: float(torch.linalg.norm(v.double())) for k, v in floor_from.items()}
    med_g = statistics.median(gnorms.values())
    keep = [k for k in ref if gnorms[k] >= NOUGHT_SHARE * med_g]
    med = statistics.median(norms[k] for k in keep)
    gaps = {k: abs(float(torch.linalg.norm(prog[k].double())) - norms[k]) / max(norms[k], med)
            for k in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def loss_gap(prog: list, ref: list) -> float:
    """max over steps of |prog - ref| / |ref|."""
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref))


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, a NaN or a missing number failing."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return ok, out
