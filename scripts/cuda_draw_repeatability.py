"""Count the distinct results of repeated CUDA draws on the same inputs.

Runs ``torch.cumsum`` of a seeded 65,536-entry probability vector (the
size of a full-width avatar's densify accumulator, a tenth of it 0) and
``torch.multinomial(probs, 1000, replacement=True)`` from a generator
seeded 0, ``--reps`` times each, first in this process and then in two
processes that share card 0 (as data-parallel ranks under gloo do), and
prints how many distinct results each gave. More than one means the op
is not reproducible bit for bit, so replicas that must stay equal cannot
each draw for themselves.

    python scripts/cuda_draw_repeatability.py --reps 300
"""

from __future__ import annotations

import argparse
import hashlib

import numpy as np
import torch
import torch.multiprocessing as mp


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:12]


def run(rank: int, reps: int, out):
    torch.cuda.set_device(0)
    rng = np.random.default_rng(3)
    p = rng.random(65536).astype(np.float32) ** 4 * 1e-3
    p[rng.random(65536) < 0.1] = 0
    probs = torch.from_numpy(p).cuda()
    sums, draws = set(), set()
    for _ in range(reps):
        sums.add(_digest(torch.cumsum(probs / probs.sum(), 0)))
        g = torch.Generator(device="cuda").manual_seed(0)
        draws.add(_digest(torch.multinomial(probs, 1000, replacement=True, generator=g)))
    out[rank] = (sorted(sums), sorted(draws))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    one = {}
    run(0, args.reps, one)
    print(f"one process, {args.reps} runs: {len(one[0][0])} distinct cumsums, "
          f"{len(one[0][1])} distinct multinomial draws")
    with mp.Manager() as m:
        out = m.dict()
        mp.spawn(run, args=(args.reps, out), nprocs=2)
        for r in range(2):
            print(f"process {r} of 2 on card 0: {len(out[r][0])} distinct cumsums, "
                  f"{len(out[r][1])} distinct multinomial draws")


if __name__ == "__main__":
    main()
