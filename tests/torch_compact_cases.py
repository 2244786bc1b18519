"""Inputs of the binning's candidate compaction
(``binning.compact_candidates``), made with numpy, shared by the card-only
test and chip_smoke.py. They import no JAX.

``small``: 3,000 splats on an 8 x 8 grid at R 64. ``mono``:
MonoGaussianAvatar's shapes as the benchmark runs them, N 100,000 on the
32 x 32 grid of a 512x512 frame at R 1,024 (the whole grid) and the budget
6,291,456. Most footprints cover 1-16 tiles, 2% up to the whole grid (1,024
tiles), a tenth of the splats none. Each case names two sizes: the budget
(past every candidate: a tail of sentinels) and one that cuts in the middle
of a splat's candidates."""

import numpy as np

COMPACT_CASES = {
    # name: (N, (ty, tx), R, budget)
    "small": (3000, (8, 8), 64, 24000),
    "mono": (100_000, (32, 32), 1024, 6_291_456),
}


def compact_case(name, seed=0):
    """(rmin_x, rmin_y, rect_w, touched, offsets, order, grid, R, sizes):
    int32 [N] arrays and int64 order over the depth ranks, the grid, the
    cap R and the two sizes (the budget, a cut inside a splat)."""
    n, grid, R, budget = COMPACT_CASES[name]
    ty, tx = grid
    rng = np.random.default_rng(seed)
    big = rng.random(n) < 0.02
    w = np.where(big, rng.integers(1, tx + 1, n), rng.integers(1, 5, n))
    h = np.where(big, rng.integers(1, ty + 1, n), rng.integers(1, 5, n))
    rmin_x = rng.integers(0, tx - w + 1)
    rmin_y = rng.integers(0, ty - h + 1)
    touched = np.where(rng.random(n) < 0.1, 0, np.minimum(w * h, R))
    offsets = np.cumsum(touched) - touched
    assert offsets[-1] + touched[-1] < budget
    # the cut: inside the candidates of the widest splat past the first half
    i = n // 2 + int(np.argmax(touched[n // 2:]))
    cut = int(offsets[i] + touched[i] // 2)
    assert touched[i] > 2 and offsets[i] < cut < offsets[i] + touched[i]
    order = rng.permutation(n).astype(np.int64)
    i32 = [x.astype(np.int32) for x in (rmin_x, rmin_y, w, touched, offsets)]
    return (*i32, order, grid, R, (budget, cut))
