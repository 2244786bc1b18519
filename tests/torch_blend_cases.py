"""Hand-built compact inputs of the instance blend, shared by the CPU tests
(against the JAX package) and the card-only kernel tests. They import no
JAX, so the card-only tests run where JAX is not installed."""

import numpy as np

BLEND_CASES = ("empty", "long", "saturated", "boundary", "cutoff")

# the early exit's windows (t_cutoff > 1e-4): 128 columns counted from
# absolute multiples of 128 (blend::CUT_WINDOW in csrc/blend_common.cuh)
CUT_WINDOW = 128

# columns per work unit of the instance kernels' segmented walk (blend::SEG
# in fateavatar_tpu_torch/csrc/blend_common.cuh)
SEG = 256

# "boundary": tile -> the column of its range at which its pixels' running
# transmittance is meant to cross 1e-4: at segment boundaries 1, 2 and 3,
# and (the saturated tile) within the first few columns
CROSS_AT = {1: SEG, 4: 3, 6: 2 * SEG, 9: 3 * SEG}


def _boundary_tile(rng, x0, y0, c, cross):
    """``c`` splats of ~40 px sigma centred on the 16x16 tile at (x0, y0):
    alpha varies by a few percent over the tile's pixels, so their running
    transmittance crosses 1e-4 within a few columns of ``cross``."""
    mxy = np.stack([x0 + 8 + rng.uniform(-1, 1, c), y0 + 8 + rng.uniform(-1, 1, c)])
    sig = rng.uniform(36, 44, (2, c))
    conic = np.stack([1 / sig[0]**2, np.zeros(c), 1 / sig[1]**2])
    if cross < 8:
        op = rng.uniform(0.9, 1.0, c)
    else:
        # 95% are valid; exp(power) averages ~0.987 over the tile's pixels
        alpha = 1 - 1e-4 ** (1 / (0.95 * cross))
        op = alpha / 0.987 * rng.uniform(0.97, 1.03, c)
    return mxy, conic, op


def _wide_tile(rng, x0, y0, alphas):
    """Splats of ~40 px sigma centred on the tile at (x0, y0), one per entry
    of ``alphas``, with opacity alpha / 0.987 (exp(power) averages ~0.987
    over the tile's pixels): every pixel's q falls by about 1 - alpha per
    splat, within a few percent across the tile."""
    c = len(alphas)
    mxy = np.stack([x0 + 8 + rng.uniform(-1, 1, c), y0 + 8 + rng.uniform(-1, 1, c)])
    sig = rng.uniform(36, 44, (2, c))
    conic = np.stack([1 / sig[0]**2, np.zeros(c), 1 / sig[1]**2])
    return mxy, conic, np.minimum(np.asarray(alphas) / 0.987, 1.0)


# "cutoff": tile -> the per-splat alphas of its range (tile 1 starts at
# column 100, tile 2 at 700, tile 3 at 1300; compact layout)
CUTOFF_TILES = {
    # from mid-window: q crosses 1e-2 near column 300 and 1e-3 near 400, so
    # windows counted from the tile's start would cut elsewhere (356, 484)
    # than the absolute ones (384, 512)
    1: [0.0228] * 600,
    # q falls to ~0.05 by column 1022, then the splat at column 1023, the
    # last of an absolute window, takes it below 1e-2 (and the next window
    # below 1e-3)
    2: [0.0092] * 323 + [0.9] + [0.05] * 276,
    # q stays above 0.1: never cut
    3: [0.004] * 400,
}


def blend_case(name, seed=0):
    """Hand-built compact blend inputs on a (3, 4) tile grid: ([16, M],
    tile_starts, bg, grid). Ranges start and end mid-window.

    ``boundary`` holds the edges of the kernels' segmented walk: tiles whose
    pixels cross T = 1e-4 at and around segment boundaries 1-3 (CROSS_AT),
    a long saturated tile whose pixels all stop in its first segment, ranges
    of exactly one segment, one column and one column past two segments,
    and ranges that start mid-segment of the global column index."""
    grid = (3, 4)
    ty, tx = grid
    rng = np.random.default_rng(seed)
    counts = {
        # empty tiles between short unaligned ranges
        "empty": [0, 5, 0, 0, 130, 0, 77, 0, 0, 3, 0, 0],
        # one tile spans > 30 windows of 128
        "long": [40, 3900, 100, 0, 0, 60, 0, 257, 0, 0, 12, 0],
        # opaque splats drive T below 1e-4
        "saturated": [300, 200, 0, 90, 500, 0, 129, 0, 40, 0, 0, 700],
        # see CROSS_AT; tile 2 is one whole segment, 5 two and a column
        "boundary": [37, 700, SEG, 0, 1500, 2 * SEG + 1, 1200, 0, 1, 1100, SEG - 1, 0],
        # see CUTOFF_TILES; tile 5 saturates in its first window
        "cutoff": [100, 600, 600, 400, 0, 300, 50, 0, 0, 20, 0, 0],
    }[name]
    cols = []
    for tile, c in enumerate(counts):
        x0, y0 = (tile % tx) * 16, (tile // tx) * 16
        mxy = np.stack([x0 + rng.uniform(-6, 22, c), y0 + rng.uniform(-6, 22, c)])
        # conic = inverse of a random SPD covariance of 1-8 px sigma
        sx, sy = rng.uniform(1, 8, (2, c))
        rho = rng.uniform(-0.8, 0.8, c)
        cxy = rho * sx * sy
        det = sx**2 * sy**2 - cxy**2
        conic = np.stack([sy**2 / det, -cxy / det, sx**2 / det])
        rgb = rng.uniform(0, 1, (3, c))
        if name == "boundary" and tile in CROSS_AT:
            mxy, conic, op = _boundary_tile(rng, x0, y0, c, CROSS_AT[tile])
        elif name == "cutoff" and tile in CUTOFF_TILES:
            mxy, conic, op = _wide_tile(rng, x0, y0, CUTOFF_TILES[tile])
        elif name == "saturated" or (name == "cutoff" and tile == 5):
            op = rng.uniform(0.9, 1.0, c)
        elif c > 1000:
            # faint: pixels stay above T = 1e-4 through all ~30 windows
            op = rng.uniform(0.004, 0.01, c)
        else:
            op = rng.uniform(0.02, 0.9, c)
        valid = (rng.random(c) > 0.05).astype(np.float64)
        if name == "cutoff" and tile in CUTOFF_TILES:
            valid[:] = 1.0
        cols.append(np.concatenate([mxy, conic, rgb, op[None], valid[None],
                                    np.zeros((6, c))]))
    inst = np.concatenate(cols, axis=1).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    m_real = inst.shape[1]
    m_pad = ((m_real + 128) // 128 + 1) * 128     # the Pallas windows' bound
    inst = np.concatenate([inst, np.zeros((16, m_pad - m_real), np.float32)], 1)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    return inst, starts, bg, grid


def aligned_layout(inst, starts, chunk=CUT_WINDOW):
    """The same lists in the aligned layout: each tile's range moved to a
    multiple of ``chunk`` and padded with invalid, all-zero columns (the
    layout of binning's ``layout="aligned"``); the array padded as
    blend_case pads it."""
    counts = np.diff(starts)
    padded = (counts + chunk - 1) // chunk * chunk
    new_starts = np.concatenate([[0], np.cumsum(padded)]).astype(np.int32)
    m_real = int(new_starts[-1])
    m_pad = ((m_real + 128) // 128 + 1) * 128
    out = np.zeros((inst.shape[0], m_pad), np.float32)
    for t, c in enumerate(counts):
        out[:, new_starts[t]:new_starts[t] + c] = inst[:, starts[t]:starts[t] + c]
    return out, new_starts
