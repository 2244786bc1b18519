"""Hand-built dense-list inputs of the tile blend, shared by the CPU tests
(against the JAX package), the card-only kernel tests and chip_smoke.py.
Numpy only, so the card-only tests run where JAX is not installed."""

import numpy as np

from torch_blend_cases import blend_case

TILE_CASES = {
    # name: (K, per-tile counts on a (3, 4) grid)
    # empty tiles between short lists
    "empty": (256, [0, 5, 0, 0, 130, 0, 77, 0, 0, 3, 0, 0]),
    # counts above K: the lists hold the first K, the count runs on
    "over_k": (128, [300, 128, 0, 90, 500, 0, 129, 7, 40, 0, 0, 700]),
    # opaque splats drive T below 1e-4 and the tiles terminate
    "saturated": (512, [300, 200, 0, 90, 500, 0, 129, 0, 40, 0, 0, 700]),
    # one faint tile spans > 60 windows of 64
    "long": (4096, [40, 3900, 100, 0, 0, 60, 0, 257, 0, 0, 12, 0]),
    # torch_blend_cases' "boundary" lists laid out densely (dense_layout):
    # crossings of T = 1e-4 at and around the segmented walk's segment
    # boundaries; the K of "long" (above every list), so no new array shape
    "boundary": (4096, None),
}


def dense_layout(inst, starts, k, grid):
    """The compact ranges [starts[t], starts[t+1]) of a [16, M] instance
    array laid into each tile's first slots of K: (data [9, T*K], valid
    [T*K], counts [T] int32), the instances in the same order. The slots
    past each list hold an opaque splat over the whole tile, marked valid:
    a blend must never read them."""
    tx = grid[1]
    counts = np.diff(starts).astype(np.int32)
    tile = np.arange(len(counts))
    data = np.zeros((9, len(counts), k), np.float32)
    data[0] = ((tile % tx) * 16 + 8)[:, None]
    data[1] = ((tile // tx) * 16 + 8)[:, None]
    data[2] = data[4] = 1e-3
    data[5:9] = 1.0
    valid = np.ones((len(counts), k), np.float32)
    for t, (s, c) in enumerate(zip(starts[:-1], counts)):
        data[:, t, :c] = inst[:9, s:s + c]
        valid[t, :c] = inst[9, s:s + c]
    return data.reshape(9, -1), valid.reshape(-1), counts


def tile_case(name, seed=0):
    """(data [9, T*K], valid [T*K], counts [T] int32, bg [3], grid) on a
    (3, 4) tile grid. Tile t owns the columns [t*K, (t+1)*K); its first
    min(counts[t], K) are its list, 5% of them empty (valid 0, as the scan
    binning leaves a slot it reserved for a dropped candidate). The slots
    past the list hold opaque garbage marked valid: a blend must stop at
    min(counts[t], K) and never read them."""
    grid = (3, 4)
    ty, tx = grid
    k, counts = TILE_CASES[name]
    if counts is None:
        inst, starts, bg, grid = blend_case(name, seed)
        return (*dense_layout(inst, starts, k, grid), bg, grid)
    rng = np.random.default_rng(seed)
    cols, valids = [], []
    for tile, c in enumerate(counts):
        x0, y0 = (tile % tx) * 16, (tile // tx) * 16
        mxy = np.stack([x0 + rng.uniform(-6, 22, k), y0 + rng.uniform(-6, 22, k)])
        # conic = inverse of a random SPD covariance of 1-8 px sigma
        sx, sy = rng.uniform(1, 8, (2, k))
        rho = rng.uniform(-0.8, 0.8, k)
        cxy = rho * sx * sy
        det = sx**2 * sy**2 - cxy**2
        conic = np.stack([sy**2 / det, -cxy / det, sx**2 / det])
        rgb = rng.uniform(0, 1, (3, k))
        if name == "saturated":
            op = rng.uniform(0.9, 1.0, k)
        elif c > 1000:
            # faint: pixels stay above T = 1e-4 through all ~60 windows
            op = rng.uniform(0.004, 0.01, k)
        else:
            op = rng.uniform(0.02, 0.9, k)
        n = min(c, k)
        op[n:] = 1.0
        valid = np.ones(k)
        valid[:n] = rng.random(n) > 0.05
        cols.append(np.concatenate([mxy, conic, rgb, op[None]]))
        valids.append(valid)
    data = np.concatenate(cols, axis=1).astype(np.float32)
    valid = np.concatenate(valids).astype(np.float32)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    return data, valid, np.asarray(counts, np.int32), bg, grid


def jax_layout(data, valid, counts, grid):
    """The JAX package's dense-list arrays of the same lists: mean2d_t
    [T, K, 2], conic_t [T, K, 3], color_t [T, K, 3], opacity_t [T, K] and
    valid_t [T, K] (the validity with the slots past min(counts, K) marked
    empty, as the JAX binning leaves them)."""
    t = grid[0] * grid[1]
    k = data.shape[1] // t
    d = data.T.reshape(t, k, 9)
    in_list = np.arange(k)[None, :] < np.minimum(counts, k)[:, None]
    return (d[..., 0:2], d[..., 2:5], d[..., 5:8], d[..., 8],
            valid.reshape(t, k) * in_list)
