"""The segmented walk of the four blend kernels, emulated on the CPU.

``csrc/blend_instances*.cu`` (the compact layout: tile t's range is
[tile_starts[t], tile_starts[t+1]) of a flat array) and
``csrc/blend_tiles*.cu`` (the dense layout: the first min(counts[t], K) of
tile t's K slots) cut every tile's range into segments of SEG columns,
counted from the tile's own start, each a work unit: pass A takes each
segment's product P of (1 - alpha) (and, backward, U = sum alpha_j T_j
(g . c_j)) from T = 1, each segment's entry q_in (and pu_in) folds the
earlier segments' results in order, and pass B walks the segment exactly
from there with the q >= 1e-4 test. This file holds a torch emulation of
that schedule, with the kernels' rounding order (test code only, never
called by the package), and holds it against the plain versions of both
layouts and, for the compact one, the Pallas kernels in interpret mode: the
only place off the card where a wrong q_in, pu_in or T_final shows. The
same lists in either layout give the same bits."""

import functools

import jax
import numpy as np
import pytest
import torch

from torch_blend_cases import BLEND_CASES, CROSS_AT, SEG, blend_case
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_tile_cases import TILE_CASES, dense_layout
from fateavatar_tpu.render.blend_instances import blend_instances_pallas

from fateavatar_tpu_torch.render import blend_instances as tblend
from fateavatar_tpu_torch.render import blend_tiles as ttiles

L = SEG
P = tblend.P
EPS = tblend.T_EPS
# images and T_final: the emulation and the plain version take the
# transmittance product in another order (sequential per segment and across
# segments vs cumprod per window); on these cases no crossing flips, and the
# sums differ by float32 rounding (measured <= 1e-6)
FWD_ATOL = 5e-5
# gradients, relative to each row's largest element, as the plain backward
# against the Pallas VJP (tests/test_torch_render.py): the 256 pixel terms
# and the prefix pu are summed in another order
BWD_RTOL = 5e-5
# slots per tile when a blend case is laid out densely: the "boundary" tile
# case's K, above every case's longest range (3,900)
DENSE_K = TILE_CASES["boundary"][0]
LAYOUTS = ("compact", "dense")


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


class Units:
    """The plan over tile t's columns [s[t], e[t]) of ``rows`` ([>= 9, M]):
    unit u is segment k[u] of tile tile[u], columns [a[u], a[u] + n[u]);
    units of a tile are consecutive, in segment order. A column blends only
    where ``valid`` [M] > 0. Every column of every unit is evaluated at
    every pixel once, up front (:meth:`splat` reads it)."""

    def __init__(self, rows, valid, s, e, grid):
        m = rows.shape[1]
        nseg = (e - s + L - 1) // L
        self.tile = torch.repeat_interleave(torch.arange(len(nseg)), nseg)
        first = torch.cumsum(nseg, 0) - nseg
        self.k = torch.arange(len(self.tile)) - first[self.tile]
        self.last = self.k == nseg[self.tile] - 1
        self.a = s[self.tile] + self.k * L
        self.n = torch.minimum(e[self.tile] - self.a, torch.tensor(L))
        cols = self.a[:, None] + torch.arange(L)                  # [U, L]
        in_seg = torch.arange(L)[None, :] < self.n[:, None]
        col = cols.clamp(max=m - 1)
        ok = in_seg & (valid[col] > 0)
        self.cols, self.in_seg = cols, in_seg
        self.data = rows[:9, col]                                  # [9, U, L]
        self.data[8] = torch.where(ok, self.data[8], 0.0)          # staged opacity 0
        ty, tx = grid
        lin = torch.arange(P)
        self.px = ((self.tile % tx) * 16)[:, None] + lin % 16      # [U, P]
        self.py = ((self.tile // tx) * 16)[:, None] + lin // 16
        self.px, self.py = self.px.float(), self.py.float()
        # every column at every pixel as splat_at computes it: [U, L, P]
        d = self.data[..., None]                                   # [9, U, L, 1]
        dx, dy = d[0] - self.px[:, None], d[1] - self.py[:, None]
        power = -0.5 * (d[2] * dx * dx + d[4] * dy * dy) - d[3] * dx * dy
        expp = torch.exp(torch.clamp_max(power, 0.0))   # skipped where power > 0
        raw = d[8] * expp
        alpha = torch.clamp_max(raw, tblend.ALPHA_MAX)
        blends = (power <= 0.0) & (alpha >= tblend.ALPHA_MIN)
        self._splats = (blends, alpha, raw, expp, dx, dy)

    def splat(self, j):
        """Column j of every unit at every pixel: (blends [U, P], alpha,
        raw, exp(power), dx, dy)."""
        return tuple(x[:, j] for x in self._splats)


def _gdot(g, c0, c1, c2):
    return (g[0] * c0 + g[1] * c1) + g[2] * c2


def pass_a(units, g=None):
    """Per unit and pixel: P from 1 over the segment's blending instances,
    and with cotangents g ([3, U, P]) U = sum alpha_j T_j (g . c_j)."""
    q = torch.ones(units.px.shape)
    usum = torch.zeros(units.px.shape)
    for j in range(L):
        blends, alpha, *_ = units.splat(j)
        if g is not None:
            d = units.data[:, :, j, None]
            usum = torch.where(blends, usum + (alpha * q) * _gdot(g, d[5], d[6], d[7]), usum)
        q = torch.where(blends, q * (1.0 - alpha), q)
    return q, usum


def entry(units, prod, usum):
    """segment_entry: q_in and pu_in of every unit, folding its tile's
    earlier units in segment order, stopping where q fell below 1e-4."""
    q_in = torch.ones_like(prod)
    pu_in = torch.zeros_like(prod)
    q = pu = None
    for u in range(len(units.tile)):
        if units.k[u] == 0:
            q, pu = torch.ones(P), torch.zeros(P)
        q_in[u], pu_in[u] = q, pu
        live = q >= EPS
        pu = torch.where(live, pu + q * usum[u], pu)
        q = torch.where(live, q * prod[u], q)
    return q_in, pu_in


def walk(units, q_in, step):
    """Pass B: every unit's pixels walk its columns from q_in with the
    forward's skip and termination tests; ``step(j, keep, alpha, T, sp)``
    sees each column's kept pixels with their T before the instance.
    Returns T after the walk and the pairs evaluated."""
    T = q_in.clone()
    done = ~(q_in >= EPS)
    evaluated = 0
    for j in range(L):
        sp = units.splat(j)
        blends, alpha = sp[0], sp[1]
        evaluated += int((~done & units.in_seg[:, j, None]).sum())
        blends = blends & ~done
        test_t = T * (1.0 - alpha)
        cross = blends & (test_t < EPS)
        keep = blends & ~cross
        step(j, keep, alpha, T, sp)
        done = done | cross
        T = torch.where(keep, test_t, T)
    return T, evaluated


def emulate_forward(rows, valid, s, e, bg, grid):
    """The forward kernels' schedule over tile t's columns [s[t], e[t]):
    (img [T,3,P], t_final [T,P], pairs evaluated by pass A, pairs evaluated
    by pass B)."""
    units = Units(rows, valid, s, e, grid)
    prod, _ = pass_a(units)
    q_in, _ = entry(units, prod, torch.zeros_like(prod))
    acc = torch.zeros((3,) + prod.shape)

    def step(j, keep, alpha, T, sp):
        w = alpha * T
        for c in range(3):
            acc[c] = torch.where(keep, acc[c] + w * units.data[5 + c, :, j, None], acc[c])

    T, evaluated_b = walk(units, q_in, step)
    # the pixel's last segment entered at or above 1e-4 holds T_final
    last = (q_in >= EPS) & (units.last[:, None] | ~(q_in * prod >= EPS))
    n_tiles = grid[0] * grid[1]
    tfin = torch.ones((n_tiles, P))
    for u in range(len(units.tile)):
        tfin[units.tile[u]] = torch.where(last[u], T[u], tfin[units.tile[u]])
    img = torch.zeros((n_tiles, 3, P))
    for u in range(len(units.tile)):          # the combine, in segment order
        img[units.tile[u]] += acc[:, u]
    img = img + tfin[:, None, :] * bg[None, :, None]
    return img, tfin, int(units.in_seg.sum()) * P, evaluated_b


def emulate_backward(rows, valid, s, e, img, tfin, g_img, g_tfin, grid, n_out):
    """The backward kernels' schedule: the gradient of rows 0-8 as
    [n_out, M] (the other rows and the columns outside the ranges 0)."""
    units = Units(rows, valid, s, e, grid)
    g = g_img[units.tile].permute(1, 0, 2)                       # [3, U, P]
    prod, usum = pass_a(units, g)
    q_in, pu_in = entry(units, prod, usum)
    gdotimg = _gdot(g, *img[units.tile].permute(1, 0, 2))
    gt_tn = (g_tfin * tfin)[units.tile]
    pu = pu_in.clone()
    g_out = torch.zeros((n_out, rows.shape[1]))

    def step(j, keep, alpha, T, sp):
        _, _, raw, expp, dx, dy = sp
        d = units.data[:, :, j, None]
        w = alpha * T
        gdotc = _gdot(g, d[5], d[6], d[7])
        pu.copy_(torch.where(keep, pu + w * gdotc, pu))
        inv_om = 1.0 / (1.0 - alpha)
        dalpha = (T * gdotc - (gdotimg - pu) * inv_om) - gt_tn * inv_om
        g_power = dalpha * raw
        v = torch.stack([
            g_power * (-d[2] * dx - d[3] * dy), g_power * (-d[4] * dy - d[3] * dx),
            g_power * (-0.5 * dx * dx), g_power * (-dx * dy), g_power * (-0.5 * dy * dy),
            w * g[0], w * g[1], w * g[2], dalpha * expp])
        col = units.cols[:, j]
        inside = units.in_seg[:, j]
        g_out[:9, col[inside]] = torch.where(keep, v, 0.0).sum(-1)[:, inside]

    walk(units, q_in, step)
    return g_out


def _inputs(name):
    inst, starts, bg, grid = blend_case(name)
    return inst, starts, bg, grid, (t(inst), t(starts, torch.int32), t(bg))


@functools.lru_cache(maxsize=None)
def _layout(name, layout):
    """Blend case ``name`` in ``layout``: (rows, valid, s, e), tile t's
    columns [s[t], e[t]) of rows; "compact" as the instance kernels read it
    (ranges clamped into [0, M), as blend_common.cuh's CompactRanges),
    "dense" as the tile kernels do (dense_layout, K = DENSE_K)."""
    if layout == "compact":
        inst, starts, _, _ = blend_case(name)
        m = inst.shape[1]
        s = t(starts[:-1], torch.int64).clamp(0, m)
        e = torch.maximum(t(starts[1:], torch.int64).clamp(0, m), s)
        return t(inst), t(inst[9]), s, e
    data, valid, counts, _, _ = _dense_case(name)
    s = torch.arange(len(counts)) * DENSE_K
    return data, valid, s, s + counts.long()


def _dense_case(name):
    """The tile blend's arguments (data, valid, counts, bg, grid) of blend
    case ``name`` laid out densely."""
    inst, starts, bg, grid = blend_case(name)
    data, valid, counts = dense_layout(inst, starts, DENSE_K, grid)
    return t(data), t(valid), t(counts, torch.int32), t(bg), grid


def _cotangents(grid):
    rng = np.random.default_rng(5)
    n_tiles = grid[0] * grid[1]
    return (rng.normal(size=(n_tiles, 3, P)).astype(np.float32),
            rng.normal(size=(n_tiles, P)).astype(np.float32))


@functools.partial(jax.jit, static_argnames="grid")
def _pallas_fwd_and_vjp(inst, starts, bg, g_img, g_tfin, grid):
    out, vjp = jax.vjp(lambda x: blend_instances_pallas(x, starts, bg, grid, True), inst)
    return out, vjp((g_img, g_tfin))[0]


@functools.lru_cache(maxsize=None)
def _pallas(name):
    """The Pallas kernels (interpret) on case ``name``: img, t_final and
    the VJP's g_inst against _cotangents. Every case is padded to the widest
    one and passes tile_starts as an argument, so the kernels are traced and
    compiled once for all cases."""
    inst, starts, bg, grid = blend_case(name)
    width = max(blend_case(n)[0].shape[1] for n in BLEND_CASES)
    wide = np.pad(inst, ((0, 0), (0, width - inst.shape[1])))
    (img, tfin), g_inst = _pallas_fwd_and_vjp(wide, starts, bg, *_cotangents(grid), grid=grid)
    return np.asarray(img), np.asarray(tfin), np.asarray(g_inst)[:, :inst.shape[1]]


@functools.lru_cache(maxsize=None)
def _plain_forward(name):
    """blend_instances_reference's walk on case ``name``, with the pairs it
    evaluates per pixel: (img, t_final, evaluated [T, P])."""
    _, _, _, grid, (ti, ts, tb) = _inputs(name)
    img, tfin, evaluated, _ = tblend.blend_windows(ti, ti[9], *tblend._ranges(ts), tb,
                                                   grid, tblend.CHUNK)
    return img, tfin, evaluated


@functools.lru_cache(maxsize=None)
def _emulated_forward(name, layout):
    bg, grid = blend_case(name)[2:]
    return emulate_forward(*_layout(name, layout), t(bg), grid)


@functools.lru_cache(maxsize=None)
def _emulated_backward(name, layout):
    """The emulated backward in ``layout`` on the compact plain forward's
    outputs and _cotangents: the same inputs in both layouts."""
    grid = blend_case(name)[3]
    img, tfin, _ = _plain_forward(name)
    g_img, g_tfin = (t(x) for x in _cotangents(grid))
    n_out = tblend.ROW if layout == "compact" else ttiles.NG
    return emulate_backward(*_layout(name, layout), img, tfin, g_img, g_tfin, grid, n_out)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", BLEND_CASES)
def test_segmented_forward_matches_plain_and_pallas(name, layout):
    """Emulated kernel schedule vs the plain version of its layout
    (blend_instances_reference or blend_tiles_reference), and in the compact
    layout the Pallas forward (interpret), FWD_ATOL; pass B evaluates the
    pairs the sequential walk evaluates, pass A every pair of every range."""
    inst, starts, bg, grid, (ti, ts, tb) = _inputs(name)
    img, tfin, pairs_a, pairs_b = _emulated_forward(name, layout)
    if layout == "compact":
        img_p, tfin_p, evaluated = _plain_forward(name)
        img_j, tfin_j, _ = _pallas(name)
        np.testing.assert_allclose(img.numpy(), img_j, atol=FWD_ATOL)
        np.testing.assert_allclose(tfin.numpy(), tfin_j, atol=FWD_ATOL)
        assert pairs_b == int(evaluated.sum())
    else:
        img_p, tfin_p = ttiles.blend_tiles_reference(*_dense_case(name))
    torch.testing.assert_close(img, img_p, atol=FWD_ATOL, rtol=0)
    torch.testing.assert_close(tfin, tfin_p, atol=FWD_ATOL, rtol=0)
    assert pairs_a == int(np.diff(starts).sum()) * P
    empty = np.diff(starts) == 0
    np.testing.assert_array_equal(tfin.numpy()[empty], 1.0)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", BLEND_CASES)
def test_segmented_backward_matches_plain_and_pallas(name, layout):
    """Emulated backward schedule vs the plain backward of its layout
    (blend_instances_backward_reference or blend_tiles_backward_reference)
    on the same forward outputs, and in the compact layout vs jax.vjp of the
    Pallas kernel (interpret), BWD_RTOL of each row's largest element; the
    other rows and the columns outside the ranges are 0."""
    _, starts, _, grid, (ti, ts, tb) = _inputs(name)
    g_img, g_tfin = (t(x) for x in _cotangents(grid))
    img, tfin, _ = _plain_forward(name)
    got = _emulated_backward(name, layout).numpy()
    if layout == "compact":
        refs = (tblend.blend_instances_backward_reference(ti, ts, tb, img, tfin, g_img,
                                                          g_tfin, grid).numpy(),
                _pallas(name)[2])
    else:
        data, valid, counts, bg, _ = _dense_case(name)
        refs = (ttiles.blend_tiles_backward_reference(data, valid, counts, bg, img, tfin,
                                                      g_img, g_tfin, grid).numpy(),)
    for row in range(9):
        for r in refs:
            np.testing.assert_allclose(got[row], r[row],
                                       atol=BWD_RTOL * np.abs(r[row]).max() + 1e-7,
                                       err_msg=f"row {row}")
    np.testing.assert_array_equal(got[9:], 0.0)
    _, _, s, e = _layout(name, layout)
    outside = np.ones(got.shape[1], bool)
    for a, b in zip(s.tolist(), e.tolist()):
        outside[a:b] = False
    np.testing.assert_array_equal(got[:, outside], 0.0)


def test_dense_layout_gives_the_compact_bits():
    """The ``boundary`` case laid out densely runs the same segments as its
    compact layout, so the emulated schedule gives the same bits: image,
    T_final, pass A and pass B pairs, and each list's gradient columns."""
    name = "boundary"
    for a, b in zip(_emulated_forward(name, "compact"), _emulated_forward(name, "dense")):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    g_c = _emulated_backward(name, "compact")
    g_d = _emulated_backward(name, "dense")
    _, _, s_c, e_c = _layout(name, "compact")
    _, _, s_d, _ = _layout(name, "dense")
    for sc, ec, sd in zip(s_c.tolist(), e_c.tolist(), s_d.tolist()):
        assert torch.equal(g_d[:, sd:sd + ec - sc], g_c[:9, sc:ec])


def test_boundary_case_crosses_at_segment_boundaries():
    """The ``boundary`` case does what it is for: in each CROSS_AT tile the
    pixels stop on both sides of the named column, the saturated tile's
    pixels all stop in its first segment (so its later segments enter below
    1e-4 and add nothing), and ranges start mid-segment of the global
    column index."""
    _, starts, _, grid, _ = _inputs("boundary")
    units = Units(*_layout("boundary", "compact"), grid)
    prod, _ = pass_a(units)
    q_in, _ = entry(units, prod, torch.zeros_like(prod))
    evaluated = _plain_forward("boundary")[2]
    for tile, cross in CROSS_AT.items():
        stop = evaluated[tile]
        if cross < L:
            assert int(stop.max()) < L
            later = (units.tile == tile) & (units.k > 0)
            assert int(later.sum()) >= 5 and bool((q_in[later] < EPS).all())
        else:
            assert int(stop.min()) < cross <= int(stop.max())
    assert (starts[:-1][np.diff(starts) > 0] % L != 0).sum() >= 5
