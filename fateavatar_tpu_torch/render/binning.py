"""Tile binning for the two blends.

Port of ``fateavatar_tpu/render/binning.py``: the CUDA pipeline's
InclusiveSum -> duplicateWithKeys -> RadixSort -> identifyTileRanges
(rasterizer_impl.cu:70-336) as a few sorts and scans at static sizes.

* :func:`build_instance_lists` — the flat instance array of the instance
  blend, in every ``sort_mode`` and both layouts of the JAX package;
* :func:`build_tile_lists` and :func:`build_tile_lists_scan` — the dense
  ``[T, K]`` per-tile lists of the ``kernel="tiles"`` blend (one stable
  sort, or the sort-free counting scan).

Results are bit-exact with the JAX package: the same depth order (stable,
ties by index), the same candidate walk, the same budget and ``overflow``
accounting.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from fateavatar_tpu_torch.utils import cuda_build

TILE = 16  # pixels per tile edge (config.h:15-17 BLOCK_X/BLOCK_Y)


class TileLists(NamedTuple):
    """Dense depth-ordered per-tile lists, at most K = ``max_per_tile``
    entries a tile."""

    ids: torch.Tensor          # [num_tiles, K] int32 gaussian index, -1 = empty
    counts: torch.Tensor       # [num_tiles] int32 instances before the K cap
    overflow: torch.Tensor     # [] int32 instances dropped (K, R, budget caps)


class InstanceLists(NamedTuple):
    """Flat depth-sorted instances (the CUDA layout: point_list + per-tile
    ranges), no per-tile cap."""

    instances: torch.Tensor    # [M] int32 gaussian index per instance
                               # (tile-major, depth-ordered within a tile;
                               # unused slots = -1)
    tile_starts: torch.Tensor  # [num_tiles + 1] int32 range offsets
    overflow: torch.Tensor     # [] int32 instances dropped (budget/R caps)
    slots: torch.Tensor | None = None         # [N, R] int32 output slot of each
                               # gaussian's instances (gaussian order;
                               # sentinel M + T * chunk): return_slots
    group_counts: torch.Tensor | None = None  # [N] int32 kept instances per
                               # gaussian id: return_groups
    group_tail: torch.Tensor | None = None    # [K] int32 gaussian ids allowed
                               # more than tail_r0 instances ('twotier')


def tile_grid(width: int, height: int) -> tuple:
    return ((height + TILE - 1) // TILE, (width + TILE - 1) // TILE)


def gaussian_rect(mx, my, radius, grid: tuple):
    """Per-Gaussian tile rect [min, max) in tile units (auxiliary.h:46-56).

    JAX truncates to int32 and then clips to [0, tiles]; clamping the float
    first gives the same integers for every finite value and keeps the cast
    in range on every device."""
    ty, tx = grid

    def cell(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int32)

    return (cell((mx - radius) / TILE, tx),
            cell((my - radius) / TILE, ty),
            cell((mx + radius + TILE - 1) / TILE, tx),
            cell((my + radius + TILE - 1) / TILE, ty))


def _depth_order(depth, visible):
    """Depth order, invisible gaussians last; stable, so bit-equal depths
    keep index order (CUDA's stable radix sort over (tile | depth))."""
    return torch.argsort(torch.where(visible, depth, torch.full_like(depth, float("inf"))),
                         stable=True)


def _rect_walk(r, rect_w, rmin_x, rmin_y, tx):
    """Tile id of candidate ``r`` of a row-major walk over a rect of width
    ``rect_w``. r // w as floor((r + 0.5) * (1/w)) in float32, exactly as
    the JAX package computes it (binning.py:410-413, 470-482): exact for
    integer r, w in this range."""
    recip = 1.0 / rect_w.to(torch.float32)
    q = torch.floor((r.to(torch.float32) + 0.5) * recip).to(torch.int32)
    return (rmin_y + q) * tx + rmin_x + (r - q * rect_w)


def _compact_candidates_plain(rmin_x, rmin_y, rect_w, touched, offsets, order, size,
                              grid_x, num_tiles, max_tiles):
    """:func:`compact_candidates` as the scatter of the [N, R] candidate
    expansion (binning.py:373-390 of the JAX package)."""
    n, dev = rmin_x.shape[0], rmin_x.device
    r = torch.arange(max_tiles, dtype=torch.int32, device=dev)[None, :]
    w = rect_w[:, None]
    tile_id = ((rmin_y[:, None] + torch.div(r, w, rounding_mode="floor")) * grid_x
               + rmin_x[:, None] + torch.remainder(r, w))
    keep = (r < touched[:, None]) & (offsets[:, None] + r < size)
    dest = torch.where(keep, offsets[:, None] + r, size).reshape(-1).long()
    tiles = torch.full((size + 1,), num_tiles, dtype=torch.int32, device=dev)
    tiles[dest] = tile_id.reshape(-1).to(torch.int32)          # slot `size` takes the rest
    gauss = torch.full((size + 1,), -1, dtype=torch.int32, device=dev)
    gauss[dest] = order.to(torch.int32)[:, None].expand(n, max_tiles).reshape(-1)
    return tiles[:size], gauss[:size]


# the C entry point's signature (csrc/bin_compact.cu), the stream last
_COMPACT_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int64) + (ctypes.c_void_p,) * 3


def compact_candidates(rmin_x, rmin_y, rect_w, touched, offsets, order, size, grid_x,
                       num_tiles, max_tiles):
    """The kept candidates of the depth-ranked splats at their compact slots:
    candidate r of rank i, kept where r < ``touched[i]`` and ``offsets[i]``
    + r < ``size`` (the budget), goes to slot offsets[i] + r as the tile of
    the rect's row-major walk, (rmin_y + r // w) * grid_x + rmin_x + r % w,
    and the gaussian ``order[i]``. Returns (tiles, gauss), int32 [size];
    slots past the kept count hold tile ``num_tiles`` and gaussian -1.

    rmin_x, rmin_y, rect_w (>= 1), touched (<= ``max_tiles``) and offsets
    (the exclusive scan of touched) are int32 [N], order int64 [N]. A CUDA
    tensor launches ``csrc/bin_compact.cu`` (counted in
    ``compact_candidates.launches``), which makes nothing of [N, R] size; a
    CPU tensor runs the plain version, the [N, R] scatter."""
    ins = (rmin_x, rmin_y, rect_w, touched, offsets)
    n, dev = rmin_x.shape[0], rmin_x.device
    if any(x.dtype != torch.int32 or tuple(x.shape) != (n,) for x in ins):
        raise ValueError("rmin_x, rmin_y, rect_w, touched and offsets must be int32 [N]")
    if order.dtype != torch.int64 or tuple(order.shape) != (n,):
        raise ValueError(f"order must be int64 [{n}], got {order.dtype} {tuple(order.shape)}")
    if not all(x.device == dev for x in (*ins, order)):
        raise ValueError("compact_candidates' inputs must be on one device")
    if dev.type == "cpu":
        return _compact_candidates_plain(rmin_x, rmin_y, rect_w, touched, offsets, order,
                                         size, grid_x, num_tiles, max_tiles)
    if dev.type != "cuda":
        raise ValueError(f"compact_candidates runs on cuda or cpu, not {dev}")
    if not all(x.is_contiguous() for x in (*ins, order)):
        raise ValueError("compact_candidates needs contiguous inputs")
    tiles = torch.empty((size,), dtype=torch.int32, device=dev)
    gauss = torch.empty((size,), dtype=torch.int32, device=dev)
    cuda_build.launch("bin_compact", "bin_compact_launch", _COMPACT_ARGS, (
        *(x.data_ptr() for x in (*ins, order)), n, num_tiles, grid_x, size,
        tiles.data_ptr(), gauss.data_ptr()), dev)
    compact_candidates.launches += 1
    return tiles, gauss


compact_candidates.launches = 0


SORT_MODES = ("onesort", "twotier", "stable", "count", "gather", "twokey")


def build_instance_lists(
    mean_x: torch.Tensor,
    mean_y: torch.Tensor,
    depth: torch.Tensor,
    radius: torch.Tensor,
    grid: tuple,
    max_tiles_per_gaussian: int = 16,
    instance_budget: int = 0,
    sort_mode: str = "onesort",
    layout: str = "compact",
    tail_r0: int = 4,
    tail_k: int = 0,
    chunk: int = 64,
    relayout: str = "scatter",
    return_slots: bool = False,
    return_groups: bool = False,
) -> InstanceLists:
    """Tile-sorted instance array plus per-tile [start, end) offsets
    (binning.py:190-678 of the JAX package), bit-exact with it.

    Every visible gaussian expands up to R = ``max_tiles_per_gaussian``
    candidates over its rect, row-major; the first M = ``instance_budget``
    (0 = min(4N, N*R)) in depth order are kept; instances past the budget or
    a gaussian's cap are counted in ``overflow``. ``sort_mode``:

    * ``onesort`` and ``stable``: the kept candidates at their compact
      slots (:func:`compact_candidates`), min(M, N*R) of them, then one
      stable sort by tile. The JAX package's ``onesort`` sorts all N*R
      candidates, the rest carrying a sentinel tile; the result is the
      same, since both orders run by (depth rank, r) and a gaussian has at
      most one candidate in a tile. The two names, one code path here, are
      kept to match the JAX package's options, and so are its refusals:
      ``return_groups`` takes ``onesort``, not ``stable``;
    * ``twotier``: R0 = ``tail_r0`` candidates each, R for the ``tail_k``
      largest footprints (0 = max(256, N // 16)), sorted on one packed
      (tile, depth rank) key;
    * ``twokey``: no depth argsort; the compacted instances sorted on
      (tile, depth). The JAX package's sort is unstable there, so depth ties
      in a tile have no defined order; this one breaks them by compaction
      index (gaussian index, then rect walk): equal to it where depths are
      distinct;
    * ``count`` and ``gather``: the JAX package's sort-free and scatter-free
      ways to the result of ``stable`` in the aligned layout, which they
      always give: that result, from ``stable``'s code, with no slots or
      groups (the JAX package returns none for them).

    ``layout``: ``compact`` (the sorted array, raw ranges) or ``aligned``
    (each range padded to a multiple of ``chunk`` with -1, length M + T *
    chunk). ``relayout`` names how the JAX package builds the aligned array
    (``scatter``, or ``gather`` of the inverse map); both give the same
    array, which is scattered here.
    ``return_slots`` (aligned ``stable`` / ``onesort``): [N, R] output slot
    of each gaussian's instances (sentinel M + T * chunk).
    ``return_groups`` (``onesort`` / ``twotier``): kept instances per
    gaussian id, and for ``twotier`` the ids allowed more than R0.
    """
    if sort_mode not in SORT_MODES:
        raise ValueError(f"unknown sort_mode {sort_mode!r}; one of {SORT_MODES}")
    dev = mean_x.device
    n = mean_x.shape[0]
    ty, tx = grid
    num_tiles = ty * tx
    R = max_tiles_per_gaussian
    M = instance_budget or min(4 * n, n * R)
    M_out = M + num_tiles * chunk
    if sort_mode in ("count", "gather"):
        sort_mode, layout, return_slots, return_groups = "stable", "aligned", False, False

    visible = radius > 0
    if sort_mode == "twokey":
        # no depth argsort: the instances sort on (tile, depth) instead
        order = torch.arange(n, device=dev)
        mx_s, my_s = mean_x, mean_y
        radius_s = torch.where(visible, radius, 0)
        visible_s = visible
    else:
        order = _depth_order(depth, visible)
        mx_s = mean_x[order]
        my_s = mean_y[order]
        # the JAX package carries radius through a float32 row gather
        radius_s = radius.to(torch.float32)[order].to(torch.int32)
        visible_s = visible[order]

    rmin_x, rmin_y, rmax_x, rmax_y = gaussian_rect(mx_s, my_s, radius_s, grid)
    rect_w = torch.clamp_min(rmax_x - rmin_x, 1)      # division safety only
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    n_tiles_touched = torch.where(
        visible_s, (rmax_x - rmin_x) * (rmax_y - rmin_y), zero)

    sel_idx = None
    if sort_mode == "twotier":
        # everyone gets R0 candidates; the K largest footprints get R
        R0 = min(tail_r0, R)
        K = min(tail_k or max(256, n // 16), n)
        sel_idx = torch.argsort(-n_tiles_touched, stable=True)[:K]
        # index_fill_, not sel[sel_idx] = True: the latter copies its value
        # from the host, which a CUDA graph cannot capture
        sel = torch.zeros((n,), dtype=torch.bool, device=dev).index_fill_(0, sel_idx, True)
        capr = torch.where(sel, R, R0).to(torch.int32)
        touched_capped = torch.minimum(n_tiles_touched, capr)
        dropped = torch.sum(n_tiles_touched - touched_capped)
    else:
        dropped = torch.sum(torch.clamp_min(n_tiles_touched - R, 0))
        touched_capped = torch.clamp_max(n_tiles_touched, R)

    # exact compaction offsets (the CUDA InclusiveSum over tiles_touched)
    csum = torch.cumsum(touched_capped, 0, dtype=torch.int32)
    offsets = csum - touched_capped                             # exclusive
    n_valid = torch.sum(touched_capped)
    dropped = (dropped + torch.clamp_min(n_valid - M, 0)).to(torch.int32)
    sort_m = None

    if sort_mode != "twotier":
        # the compaction: candidate r of depth rank i to slot offsets[i] + r
        # (binning.py:373-390); no more than N*R slots can be filled
        comp_tiles, comp_gauss = compact_candidates(
            rmin_x, rmin_y, rect_w, touched_capped, offsets, order, min(M, n * R), tx,
            num_tiles, R)
        if sort_mode != "twokey":
            sort_tiles, perm = torch.sort(comp_tiles, stable=True)
            if return_slots:    # the compact index of each sorted instance
                sort_m = perm.to(torch.int32)
        else:
            # (tile, depth, compaction index): a stable sort on depth, then
            # a stable one on tile
            comp_depth = torch.where(comp_gauss >= 0, depth[comp_gauss.clamp_min(0).long()],
                                     float("inf"))
            perm = torch.sort(comp_depth, stable=True)[1]
            sort_tiles, p2 = torch.sort(comp_tiles[perm], stable=True)
            perm = perm[p2]
        sort_gauss = comp_gauss[perm]
    else:
        # key = tile * rank_lim + depth rank: one int32 sort key, unique per
        # valid candidate, so main and tail candidates interleave in depth
        # order within a tile
        rank_lim = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 1)
        if (num_tiles + 1) * rank_lim >= 2**31:
            raise NotImplementedError(
                f"twotier packed key overflows int32 at n={n}, "
                f"num_tiles={num_tiles} — use binning='onesort'")
        if return_slots:
            raise NotImplementedError("slots not supported with twotier")
        rank_all = torch.arange(n, dtype=torch.int32, device=dev)

        def tier(r0, r1, idx):
            """Flat [Nt*(r1-r0)] keys / gaussian ids for ranks [r0, r1) of
            the gaussians at depth ranks ``idx`` (None = all), g-major."""
            pick = (lambda v: v) if idx is None else (lambda v: v[idx])
            rr = torch.arange(r0, r1, dtype=torch.int32, device=dev)[None, :]
            w, cx, cy = pick(rect_w)[:, None], pick(rmin_x)[:, None], pick(rmin_y)[:, None]
            valid = (rr < pick(touched_capped)[:, None]) & (
                pick(offsets)[:, None] + rr < M)
            tile_id = torch.where(valid, _rect_walk(rr, w, cx, cy, tx), num_tiles)
            key = tile_id * rank_lim + pick(rank_all)[:, None]
            gauss = torch.where(valid, pick(order).to(torch.int32)[:, None], -1)
            return key.reshape(-1), gauss.reshape(-1)

        key_main, gauss_main = tier(0, R0, None)
        key_tail, gauss_tail = tier(R0, R, sel_idx)
        keys = torch.cat([key_main, key_tail])
        gauss = torch.cat([gauss_main, gauss_tail])
        # valid keys are unique, invalid ones all carry gaussian -1, so any
        # sort gives the JAX package's result
        sort_keys, perm = torch.sort(keys, stable=True)
        sort_gauss = gauss[perm]
        sort_tiles = torch.div(sort_keys, rank_lim, rounding_mode="floor")

    # the first M sorted entries, padded to M where fewer were sorted
    keep_m = min(M, sort_tiles.shape[0])
    sort_tiles = sort_tiles[:keep_m].to(torch.int32)
    sort_gauss = sort_gauss[:keep_m]
    if sort_m is not None:
        sort_m = sort_m[:keep_m]
    if keep_m < M:
        sort_tiles = torch.cat([sort_tiles, sort_tiles.new_full((M - keep_m,), num_tiles)])
        sort_gauss = torch.cat([sort_gauss, sort_gauss.new_full((M - keep_m,), -1)])
        if sort_m is not None:
            sort_m = torch.cat([sort_m, sort_m.new_full((M - keep_m,), M)])

    group_counts = group_tail = None
    if return_groups:
        # kept instances per gaussian id, for the sort-based transpose
        if sort_mode not in ("onesort", "twotier"):
            raise NotImplementedError(
                f"return_groups requires 'onesort'/'twotier', got {sort_mode!r}")
        kept = torch.minimum(touched_capped, torch.clamp_min(M - offsets, 0))
        group_counts = kept[torch.argsort(order)]
        if sort_mode == "twotier":
            group_tail = order[sel_idx].to(torch.int32)

    raw_starts = torch.searchsorted(
        sort_tiles, torch.arange(num_tiles + 1, dtype=torch.int32, device=dev),
        right=False).to(torch.int32)
    if layout == "compact":
        # the raw (unaligned) offsets are the ranges of the compact layout
        if return_slots:
            raise NotImplementedError("slots not supported with compact")
        return InstanceLists(instances=sort_gauss.contiguous(), tile_starts=raw_starts,
                             overflow=dropped, group_counts=group_counts,
                             group_tail=group_tail)

    # the chunk-aligned re-layout (binning.py:616-645)
    counts = raw_starts[1:] - raw_starts[:-1]
    padded = (counts + chunk - 1) // chunk * chunk
    aligned = torch.cat([counts.new_zeros(1), torch.cumsum(padded, 0)]).to(torch.int32)
    tile_of = torch.clamp(sort_tiles, 0, num_tiles - 1).long()
    rank = torch.arange(M, dtype=torch.int32, device=dev) - raw_starts[tile_of]
    dst = torch.where(sort_tiles < num_tiles, aligned[tile_of] + rank, M_out)
    instances = torch.full((M_out + 1,), -1, dtype=torch.int32, device=dev)
    instances[dst.long()] = sort_gauss
    instances = instances[:M_out]

    slots = None
    if return_slots:
        if sort_mode not in ("stable", "onesort"):
            raise NotImplementedError(
                f"return_slots requires sort_mode 'stable'/'onesort', got {sort_mode!r}")
        # invert the sort permutation (the compact index m of each sorted
        # instance), then read each candidate's output slot: the [N, R]
        # table is the result itself
        k_of_m = torch.argsort(sort_m, stable=True)
        dst_by_m = dst[k_of_m]
        r = torch.arange(R, dtype=torch.int32, device=dev)[None, :]
        keep = (r < touched_capped[:, None]) & (offsets[:, None] + r < M)
        m_nr = torch.clamp_max(offsets[:, None] + r, M - 1).long()
        slot_sorted = torch.where(keep, dst_by_m[m_nr], M_out)
        slots = slot_sorted[torch.argsort(order)].to(torch.int32)

    return InstanceLists(instances=instances.contiguous(), tile_starts=aligned,
                         overflow=dropped, slots=slots, group_counts=group_counts,
                         group_tail=group_tail)


def build_tile_lists(
    mean_x: torch.Tensor,
    mean_y: torch.Tensor,
    depth: torch.Tensor,
    radius: torch.Tensor,
    grid: tuple,
    max_per_tile: int = 1024,
    max_tiles_per_gaussian: int = 32,
    instance_budget: int = 0,
) -> TileLists:
    """[T, K] depth-ordered per-tile lists of gaussian indices
    (binning.py:91-187 of the JAX package).

    Every visible gaussian expands up to R = ``max_tiles_per_gaussian``
    candidates over its rect (row-major); the first M = ``instance_budget``
    (0 = min(6N, N*R)) valid candidates, in depth order, are kept and
    stable-sorted by tile, and each tile's first K = ``max_per_tile`` land in
    its row. ``counts`` are the kept instances per tile before the K cap;
    ``overflow`` adds up the R, budget and K drops."""
    dev = mean_x.device
    n = mean_x.shape[0]
    ty, tx = grid
    num_tiles = ty * tx
    R, K = max_tiles_per_gaussian, max_per_tile
    M = instance_budget or min(6 * n, n * R)

    visible = radius > 0
    order = _depth_order(depth, visible)
    visible_s = visible[order]
    rmin_x, rmin_y, rmax_x, rmax_y = gaussian_rect(
        mean_x[order], mean_y[order], radius[order], grid)
    # a rect clipped to zero width emits no candidate; the max(., 1) is
    # division safety for the walk only
    rect_w = torch.clamp_min(rmax_x - rmin_x, 1)
    touched = (rmax_x - rmin_x) * (rmax_y - rmin_y)
    r = torch.arange(R, dtype=torch.int32, device=dev)[None, :]
    valid = visible_s[:, None] & (r < touched[:, None])
    cand = ((rmin_y[:, None] + torch.div(r, rect_w[:, None], rounding_mode="floor")) * tx
            + rmin_x[:, None] + torch.remainder(r, rect_w[:, None]))
    tile_id = torch.where(valid, cand, num_tiles).reshape(-1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    dropped = torch.sum(torch.where(visible_s, torch.clamp_min(touched - R, 0), zero))

    # compact the valid candidates into the static budget, in (depth, r) order
    flat_valid = valid.reshape(-1)
    pos = torch.cumsum(flat_valid, 0) - 1
    dest = torch.where(flat_valid & (pos < M), pos, M)
    comp_tiles = torch.full((M + 1,), num_tiles, dtype=torch.int32, device=dev)
    comp_tiles[dest] = tile_id.to(torch.int32)       # slot M takes the rest
    comp_gauss = torch.zeros((M + 1,), dtype=torch.int32, device=dev)
    comp_gauss[dest] = order.to(torch.int32)[:, None].expand(n, R).reshape(-1)
    dropped = dropped + torch.clamp_min(torch.sum(flat_valid) - M, 0)

    # stable sort by tile keeps depth order within a tile; rank in tile
    sort_tiles, perm = torch.sort(comp_tiles[:M], stable=True)
    sort_gauss = comp_gauss[:M][perm]
    tile_start = torch.searchsorted(
        sort_tiles, torch.arange(num_tiles + 1, dtype=torch.int32, device=dev))
    rank = (torch.arange(M, device=dev)
            - tile_start[torch.clamp(sort_tiles, 0, num_tiles - 1).long()])
    keep = (sort_tiles < num_tiles) & (rank < K)
    flat_out = torch.where(keep, sort_tiles.long() * K + rank, num_tiles * K)
    lists = torch.full((num_tiles * K + 1,), -1, dtype=torch.int32, device=dev)
    lists[flat_out] = torch.where(keep, sort_gauss, -1)
    counts = tile_start[1:] - tile_start[:-1]
    overflow = torch.sum(torch.clamp_min(counts - K, 0)) + dropped
    return TileLists(ids=lists[:-1].reshape(num_tiles, K),
                     counts=counts.to(torch.int32),
                     overflow=overflow.to(torch.int32))


def build_tile_lists_scan(
    mean_x: torch.Tensor,
    mean_y: torch.Tensor,
    depth: torch.Tensor,
    radius: torch.Tensor,
    grid: tuple,
    max_per_tile: int = 1024,
    max_tiles_per_gaussian: int = 32,
    block: int = 4096,
) -> TileLists:
    """Sort-free tile binning (binning.py:681-779 of the JAX package): the
    depth-ordered gaussians in blocks of ``block``, a per-tile running
    count as the carry, and each instance's rank in its tile as

        rank(g, tile) = carry[tile] + (earlier in-block gaussians covering tile)

    from a cumulative sum over a [T, block] coverage mask. Equal to
    :func:`build_tile_lists` while nothing is dropped.

    Kept as the JAX package computes it, where it departs from
    :func:`build_tile_lists`: ``counts`` count every covered tile, also those
    past a gaussian's R candidates (their slots stay -1); a rect clipped to
    zero width counts as one column wide, so its candidates write into the
    slot the next gaussian covering that tile takes. Where two writes land
    on one slot the later one in (block, gaussian, candidate) order wins, as
    in XLA's scatter."""
    dev = mean_x.device
    n = mean_x.shape[0]
    ty, tx = grid
    num_tiles = ty * tx
    R, K = max_tiles_per_gaussian, max_per_tile
    pad = (-n) % block
    nb = (n + pad) // block

    visible = radius > 0
    order = _depth_order(depth, visible)

    def padded(x, value=0):
        return torch.cat([x, x.new_full((pad,), value)])

    rmin_x, rmin_y, rmax_x, rmax_y = gaussian_rect(
        padded(mean_x[order]), padded(mean_y[order]),
        padded(torch.where(visible, radius, 0)[order]), grid)
    gid = padded(order.to(torch.int32), -1)
    vis_s = padded(visible[order], False)
    rect_w = torch.clamp_min(rmax_x - rmin_x, 1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    touched = torch.where(vis_s, rect_w * (rmax_y - rmin_y), zero)
    dropped = torch.sum(torch.clamp_min(touched - R, 0))

    t_lin = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    t_x, t_y = (t_lin % tx)[:, None], torch.div(t_lin, tx, rounding_mode="floor")[:, None]
    r = torch.arange(R, dtype=torch.int32, device=dev)[None, :]
    g_local = torch.arange(block, device=dev)[:, None]
    carry = torch.zeros((num_tiles,), dtype=torch.int64, device=dev)
    flats = []
    for b in range(nb):
        sl = slice(b * block, (b + 1) * block)
        x0, y0, x1, y1, w, nt = (v[sl] for v in (rmin_x, rmin_y, rmax_x, rmax_y,
                                                  rect_w, touched))
        cover = ((t_x >= x0) & (t_x < x1) & (t_y >= y0) & (t_y < y1)
                 & (nt > 0)).to(torch.int64)                       # [T, B]
        incl = torch.cumsum(cover, dim=1)
        excl = incl - cover
        valid = (r < nt[:, None]) & (gid[sl] >= 0)[:, None]     # [B, R]
        cand = ((y0[:, None] + torch.div(r, w[:, None], rounding_mode="floor")) * tx
                + x0[:, None] + torch.remainder(r, w[:, None]))
        # a zero-width rect at the right edge walks one past the last
        # tile; XLA clamps such gather indices, and the write drops
        ci = torch.clamp(torch.where(valid, cand, 0), 0, num_tiles - 1).long()
        rank = carry[ci] + excl[ci, g_local]
        write = valid & (rank < K)
        flats.append(torch.where(write, torch.where(valid, cand, 0).long() * K + rank,
                                 num_tiles * K).reshape(-1))
        carry = carry + incl[:, -1]

    flat = torch.cat(flats)
    flat = torch.where(flat < num_tiles * K, flat, num_tiles * K)
    # the last write of each slot wins: the largest position among its writes
    position = torch.arange(flat.shape[0], device=dev)
    winner = torch.full((num_tiles * K + 1,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, flat, position, reduce="amax")
    gid_flat = gid[:, None].expand(n + pad, R).reshape(-1)
    ids = torch.where(winner >= 0, gid_flat[winner.clamp_min(0)], -1)[:-1]
    overflow = torch.sum(torch.clamp_min(carry - K, 0)) + dropped
    return TileLists(ids=ids.to(torch.int32).reshape(num_tiles, K),
                     counts=carry.to(torch.int32),
                     overflow=overflow.to(torch.int32))
