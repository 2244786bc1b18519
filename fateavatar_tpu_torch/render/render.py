"""The ``render()`` facade — the contract of the reference's
volume_rendering/render_3dgs.py:7-81.

Port of ``fateavatar_tpu/render/render.py``: per-Gaussian preprocess, then
one of the two routes the JAX package's ``RenderConfig.kernel`` selects:

* ``"instances"``: instance binning (every mode and layout of the JAX
  package) -> the packed instance gather (one of three transposes) -> the
  instance blend (with the optional ``t_cutoff`` early exit);
* ``"tiles"``: dense [T, K] per-tile lists (``build_tile_lists``, or
  ``build_tile_lists_scan`` for ``binning="scan"``) -> the dense gather ->
  the dense-list blend.

Each blend runs its CUDA kernels on the card and their plain versions on
the CPU: the tensor's device chooses, which is why the JAX package's
``impl`` setting has no counterpart here.

Differentiable: the blends' backwards return per-slot gradients, and the
gathers' transposes (9-channel ``index_add_``s, the counterparts of
``_take_packed_slim`` and of XLA's gather transpose) sum them onto the
Gaussians. The ``means2d_probe`` input reproduces the reference's
``screenspace_points`` retain_grad trick (render_3dgs.py:22-27): pass a
zeros [2, N] tensor that requires grad and take its gradient to get the
screen-space position gradients that drive densification.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fateavatar_tpu_torch.ops.camera import Camera
from fateavatar_tpu_torch.render import binning
from fateavatar_tpu_torch.render.blend_instances import (
    CHUNK,
    T_EPS,
    blend_instances,
    blend_instances_bwd,
)
from fateavatar_tpu_torch.render.blend_tiles import blend_tiles, blend_tiles_bwd, tiles_to_image
from fateavatar_tpu_torch.render.preprocess import preprocess
from fateavatar_tpu_torch.render.splats import Gaussians
from fateavatar_tpu_torch.utils import profiling

# the wrappers of the port's rasterizer kernels, by kernel name; each counts
# its kernel's launches in ``.launches``
KERNEL_COUNTERS = {
    "blend_instances_fwd": blend_instances,
    "blend_instances_bwd": blend_instances_bwd,
    "blend_tiles_fwd": blend_tiles,
    "blend_tiles_bwd": blend_tiles_bwd,
    "bin_compact": binning.compact_candidates,
}


@dataclass(frozen=True)
class RenderConfig:
    """The render settings (the JAX package's ``RenderConfig``, same names
    and defaults, but ``impl``: the tensor's device picks the path)."""

    max_per_tile: int = 1024      # 'tiles': K, the slots of each tile's list
    max_tiles_per_gaussian: int = 16
    # 0 = min(4N, N*R) on the 'instances' route, min(6N, N*R) on 'tiles'
    instance_budget: int = 0
    chunk: int = 64               # 'tiles': slots per window of the plain blend
    # 'instances': a sort_mode of binning.build_instance_lists ('onesort',
    # 'twotier', 'count', 'gather', 'twokey'; any other name, 'sort' and
    # 'scan' among them, is 'stable'); 'tiles': 'scan' (the sort-free
    # counting binning), any other value the one stable sort of
    # build_tile_lists
    binning: str = "onesort"
    # the JAX package's 'count' block; accepted for its configs and unused:
    # 'count' gives the result of 'stable' whatever the block
    count_block: int = 256
    tail_r0: int = 4
    tail_k: int = 0               # 0 = max(256, N // 16)
    # consumed by the Trainer at startup: measure the dataset's occupancy
    # and replace budget / R / tail_k with sized values (render/autosize.py)
    autosize: bool = False
    # the transpose of the instance gather ('instances' route); all give
    # the same sums up to their order (render.py:60-77 of the JAX package):
    #   bwd_sorted_scatter: the JAX package's presorted scatter-add, which
    #     only reorders the slim transpose's sums: the slim one here
    #   bwd_slots: the [N, R] slot table of an aligned 'stable' / 'onesort'
    #     binning, gathered and summed (no atomics)
    #   bwd_grouped: one sort of the ids, then [N, r0] (+ the twotier tail's
    #     [K, R - r0]) gathers and masked sums; 'onesort' / 'twotier' only
    # with none of them (or none that applies), the slim 9-channel index_add_
    bwd_sorted_scatter: bool = False
    bwd_slots: bool = False
    bwd_grouped: bool = False
    # the aligned layout's re-layout: 'scatter', or 'gather' (the inverse map)
    relayout: str = "scatter"
    # 'compact' (raw ranges) or 'aligned' (each range padded to 128)
    layout: str = "compact"
    # 'instances' (flat per-tile ranges) or 'tiles' (dense [T, K] lists)
    kernel: str = "instances"
    # 'instances': the chunk-granular early exit of kernels 1 and 2: a tile
    # stops after the first 128-column window (counted from absolute
    # multiples of 128) before which all its pixels' transmittance is below
    # t_cutoff. Values <= 1e-4 give the exact blend (0.0, the yaml default).
    # 'tiles' ignores it, as the JAX package does
    t_cutoff: float = 0.0


class _TakePackedSlim(torch.autograd.Function):
    """The packed instance gather with a 9-channel scatter-add transpose
    (``_take_packed_slim`` of the JAX package, render.py:131-152).

    Forward: rows of [N+1, 16] (the channel layout of blend_instances: 9
    differentiable channels, valid = 1, zero pad; row N a sentinel with
    valid = 0 that unused slots point at), gathered and transposed to
    [16, M]. Backward: ``index_add_`` of the 9 channels' per-instance
    gradients onto the Gaussians. The unused slots (a third or more of M)
    all point at the sentinel; PyTorch's own index backward serializes
    their duplicates (21.6 ms of a full-width step on the H100, PERF.md),
    so their zero gradients are spread over 1,024 scratch rows instead."""

    SPREAD = 1024

    @staticmethod
    def forward(ctx, soa9, ids):
        ctx.save_for_backward(ids)
        ctx.n = soa9.shape[0]
        return _gather_rows(soa9, ids)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        n = ctx.n
        spread = _TakePackedSlim.SPREAD
        lane = torch.arange(ids.shape[0], device=ids.device) % spread
        rows = torch.where(ids == n, n + lane, ids)
        g9 = torch.zeros((n + spread, 9), dtype=g.dtype, device=g.device)
        g9.index_add_(0, rows, g[:9].T)
        return g9[:n], None


def _gather_rows(soa9, ids):
    """The slim gather's forward: rows ``ids`` of [N+1, 16] (9 channels,
    valid = 1, zero pad; row N the sentinel with valid = 0), as [16, M]."""
    n = soa9.shape[0]
    packed = torch.zeros((n + 1, 16), dtype=soa9.dtype, device=soa9.device)
    packed[:n, :9] = soa9
    packed[:n, 9] = 1.0
    return packed[ids].T.contiguous()


class _TakePackedSlots(torch.autograd.Function):
    """The instance gather whose transpose reads each gaussian's <= R
    instance gradients through the binning's ``slots`` [N, R] table and sums
    them (``_take_packed``, render.py:97-124 of the JAX package): gathers
    and a sum, no atomics, so the result does not depend on scheduling.
    Slots past the instances (the sentinel M) read a zero row."""

    @staticmethod
    def forward(ctx, soa9, ids, slots):
        ctx.save_for_backward(slots)
        return _gather_rows(soa9, ids)

    @staticmethod
    def backward(ctx, g):
        slots, = ctx.saved_tensors
        gt = torch.cat([g[:9].T, g.new_zeros((1, 9))])             # [M + 1, 9]
        return gt[slots.long().clamp_max(gt.shape[0] - 1)].sum(dim=1), None, None


class _TakePackedGrouped(torch.autograd.Function):
    """The instance gather whose transpose is sort-based
    (``_take_packed_grouped``, render.py:181-235 of the JAX package): one
    sort of the ids groups the instance gradients by gaussian, whose rows
    then lie at [excl-cumsum(counts)[i], + counts[i]); an [N, r0] gather and
    a masked sum add them up, and for 'twotier' a [K, R - r0] gather adds
    the tail gaussians' further rows. No atomics (the tail ids are unique)."""

    @staticmethod
    def forward(ctx, soa9, ids, counts, tail_ids, r0, r_max):
        ctx.save_for_backward(ids, counts, tail_ids)
        ctx.r0, ctx.r_max = r0, r_max
        return _gather_rows(soa9, ids)

    @staticmethod
    def backward(ctx, g):
        ids, counts, tail_ids = ctx.saved_tensors
        r0, r_max = ctx.r0, ctx.r_max
        m, n, dev = ids.shape[0], counts.shape[0], ids.device
        g_by_id = g[:9].T[torch.argsort(ids, stable=True)]           # [m, 9]
        counts = counts.long()
        starts = torch.cumsum(counts, 0) - counts

        def summed(first, cnt, lo, hi):
            r = torch.arange(lo, hi, device=dev)[None, :]
            rows = g_by_id[torch.clamp_max(first[:, None] + r, m - 1)]   # [*, hi - lo, 9]
            return torch.where((r < cnt[:, None])[..., None], rows, 0.0).sum(dim=1)

        gsum = summed(starts, torch.clamp_max(counts, r0), 0, r0)
        if tail_ids.numel() and r_max > r0:
            tail = tail_ids.long()
            gsum = gsum.index_add(0, tail, summed(starts[tail], counts[tail], r0, r_max))
        return gsum, None, None, None, None, None


class _TakeDense(torch.autograd.Function):
    """The dense per-tile gather of the ``"tiles"`` route and its transpose
    (render.py:399-411 of the JAX package, whose gather XLA transposes to a
    scatter-add).

    Forward: columns ``ids`` (-1 = empty slot) of the [9, N] channels, as
    [9, T*K]; an empty slot reads gaussian 0, as in the JAX package, and the
    blend skips it. Backward: ``index_add_`` of the slots' gradients onto
    the gaussians. Most of T*K is empty slots, whose gradient the blend's
    backward writes as zero; they are spread over scratch columns, since
    duplicates of one index serialize the adds."""

    SPREAD = 1 << 16

    @staticmethod
    def forward(ctx, soa9, ids):
        ctx.save_for_backward(ids)
        ctx.n = soa9.shape[1]
        return soa9.index_select(1, ids.clamp_min(0))

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        n = ctx.n
        spread = _TakeDense.SPREAD
        lane = torch.arange(ids.shape[0], device=ids.device) % spread
        cols = torch.where(ids >= 0, ids, n + lane)
        g9 = torch.zeros((g.shape[0], n + spread), dtype=g.dtype, device=g.device)
        g9.index_add_(1, cols, g)
        return g9[:, :n], None


def render(
    camera: Camera,
    gaussians: Gaussians,
    bg_color: torch.Tensor,
    scaling_modifier: float = 1.0,
    override_color: torch.Tensor | None = None,
    config: RenderConfig = RenderConfig(),
    means2d_probe: torch.Tensor | None = None,
):
    """Rasterize ``gaussians`` into an image.

    Returns a dict: ``render`` [H, W, 3], ``viewspace_points`` [N, 2],
    ``visibility_filter`` [N] bool, ``radii`` [N] int32, ``t_final`` [H, W]
    transmittance, ``overflow`` int32 scalar (instances dropped by the static
    caps; 0 in healthy configs), ``tile_counts`` [T] int32.
    ``override_color``: optional [N, 3] colours used in place of the SH
    colour (render.py:247, 261, 276 of the JAX package).
    ``means2d_probe``: optional [2, N] (or [N, 2]) tensor added to the
    screen-space means; its gradient is d(loss)/d(mean2d).
    """
    if config.kernel not in ("instances", "tiles"):
        raise NotImplementedError(
            f"kernel {config.kernel!r} is not ported; use 'instances' or 'tiles'")
    dev = gaussians.xyz.device
    # stage marks (utils/profiling.py): the raster front runs from the
    # preprocess through the binning and its sort to the gather, the blend
    # from the blend kernel's launch to the image
    profiling.mark("raster_front", dev)
    grid = binning.tile_grid(camera.width, camera.height)
    prep = preprocess(
        camera, gaussians.xyz, gaussians.get_scaling, gaussians.get_rotation,
        gaussians.get_opacity,
        None if override_color is not None else gaussians.get_features,
        gaussians.sh_degree, colors_precomp=override_color,
        scale_modifier=scaling_modifier, alive=gaussians.alive,
    )
    mx, my, c_a, c_b, c_c, col_r, col_g, col_b, op_v = prep.soa
    if means2d_probe is not None:
        # [2, N] (lane-major, as the JAX package prefers) or [N, 2]
        if means2d_probe.dim() == 2 and means2d_probe.shape[0] == 2:
            mx = mx + means2d_probe[0]
            my = my + means2d_probe[1]
        else:
            mx = mx + means2d_probe[..., 0]
            my = my + means2d_probe[..., 1]
    channels = (mx, my, c_a, c_b, c_c, col_r, col_g, col_b, op_v)

    if config.kernel == "tiles":
        if config.binning == "scan":
            lists = binning.build_tile_lists_scan(
                mx.detach(), my.detach(), prep.depth.detach(), prep.radius, grid,
                max_per_tile=config.max_per_tile,
                max_tiles_per_gaussian=config.max_tiles_per_gaussian)
        else:
            lists = binning.build_tile_lists(
                mx.detach(), my.detach(), prep.depth.detach(), prep.radius, grid,
                max_per_tile=config.max_per_tile,
                max_tiles_per_gaussian=config.max_tiles_per_gaussian,
                instance_budget=config.instance_budget)
        ids = lists.ids.reshape(-1).long()
        data = _TakeDense.apply(torch.stack(channels), ids)       # [9, T*K]
        profiling.mark("blend", dev)
        img_tiles, t_final = blend_tiles(data, (ids >= 0).to(torch.float32),
                                         lists.counts, bg_color, grid, config.chunk)
        overflow, tile_counts = lists.overflow, lists.counts
    else:
        # the JAX package's mode mapping (render.py:300-305)
        sort_mode = (config.binning if config.binning in binning.SORT_MODES else "stable")
        use_groups = config.bwd_grouped and sort_mode in ("onesort", "twotier")
        ilists = binning.build_instance_lists(
            mx.detach(), my.detach(), prep.depth.detach(), prep.radius, grid,
            max_tiles_per_gaussian=config.max_tiles_per_gaussian,
            instance_budget=config.instance_budget,
            sort_mode=sort_mode,
            layout=config.layout,
            tail_r0=config.tail_r0,
            tail_k=config.tail_k,
            chunk=CHUNK,
            relayout=config.relayout,
            return_slots=(config.bwd_slots and config.layout == "aligned"
                          and sort_mode in ("stable", "onesort")),
            return_groups=use_groups,
        )
        n = mx.shape[0]
        ids = torch.where(ilists.instances >= 0, ilists.instances, n)
        if config.layout == "compact":
            # pad as the JAX package does, so M matches it (its kernel's last
            # CHUNK-aligned window must stay in bounds); 'count' and 'gather'
            # lists, aligned already, are padded too
            m_real = ids.shape[0]
            m_pad = ((m_real + CHUNK) // CHUNK + 1) * CHUNK
            ids = torch.cat([ids, ids.new_full((m_pad - m_real,), n)])
        ids = ids.long()
        soa9 = torch.stack(channels, dim=1)
        if ilists.slots is not None:
            inst_data = _TakePackedSlots.apply(soa9, ids, ilists.slots)       # [16, M]
        elif use_groups:
            tail = (ilists.group_tail if ilists.group_tail is not None
                    else ids.new_zeros((0,)))
            r0 = (config.tail_r0 if sort_mode == "twotier"
                  else config.max_tiles_per_gaussian)
            inst_data = _TakePackedGrouped.apply(soa9, ids, ilists.group_counts, tail, r0,
                                                 config.max_tiles_per_gaussian)
        else:
            inst_data = _TakePackedSlim.apply(soa9, ids)
        # a cutoff <= 1e-4 is the exact blend (the kernels' bits, launched
        # without the cut pass); the blend is called without it then
        cut = {"cutoff": config.t_cutoff} if config.t_cutoff > T_EPS else {}
        profiling.mark("blend", dev)
        img_tiles, t_final = blend_instances(inst_data, ilists.tile_starts, bg_color,
                                             grid, **cut)
        overflow = ilists.overflow
        tile_counts = ilists.tile_starts[1:] - ilists.tile_starts[:-1]
    image = tiles_to_image(img_tiles, grid, camera.width, camera.height)
    t_img = tiles_to_image(
        t_final[:, None, :].expand(-1, 3, -1), grid,
        camera.width, camera.height,
    )[..., 0]
    return {
        "render": image,
        "viewspace_points": torch.stack([mx, my], dim=-1),
        "visibility_filter": prep.visible,
        "radii": prep.radius,
        "t_final": t_img,
        "overflow": overflow,
        "tile_counts": tile_counts,
    }
