"""2-D training: data-parallel frames x model-parallel splats.

Port of ``fateavatar_tpu/parallel/mesh2d.py``, run by every rank of a
``Bd x Dg`` layout (:class:`Mesh2D`: rank = d * Dg + g, one process group
per row and per column):

* frames split over ``data`` (one frame per row d), as in
  ``parallel/data_parallel.py``;
* every per-splat parameter and state leaf, and its Adam moments, is
  sharded over ``gauss`` (column g holds rows ``[g n/Dg, (g+1) n/Dg)``);
  the FLAME deltas are replicated;
* each rank FLAME-drives its shard for its row's frame, renders its tile
  rows through :func:`render_shard_body` (the candidates go to their tile
  owners over an all-to-all within the row), and contributes a share of
  the loss: pixels ``/(H W 3 Bd)``, the scale term ``/(n_total Bd)``, the
  windowed terms (DSSIM, VGG) on the row's all-gathered image ``/(Bd Dg)``;
  the loss is the sum of the shares over both axes.

Each rank takes the gradient of its own share; the collectives' transposes
route the cotangents across the row, so a sharded leaf's gradient is then
summed over its column (the frames) and a replicated leaf's over every
rank. :func:`mesh2d_maintenance` densifies and prunes between phases on the
gathered state; the step's own densify (``densify_interval``) runs sharded
every step and is applied by a masked select, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from fateavatar_tpu_torch.models import maintenance
from fateavatar_tpu_torch.models.fateavatar import (
    FateAvatarModel,
    FateAvatarParams,
    FateAvatarState,
    build_gaussians,
)
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.parallel import collectives
from fateavatar_tpu_torch.parallel.data_parallel import _flat, _unflat, frame_at
from fateavatar_tpu_torch.parallel.splat_parallel import render_shard_body
from fateavatar_tpu_torch.render import binning
from fateavatar_tpu_torch.render.blend_tiles import tiles_to_image
from fateavatar_tpu_torch.train.losses import as_float_rgb, d_ssim, vgg_perceptual_loss
from fateavatar_tpu_torch.train.optim import MultiAdam, MultiAdamState, apply_updates, zero_moment_rows
from fateavatar_tpu_torch.train.step import Frame, TrainState, _select
from fateavatar_tpu_torch.train.tracking import TrackingTables

SHARDED_PARAMS = ("offset", "features_dc", "features_rest", "scaling", "rotation", "opacity")
REPLICATED_PARAMS = ("delta_shapedirs", "delta_posedirs", "delta_vertex")


class Mesh2D:
    """A (data, gauss) layout of the default group's ranks: this rank's
    coordinates (``d``, ``g``), its row's group (``gauss_group``: the ranks
    that share a frame and split the splats) and its column's group
    (``data_group``: the ranks that hold one shard, one frame each). Every
    rank must build it, in the same order as the others."""

    def __init__(self, data: int, gauss: int, device):
        world, rank = dist.get_world_size(), dist.get_rank()
        if data * gauss != world:
            raise ValueError(f"a {data}x{gauss} mesh needs {data * gauss} ranks, "
                             f"the process group has {world}")
        self.data, self.gauss = data, gauss
        self.d, self.g = divmod(rank, gauss)
        self.device = torch.device(device)
        self.gauss_group = self.data_group = None
        for d in range(data):
            grp = dist.new_group([d * gauss + g for g in range(gauss)])
            if d == self.d:
                self.gauss_group = grp
        for g in range(gauss):
            grp = dist.new_group([d * gauss + g for d in range(data)])
            if g == self.g:
                self.data_group = grp

    def all_reduce(self, x, group, op=dist.ReduceOp.SUM):
        return collectives.all_reduce_raw(x, op=op, group=group)

    def broadcast(self, *tensors: torch.Tensor) -> tuple:
        """Rank 0's ``tensors`` on every rank of the layout (copies)."""
        return collectives.broadcast_raw(*tensors)


def fateavatar_mesh2d_specs():
    """The layout of each FateAvatar params / state field under the 2-D
    mesh: "gauss" (sharded over it) or None (replicated)."""
    params_spec = {f: ("gauss" if f in SHARDED_PARAMS else None)
                   for f in (*SHARDED_PARAMS, *REPLICATED_PARAMS)}
    state_spec = {f.name: "gauss" for f in dataclasses.fields(FateAvatarState)}
    return params_spec, state_spec


def _shard(obj, spec: dict, mesh: Mesh2D):
    """``obj`` with the fields that ``spec`` shards cut to this rank's
    rows."""
    def part(x):
        n = x.shape[0] // mesh.gauss
        return x[mesh.g * n:(mesh.g + 1) * n].clone()

    return dataclasses.replace(obj, **{f: part(getattr(obj, f))
                                       for f, axis in spec.items() if axis is not None})


def place_mesh2d(ts: TrainState, mesh: Mesh2D) -> TrainState:
    """This rank's part of a whole TrainState (the same on every rank), by
    :func:`fateavatar_mesh2d_specs`: the per-splat leaves and their moments
    cut to the rank's shard; the FLAME deltas, the Adam count, the step and
    the generator as they are."""
    n = ts.state.alive.shape[0]
    if n % mesh.gauss:
        raise ValueError(f"{n} splats do not divide over gauss={mesh.gauss}")
    pspec, sspec = fateavatar_mesh2d_specs()
    o = ts.opt_state
    return TrainState(
        params=_shard(ts.params, pspec, mesh), state=_shard(ts.state, sspec, mesh),
        opt_state=MultiAdamState(mu=_shard(o.mu, pspec, mesh), nu=_shard(o.nu, pspec, mesh),
                                 count=o.count),
        step=ts.step, generator=ts.generator)


def gather_mesh2d(ts: TrainState, mesh: Mesh2D) -> TrainState:
    """The whole TrainState from the shards of this rank's row (the inverse
    of :func:`place_mesh2d`)."""
    pspec, sspec = fateavatar_mesh2d_specs()

    def gather(obj, spec):
        return dataclasses.replace(obj, **{
            f: collectives.all_gather_raw(getattr(obj, f), mesh.gauss_group)
            for f, axis in spec.items() if axis is not None})

    o = ts.opt_state
    return TrainState(
        params=gather(ts.params, pspec), state=gather(ts.state, sspec),
        opt_state=MultiAdamState(mu=gather(o.mu, pspec), nu=gather(o.nu, pspec),
                                 count=o.count),
        step=ts.step, generator=ts.generator)


def mesh2d_maintenance(ts: TrainState, mesh: Mesh2D, *, increase_num: int = 1000,
                       min_opacity: float = 0.005, max_points_num: int = 0) -> TrainState:
    """Between-phase densify and prune: gather the shards, run the
    single-device ops (densify while ``increase_num`` more fit under
    ``max_points_num``, else the capacity), and place the result again.
    Every rank takes rank 0's draws (``torch.multinomial``'s sums on a
    card are not reproducible, so a generator seeded alike is not enough)."""
    from fateavatar_tpu_torch.models.maintenance import SPLAT_FIELDS

    full = gather_mesh2d(ts, mesh)
    params, state, opt_state = full.params, full.state, full.opt_state
    cap = max_points_num or state.alive.shape[0]
    if int(torch.sum(state.alive)) + increase_num <= cap:
        params, state, touched = maintenance.uv_densify(ts.generator, params, state,
                                                        increase_num=increase_num,
                                                        share=mesh.broadcast)
        opt_state = zero_moment_rows(opt_state, touched, SPLAT_FIELDS)
    state = maintenance.prune_low_opacity(params, state, min_opacity)
    return place_mesh2d(TrainState(params=params, state=state, opt_state=opt_state,
                                   step=ts.step, generator=ts.generator), mesh)


def sharded_densify_draws(generator: torch.Generator, state: FateAvatarState,
                          mesh: Mesh2D, increase_num: int):
    """The draws of :func:`sharded_densify`, rank 0's on every rank:
    ``increase_num`` GLOBAL source ids by the all-gathered gradient
    accumulator (uniform over alive splats while it is all 0), and their
    barycentric points. Returns (src [k] int64, bary [k, 3])."""
    probs = collectives.all_gather_raw(
        torch.where(state.alive, state.xyz_gradient_accum, 0.0), mesh.gauss_group)
    alive = collectives.all_gather_raw(state.alive.to(torch.float32), mesh.gauss_group)
    probs = torch.where(torch.sum(probs) > 0, probs, alive)
    src = torch.multinomial(probs, increase_num, replacement=True, generator=generator)
    uvw = torch.rand((increase_num, 3), generator=generator, device=probs.device)
    return mesh.broadcast(src, uvw / torch.sum(uvw, dim=-1, keepdim=True))


def sharded_densify(params: FateAvatarParams, state: FateAvatarState, mesh: Mesh2D,
                    src: torch.Tensor, new_bary: torch.Tensor):
    """uv_densify on the gauss-sharded leaves (``_sharded_densify`` of the
    JAX package) with the draws given: each source ROW is fetched from the
    shard that owns it (a masked gather and a sum over the row), and each
    shard fills its own dead slots with its 1/Dg quota of the new splats
    (what does not fit is dropped and left out of ``touched``). Scale x0.75,
    stats reset. Returns (params, state, touched)."""
    Dg, g = mesh.gauss, mesh.g
    k = src.shape[0]
    if k % Dg:
        raise ValueError(f"increase_num {k} must divide over gauss={Dg}")
    quota = k // Dg
    n_local = state.alive.shape[0]
    local_idx = src - g * n_local
    own = (local_idx >= 0) & (local_idx < n_local)
    safe = torch.clamp(local_idx, 0, n_local - 1)

    def fetch(arr):
        rows = arr[safe].to(torch.float32)
        mask = own.reshape((-1,) + (1,) * (rows.dim() - 1))
        return mesh.all_reduce(torch.where(mask, rows, 0.0), mesh.gauss_group)

    def mine(rows):
        return rows[g * quota:(g + 1) * quota]

    slots, valid = maintenance._free_slots(state.alive, quota)

    def write(dst, rows):
        return maintenance._write(dst, slots, mine(rows))

    new_params = dataclasses.replace(
        params,
        offset=write(params.offset, fetch(params.offset)),
        features_dc=write(params.features_dc, fetch(params.features_dc)),
        features_rest=write(params.features_rest, fetch(params.features_rest)),
        scaling=write(params.scaling, fetch(params.scaling) + math.log(0.75)),
        rotation=write(params.rotation, fetch(params.rotation)),
        opacity=write(params.opacity, fetch(params.opacity)),
    )
    new_state = dataclasses.replace(
        state,
        face_index=write(state.face_index, fetch(state.face_index)),
        bary_coords=write(state.bary_coords, new_bary),
        alive=maintenance._write(state.alive, slots, valid),
        sample_flag=write(state.sample_flag, torch.ones_like(new_bary[:, 0])),
        xyz_gradient_accum=torch.zeros_like(state.xyz_gradient_accum),
        denom=torch.zeros_like(state.denom),
        max_radii2d=torch.zeros_like(state.max_radii2d),
    )
    touched = maintenance._write(torch.zeros((n_local,), dtype=torch.bool,
                                             device=valid.device), slots, valid)
    return new_params, new_state, touched


def _row_frame(frames: Frame, mesh: Mesh2D) -> Frame:
    return frame_at(frames, mesh.d) if frames.rgb.dim() == 4 else frames


def make_mesh2d_train_step(
    model: FateAvatarModel,
    optimizer: MultiAdam,
    mesh: Mesh2D,
    *,
    rgb_weight: float = 1.0,
    dssim_weight: float = 0.0,
    vgg_weight: float = 0.0,
    vgg_params=None,
    scale_weight: float = 0.1,
    scale_threshold: float = 9.0,
    max_tiles_per_gaussian: int = 16,
    pair_budget: int = 0,
    max_per_tile: int = 1024,
    chunk: int = 32,
    densify_interval: int = 0,
    prune_interval: int = 0,
    increase_num: int = 1024,
    min_opacity: float = 0.005,
    max_points_num: int = 0,
    return_grads: bool = False,
    densify_draws=None,
):
    """The 2-D step, run by every rank: (this rank's TrainState from
    :func:`place_mesh2d`, its row's Frame or the batched Frame of all Bd
    rows) -> (TrainState, aux). aux: "loss" (the whole batch's),
    "overflow", "num_alive"; with ``return_grads``, "grads" (this rank's
    shards of the sharded leaves, the replicated leaves whole) and
    "probe_grad" [2, n_local] (its frame's). The step updates
    ``xyz_gradient_accum`` and ``denom`` only (no ``max_radii2d``), as the
    JAX package does. ``densify_draws(generator, state, mesh, k)`` replaces
    :func:`sharded_densify_draws` (tests inject their sources)."""
    Bd, Dg = mesh.data, mesh.gauss
    H, W = model.cfg.img_height, model.cfg.img_width
    grid = binning.tile_grid(W, H)
    ty, tx = grid
    if H % binning.TILE:
        raise ValueError(f"mesh2d needs the image height ({H}) tile-aligned "
                         f"({binning.TILE}) so the ground truth rows slice exactly")
    if ty % Dg:
        raise ValueError(f"tile rows {ty} must divide over gauss={Dg}")
    rows_per_dev = ty // Dg
    row_px = rows_per_dev * binning.TILE
    draws = densify_draws or sharded_densify_draws

    def local_share(ts: TrainState, f: Frame):
        """This rank's loss share and its gradients."""
        leaves = {k: getattr(ts.params, k).detach().requires_grad_()
                  for k in (*SHARDED_PARAMS, *REPLICATED_PARAMS)}
        params = dataclasses.replace(ts.params, **leaves)
        state = ts.state
        n_local = state.alive.shape[0]
        probe = torch.zeros((2, n_local), dtype=torch.float32, device=state.alive.device,
                            requires_grad=True)
        gaussians, _, _ = build_gaussians(model, params, state, f.expression, f.flame_pose)
        img_tiles, dropped, visible = render_shard_body(
            f.camera, gaussians, f.bg_color, group=mesh.gauss_group,
            max_tiles_per_gaussian=max_tiles_per_gaussian, pair_budget=pair_budget,
            max_per_tile=max_per_tile, chunk=chunk, mean2d_probe=probe)
        local_img = tiles_to_image(img_tiles, (rows_per_dev, tx), W, row_px)
        gt = as_float_rgb(f.rgb)
        gt_rows = gt[mesh.g * row_px:(mesh.g + 1) * row_px]
        pix = torch.sum(torch.abs(local_img - gt_rows)) / (H * W * 3 * Bd)
        window = 0.0
        if dssim_weight > 0 or (vgg_weight > 0 and vgg_params is not None):
            # windowed terms straddle the row boundaries: on the gathered
            # image, whose transpose reduce-scatters the cotangents
            img_full = tiles_to_image(collectives.all_gather(img_tiles, mesh.gauss_group),
                                      grid, W, H)
            if dssim_weight > 0:
                window = window + dssim_weight * d_ssim(img_full, gt) / (Bd * Dg)
            if vgg_weight > 0 and vgg_params is not None:
                window = window + vgg_weight * vgg_perceptual_loss(
                    vgg_params, img_full, gt) / (Bd * Dg)
        s = torch.exp(params.scaling)
        ratio = torch.amax(s, dim=-1) / torch.clamp_min(torch.amin(s, dim=-1), 1e-12)
        reg = torch.sum(torch.where(state.alive, torch.clamp_min(ratio - scale_threshold, 0.0),
                                    0.0)) / (n_local * Dg * Bd)
        local = rgb_weight * pix + scale_weight * reg + window
        g = torch.autograd.grad(local, [*leaves.values(), probe], allow_unused=True)
        g = [torch.zeros_like(x) if gx is None else gx
             for x, gx in zip([*leaves.values(), probe], g)]
        return local.detach(), dict(zip(leaves, g[:-1])), g[-1], dropped, visible

    def step_fn(ts: TrainState, frames: Frame):
        f = _row_frame(frames, mesh)
        local, g, probe_grad, dropped, visible = local_share(ts, f)
        gnorm = torch.sqrt(probe_grad[0] ** 2 + probe_grad[1] ** 2)
        # the column sums: the sharded gradients over the frames, the
        # statistics; then everything replicated over every rank
        col = [g[k] for k in SHARDED_PARAMS] + [gnorm, visible.to(torch.float32)]
        col = _unflat(mesh.all_reduce(_flat(col), mesh.data_group), col)
        full = [g[k] for k in REPLICATED_PARAMS] + [local.reshape(1),
                                                     dropped.to(torch.float32)]
        full = _unflat(mesh.all_reduce(_flat(full), None), full)
        sharded = dict(zip(SHARDED_PARAMS, col[:len(SHARDED_PARAMS)]))
        gnorm_sum, vis_count = col[len(SHARDED_PARAMS):]
        grads = dataclasses.replace(ts.params, **sharded,
                                    **dict(zip(REPLICATED_PARAMS, full[:3])))
        loss, overflow = full[3][0], torch.round(full[4][0]).to(torch.int64)

        state = ts.state
        vis = vis_count > 0
        state = dataclasses.replace(
            state,
            xyz_gradient_accum=state.xyz_gradient_accum
            + torch.where(vis & state.alive, gnorm_sum, 0.0),
            denom=state.denom + torch.where(state.alive, vis_count, 0.0))
        updates, opt_state = optimizer.update(grads, ts.opt_state, ts.params)
        params = apply_updates(ts.params, updates)
        step = ts.step + 1

        if densify_interval:
            # computed every step (collectives inside a branch would need
            # every rank to take it) and applied by a masked select
            n_total = state.alive.shape[0] * Dg
            cap = max_points_num or n_total
            num_alive = mesh.all_reduce(torch.sum(state.alive).reshape(1), mesh.gauss_group)[0]
            do = (num_alive + increase_num <= cap) & (step % densify_interval == 0)
            src, bary = draws(ts.generator, state, mesh, increase_num)
            d_params, d_state, touched = sharded_densify(params, state, mesh, src, bary)
            params = _select(do, d_params, params)
            state = _select(do, d_state, state)
            opt_state = zero_moment_rows(opt_state, touched & do, maintenance.SPLAT_FIELDS)
        if prune_interval and step % prune_interval == 0:
            keep = torch.sigmoid(params.opacity[:, 0]) >= min_opacity
            state = dataclasses.replace(state, alive=state.alive & keep)

        aux = {"loss": loss, "overflow": overflow,
               "num_alive": mesh.all_reduce(torch.sum(state.alive).reshape(1),
                                            mesh.gauss_group)[0]}
        if return_grads:
            aux["grads"] = grads
            aux["probe_grad"] = probe_grad
        return TrainState(params=params, state=state, opt_state=opt_state, step=step,
                          generator=ts.generator), aux

    return step_fn


def make_mesh2d_tracking_step(
    model: FateAvatarModel,
    mesh: Mesh2D,
    track_opt,
    *,
    max_tiles_per_gaussian: int = 16,
    pair_budget: int = 0,
    max_per_tile: int = 1024,
    chunk: int = 32,
):
    """Tracking refinement on the 2-D mesh: the Bd frames' rows (expression,
    pose, camera translation) take one RowAdam update from the pixel loss
    of their sharded renders; the model is frozen.

    ``step(tables, track_state, idxs [Bd], mask [Bd], params, state, fc)
    -> (tables, track_state, loss)``: the tables replicated, ``params`` and
    ``state`` this rank's shard, ``fc`` the per-frame constants of all Bd
    frames: ``R`` [Bd, 3, 3], ``fovx`` / ``fovy`` [Bd], ``rgb``
    [Bd, H, W, 3], ``bg`` [Bd, 3]. ``mask`` disables padded rows."""
    Bd, Dg = mesh.data, mesh.gauss
    H, W = model.cfg.img_height, model.cfg.img_width
    ty, tx = binning.tile_grid(W, H)
    if ty % Dg:
        raise ValueError(f"tile rows {ty} must divide over gauss={Dg}")
    rows_per_dev = ty // Dg
    row_px = rows_per_dev * binning.TILE

    def step(tables: TrackingTables, track_state, idxs, mask, params, state, fc):
        d = mesh.d
        i = idxs[d]
        rows = [t[i].detach().requires_grad_()
                for t in (tables.expression, tables.flame_pose, tables.cam_t)]
        e, p, t = rows
        cam = make_camera(fc["R"][d], t, fc["fovx"][d], fc["fovy"][d], W, H,
                          device=mesh.device)
        gaussians, _, _ = build_gaussians(model, params, state, e, p)
        img_tiles, _, _ = render_shard_body(
            cam, gaussians, fc["bg"][d], group=mesh.gauss_group,
            max_tiles_per_gaussian=max_tiles_per_gaussian, pair_budget=pair_budget,
            max_per_tile=max_per_tile, chunk=chunk)
        local_img = tiles_to_image(img_tiles, (rows_per_dev, tx), W, row_px)
        gt_rows = as_float_rgb(fc["rgb"][d])[mesh.g * row_px:(mesh.g + 1) * row_px]
        pix = torch.sum(torch.abs(local_img - gt_rows)) / (H * W * 3 * Bd)
        g = torch.autograd.grad(pix, rows)
        # the row's frame: summed over its gauss ranks; then every frame's
        # rows gathered over the column
        g = _unflat(mesh.all_reduce(_flat([*g, pix.detach().reshape(1)]), mesh.gauss_group),
                    [*g, pix.reshape(1)])
        row_grads = TrackingTables(
            *(collectives.all_gather_raw(x[None], mesh.data_group) for x in g[:3]))
        loss = mesh.all_reduce(g[3], mesh.data_group)[0]
        tables, track_state = track_opt.update_rows(tables, track_state, row_grads,
                                                    idxs, mask)
        return tables, track_state, loss

    return step
