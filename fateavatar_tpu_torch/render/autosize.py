"""Workload-driven sizing of the static binning capacities.

Port of ``fateavatar_tpu/render/autosize.py``. The binning works at static
sizes: ``instance_budget`` (the compacted candidate list fed to the sort),
``max_tiles_per_gaussian`` R (the per-gaussian rect-walk cap) and, for
'twotier', ``tail_k``. This module measures a workload's tile occupancy
with a cheap probe (FLAME + preprocess only, no sort, no blend) and sizes
the capacities from it:

    R = pow2ceil(max tiles touched by any gaussian * headroom)
    M = ceil(safety * total tiles touched), aligned
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fateavatar_tpu_torch.render import binning
from fateavatar_tpu_torch.render.preprocess import preprocess


def occupancy_stats(mean2d, depth, radius, grid, r0: int = 4):
    """(total_instances, max_tiles_per_gaussian, n_big) of one view, as
    device scalars. ``n_big`` counts gaussians touching more than ``r0``
    tiles, the population 'twotier' binning promotes to the full cap.
    ``mean2d`` is [N, 2] or an (mx, my) tuple; culled gaussians carry
    radius 0 and count no tile."""
    del depth  # occupancy does not depend on depth; kept for the signature
    mx, my = mean2d if isinstance(mean2d, tuple) else mean2d.unbind(-1)
    rmin_x, rmin_y, rmax_x, rmax_y = binning.gaussian_rect(mx, my, radius, grid)
    touched = torch.where(radius > 0, (rmax_x - rmin_x) * (rmax_y - rmin_y), 0)
    return (torch.sum(touched), torch.amax(touched),
            torch.sum((touched > r0).to(torch.int32)))


def _pow2ceil(x: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


@torch.no_grad()
def probe_gaussians(camera, gaussians):
    """Host-side occupancy probe of one splat set under one camera:
    (total instances, max tiles per gaussian)."""
    prep = preprocess(camera, gaussians.xyz, gaussians.get_scaling,
                      gaussians.get_rotation, gaussians.get_opacity,
                      gaussians.get_features, gaussians.sh_degree,
                      alive=gaussians.alive)
    grid = binning.tile_grid(camera.width, camera.height)
    total, max_t, _ = occupancy_stats((prep.soa[0], prep.soa[1]), prep.depth,
                                      prep.radius, grid)
    return int(total), int(max_t)


@torch.no_grad()
def autosize_render_config(model, params, state, frames, base_cfg,
                           safety: float = 1.5, r_headroom: int = 2,
                           chunk_align: int = 4096, probe_views: int = 4,
                           log_fn=None):
    """``base_cfg`` with measured ``instance_budget`` and
    ``max_tiles_per_gaussian`` (and ``tail_k`` for 'twotier'), from the
    occupancy of up to ``probe_views`` of ``frames`` (train/step.py Frames:
    expression, flame_pose, camera and an optional world_transform)."""
    from fateavatar_tpu_torch.models.fateavatar import build_gaussians

    if not isinstance(frames, (list, tuple)):
        frames = [frames]
    total = max_t = n_big = 0
    for f in frames[:probe_views]:
        g, _, _ = build_gaussians(model, params, state, f.expression, f.flame_pose,
                                  world_transform=getattr(f, "world_transform", None))
        prep = preprocess(f.camera, g.xyz, g.get_scaling, g.get_rotation,
                          g.get_opacity, g.get_features, g.sh_degree, alive=g.alive)
        grid = binning.tile_grid(f.camera.width, f.camera.height)
        t, m, nb = occupancy_stats((prep.soa[0], prep.soa[1]), prep.depth,
                                   prep.radius, grid)
        total, max_t, n_big = max(total, int(t)), max(max_t, int(m)), max(n_big, int(nb))

    n = int(state.alive.shape[0])
    grid = binning.tile_grid(model.cfg.img_width, model.cfg.img_height)
    num_tiles = grid[0] * grid[1]
    R = min(_pow2ceil(max(max_t, 1) * r_headroom), _pow2ceil(num_tiles))
    M = int(np.ceil(total * safety))
    M = max((M + chunk_align - 1) // chunk_align * chunk_align, chunk_align)
    M = min(M, n * R)  # candidate expansion can never exceed N * R
    cfg = dataclasses.replace(base_cfg, instance_budget=M, max_tiles_per_gaussian=R)
    if base_cfg.binning == "twotier":
        # a one-shot probe does not see later growth: generous headroom for
        # the big gaussians, still far below N * R
        k = int(np.ceil(max(n_big, 1) * 4 / 256.0)) * 256
        cfg = dataclasses.replace(cfg, tail_k=min(max(k, 256), n))
    if log_fn is not None:
        log_fn(f"[autosize] probe: {total} instances, max {max_t} "
               f"tiles/gaussian -> instance_budget={M} ({M / max(n, 1):.2f}N), "
               f"R={R}" + (f", tail_k={cfg.tail_k}"
                           if base_cfg.binning == "twotier" else ""))
    return cfg


def size_caps(total: int, max_t: int, n: int, num_tiles: int, base_cfg,
              safety: float = 1.08, r_slack: float = 1.25,
              chunk_align: int = 4096, big_count: Optional[int] = None,
              big_slack: float = 2.0):
    """``instance_budget`` / ``max_tiles_per_gaussian`` from a MEASURED peak
    occupancy (e.g. the max over a scouted training span): R needs only a
    small slack then, rounded to a multiple of 4, not a pow2 bump."""
    R = int(np.ceil(max(max_t, 1) * r_slack / 4.0)) * 4
    R = min(R, num_tiles)
    M = int(np.ceil(total * safety))
    M = max((M + chunk_align - 1) // chunk_align * chunk_align, chunk_align)
    M = min(M, n * R)
    cfg = dataclasses.replace(base_cfg, instance_budget=M, max_tiles_per_gaussian=R)
    if big_count is not None and base_cfg.binning == "twotier":
        k = int(np.ceil(max(big_count, 1) * big_slack / 256.0)) * 256
        cfg = dataclasses.replace(cfg, tail_k=min(max(k, 256), n))
    return cfg


def autosize_from_trainstate(model, ts, frame, base_cfg, **kw):
    """:func:`autosize_render_config` of a TrainState's params and state."""
    return autosize_render_config(model, ts.params, ts.state, frame, base_cfg, **kw)


def make_occupancy_probe(model, camera=None):
    """An occupancy probe for scouting a run's capacity needs (FLAME +
    preprocess only, no sort, no blend; autosize.py:146-178 of the JAX
    package). With ``camera``: ``(params, state, expression, flame_pose) ->
    (total, max_t, n_big)`` with the camera closed over; without, the camera
    is the fifth argument. The three counts come back as host ints, in one
    copy at the end."""
    from fateavatar_tpu_torch.models.fateavatar import build_gaussians

    @torch.no_grad()
    def probe(params, state, expression, flame_pose, cam=None):
        cam = camera if cam is None else cam
        g, _, _ = build_gaussians(model, params, state, expression, flame_pose)
        prep = preprocess(cam, g.xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                          g.get_features, g.sh_degree, alive=g.alive)
        grid = binning.tile_grid(cam.width, cam.height)
        stats = occupancy_stats((prep.soa[0], prep.soa[1]), prep.depth, prep.radius, grid)
        return tuple(torch.stack([x.to(torch.int64) for x in stats]).tolist())

    if camera is not None:
        return lambda params, state, expression, flame_pose: probe(
            params, state, expression, flame_pose)
    return probe
