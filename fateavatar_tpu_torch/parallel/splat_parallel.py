"""Gaussian-sharded rendering: the splats split over the ranks of a group.

Port of ``fateavatar_tpu/parallel/splat_parallel.py``. When a scene
outgrows one device, its splats are sharded over D ranks and the tile
instances are resharded to their owners between binning and blending. Each
rank, with its shard:

1. preprocesses its splats;
2. expands R tile candidates per Gaussian and packs each instance's payload
   [depth, mean2d, conic, color, opacity] (10 floats);
3. fills static [D, M_pair, 10] send buffers by owner (rank d owns the tile
   rows ``[d * ty / D, (d + 1) * ty / D)``), counting what overflows a
   buffer as dropped;
4. exchanges them with one all-to-all;
5. sorts what it received by (tile, depth) over its own tile rows;
6. builds the dense [tiles_per_dev, K] lists and blends them with
   ``render/blend_tiles.blend_tiles``: CUDA kernels 3 and 4 on the card
   (the JAX package calls ``blend_tiles_xla``, the XLA twin of kernel 3
   whose VJP is kernel 4's), the plain version on the CPU.

Payloads, not indices, travel with the instances, so the whole pipeline is
differentiable: the sort and the list fill are gathers and scatters of the
payload, the all-to-all transposes to the reverse all-to-all
(``parallel/collectives.py``), and no rank touches another's parameters.

Sort ties: JAX's ``lax.sort(num_keys=2, is_stable=False)`` leaves the order
of equal (tile, depth) pairs open; here two stable sorts (depth, then tile)
keep them in the order received: by source rank, then by the source's
instance order (Gaussian index, then candidate).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from fateavatar_tpu_torch.ops.camera import Camera
from fateavatar_tpu_torch.parallel import collectives
from fateavatar_tpu_torch.render import binning
from fateavatar_tpu_torch.render.blend_tiles import blend_tiles, tiles_to_image
from fateavatar_tpu_torch.render.preprocess import preprocess
from fateavatar_tpu_torch.render.splats import Gaussians

PAYLOAD = 10   # depth, mean x, mean y, conic a, b, c, color r, g, b, opacity


def default_pair_budget(n_local: int, R: int, D: int) -> int:
    """The JAX package's send-buffer rows per destination: 4 n R / (2 D)."""
    return 4 * n_local * R // (D * 2)


def render_shard_body(
    camera: Camera,
    g: Gaussians,
    bg: torch.Tensor,
    *,
    group=None,
    max_tiles_per_gaussian: int = 16,
    pair_budget: int = 0,
    max_per_tile: int = 1024,
    chunk: int = 64,
    mean2d_probe: Optional[torch.Tensor] = None,
):
    """The per-rank render pipeline over ``group`` (None: the default
    group). ``g`` is this rank's splat shard; ``mean2d_probe`` [2, n], a
    zeros tensor whose gradient is d(loss)/d(mean2d) of the shard. Returns
    this rank's tile rows of the image [tiles_per_dev, 3, 256], its dropped
    instance count [1] int64 and the shard's visibility [n] bool."""
    D = dist.get_world_size(group)
    dev = dist.get_rank(group)
    grid = binning.tile_grid(camera.width, camera.height)
    ty, tx = grid
    num_tiles = ty * tx
    if ty % D:
        raise ValueError(f"tile rows {ty} must divide over {D} ranks")
    rows_per_dev = ty // D
    tiles_per_dev = rows_per_dev * tx
    R = max_tiles_per_gaussian
    n_local = g.xyz.shape[0]
    M_pair = pair_budget or default_pair_budget(n_local, R, D)
    K = max_per_tile
    device = g.xyz.device

    prep = preprocess(camera, g.xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                      g.get_features, g.sh_degree, alive=g.alive)
    mx, my, c_a, c_b, c_c, col_r, col_g, col_b, op_v = prep.soa
    if mean2d_probe is not None:
        mx = mx + mean2d_probe[0]
        my = my + mean2d_probe[1]

    # candidate expansion (local shard); a rect clipped off an edge emits
    # no candidate (binning.py's rule)
    rminx, rminy, rmaxx, rmaxy = binning.gaussian_rect(mx.detach(), my.detach(),
                                                       prep.radius, grid)
    rect_w = torch.clamp_min(rmaxx - rminx, 1)
    touched = torch.where(prep.visible, (rmaxx - rminx) * (rmaxy - rminy), 0)
    r_lin = torch.arange(R, dtype=torch.int32, device=device)[None, :]
    cand_x = rminx[:, None] + r_lin % rect_w[:, None]
    cand_y = rminy[:, None] + torch.div(r_lin, rect_w[:, None], rounding_mode="floor")
    valid = (r_lin < touched[:, None]).reshape(-1)
    flat_tiles = torch.where(valid, (cand_y * tx + cand_x).reshape(-1), num_tiles)
    dropped = torch.sum(torch.clamp_min(touched - R, 0)).to(torch.int64)

    payload = torch.stack([prep.depth, mx, my, c_a, c_b, c_c, col_r, col_g, col_b, op_v],
                          dim=-1)                                      # [n, 10]
    flat_payload = payload[:, None, :].expand(n_local, R, PAYLOAD).reshape(-1, PAYLOAD)

    # bucket by owner rank: each instance's place in its owner's buffer,
    # or the sentinel row D * M_pair (dropped, cut off below)
    owner = torch.where(valid, torch.clamp(flat_tiles // tiles_per_dev, 0, D - 1), D)
    dst = torch.full_like(flat_tiles, D * M_pair, dtype=torch.int64)
    for d in range(D):
        m = owner == d
        pos = torch.cumsum(m.to(torch.int64), 0) - 1
        dst = torch.where(m & (pos < M_pair), d * M_pair + pos, dst)
        dropped = dropped + torch.clamp_min(torch.sum(m) - M_pair, 0)
    send_pay = flat_payload.new_zeros((D * M_pair + 1, PAYLOAD)).index_copy(
        0, dst, flat_payload)[:-1].reshape(D, M_pair, PAYLOAD)
    send_tile = flat_tiles.new_full((D * M_pair + 1,), num_tiles).index_copy(
        0, dst, flat_tiles)[:-1].reshape(D, M_pair)

    recv_pay = collectives.all_to_all(send_pay, group)
    recv_tile = collectives.all_to_all_raw(send_tile, group)

    # local (tile, depth) order over everything received
    flat_t = recv_tile.reshape(-1)
    flat_p = recv_pay.reshape(-1, PAYLOAD)
    local_tile = torch.where(flat_t < num_tiles, flat_t - dev * tiles_per_dev,
                             tiles_per_dev).to(torch.int64)
    by_depth = torch.argsort(flat_p[:, 0].detach(), stable=True)
    order = by_depth[torch.argsort(local_tile[by_depth], stable=True)]
    sort_t = local_tile[order]
    sorted_pay = flat_p[order]

    # dense [K] lists of the local tiles
    Mr = sort_t.shape[0]
    starts = torch.searchsorted(
        sort_t, torch.arange(tiles_per_dev + 1, dtype=torch.int64, device=device))
    rank = torch.arange(Mr, device=device) - starts[torch.clamp(sort_t, 0, tiles_per_dev - 1)]
    keep = (sort_t < tiles_per_dev) & (rank < K)
    flat_idx = torch.where(keep, sort_t * K + rank, tiles_per_dev * K)
    lists = sorted_pay.new_zeros((tiles_per_dev * K + 1, PAYLOAD)).index_copy(
        0, flat_idx, sorted_pay)[:-1]
    valid_lists = keep.to(torch.float32).new_zeros(tiles_per_dev * K + 1).index_copy(
        0, flat_idx, keep.to(torch.float32))[:-1]
    counts = starts[1:] - starts[:-1]
    dropped = dropped + torch.sum(torch.clamp_min(counts - K, 0))

    # blend the local tile rows on their own sub-grid: the means shift by
    # the rows above them (splat_parallel.py:227-231)
    y_off = float(dev * rows_per_dev * binning.TILE)
    data = lists[:, 1:].t()
    data = torch.cat([data[:1], data[1:2] - y_off, data[2:]]).contiguous()
    img_tiles, _ = blend_tiles(data, valid_lists, torch.clamp_max(counts, K).to(torch.int32),
                               bg, (rows_per_dev, tx), chunk)
    return img_tiles, dropped.reshape(1), prep.visible


def render_splat_sharded(
    camera: Camera,
    gaussians: Gaussians,
    bg_color: torch.Tensor,
    group=None,
    max_tiles_per_gaussian: int = 16,
    pair_budget: int = 0,
    max_per_tile: int = 1024,
    chunk: int = 64,
):
    """Render the splats sharded over ``group`` (this rank's shard in
    ``gaussians``). Returns (image [H, W, 3], dropped) on every rank: the
    tile rows are all-gathered, and the dropped counts summed. The image's
    gradient follows the all-gather's rule: each rank's loss of it counts
    once in the sum over ranks (a loss every rank computes alike is divided
    by the rank count)."""
    img_tiles, dropped, _ = render_shard_body(
        camera, gaussians, bg_color, group=group,
        max_tiles_per_gaussian=max_tiles_per_gaussian, pair_budget=pair_budget,
        max_per_tile=max_per_tile, chunk=chunk)
    tiles = collectives.all_gather(img_tiles, group)
    grid = binning.tile_grid(camera.width, camera.height)
    image = tiles_to_image(tiles, grid, camera.width, camera.height)
    return image, collectives.all_reduce_raw(dropped, group=group)[0]
