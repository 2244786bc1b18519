"""Plain 3D Gaussian splatting: per-splat preprocessing, then a dense blend
written per pixel.

``preprocess`` is a frozen copy of the port's plain ``render/preprocess.py``
(the CUDA rasterizer's ``preprocessCUDA``: near cull at z <= 0.2, EWA
projection with the 1.3 tan(fov) clamp, +0.3 px low-pass, radius
ceil(3 sigma), ndc to pixel). The blend is the rasterizer's ``renderCUDA``
rule written densely: each pixel of a 16x16 tile takes every splat whose
tile rectangle covers the tile, front to back by view depth, with
alpha = min(0.99, o exp(power)), entries with power > 0 or alpha < 1/255
skipped, and stops before the entry that would take its transmittance
below 1e-4. No binning cap, list or kernel of the port is involved: the
lists are every (tile, splat) pair of the rectangles, and the blend is
cumulative products over each pixel's whole list.

Tiles are blended in blocks of similar list length, each block under
``torch.utils.checkpoint`` when a gradient is wanted, so the memory stays a
few [tiles, list, 256] tensors. Every function works in the dtype of its
inputs.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

TILE = 16
P = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1.0e-4
C0 = 0.28209479177387814
BLOCK_ELEMS = 1 << 25     # tiles x list x pixels of one block


def _cov3d(scale, q):
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-8)
    w, x, y, z = q.unbind(-1)
    r = ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
         (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
         (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)))
    v = [s * s for s in scale.unbind(-1)]

    def c(i, j):
        return r[i][0] * r[j][0] * v[0] + r[i][1] * r[j][1] * v[1] + r[i][2] * r[j][2] * v[2]

    return c(0, 0), c(0, 1), c(0, 2), c(1, 1), c(1, 2), c(2, 2)


def _cov2d(mean3d, cov3d, cam):
    view = cam.view
    t = mean3d @ view[:3, :3].T + view[:3, 3]
    tz = t[..., 2]
    limx, limy = 1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy
    txtz, tytz = t[..., 0] / tz, t[..., 1] / tz
    in_x = (txtz >= -limx) & (txtz <= limx)
    in_y = (tytz >= -limy) & (tytz <= limy)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    # out of the limit the clamped coordinate is a constant (the CUDA
    # rasterizer's backward gates that gradient to zero)
    tx = (torch.clamp(txtz, -limx, limx) * tz).detach() + torch.where(
        in_x, t[..., 0] - t[..., 0].detach(), zero)
    ty = (torch.clamp(tytz, -limy, limy) * tz).detach() + torch.where(
        in_y, t[..., 1] - t[..., 1].detach(), zero)
    fx, fy = cam.focal_x, cam.focal_y
    j00, j02 = fx / tz, -(fx * tx) / (tz * tz)
    j11, j12 = fy / tz, -(fy * ty) / (tz * tz)
    W = view
    t0 = [j00 * W[0, k] + j02 * W[2, k] for k in range(3)]
    t1 = [j11 * W[1, k] + j12 * W[2, k] for k in range(3)]
    c0, c1, c2, c3, c4, c5 = cov3d
    V = ((c0, c1, c2), (c1, c3, c4), (c2, c4, c5))
    u0 = [t0[0] * V[0][k] + t0[1] * V[1][k] + t0[2] * V[2][k] for k in range(3)]
    u1 = [t1[0] * V[0][k] + t1[1] * V[1][k] + t1[2] * V[2][k] for k in range(3)]
    cxx = u0[0] * t0[0] + u0[1] * t0[1] + u0[2] * t0[2]
    cxy = u0[0] * t1[0] + u0[1] * t1[1] + u0[2] * t1[2]
    cyy = u1[0] * t1[0] + u1[1] * t1[1] + u1[2] * t1[2]
    return cxx + 0.3, cxy, cyy + 0.3


def preprocess(cam, xyz, scale, rotation, opacity, color, alive):
    """Per splat: (soa [N, 9] = mean x, mean y, conic a, b, c, r, g, b,
    opacity; depth [N]; radius [N] int, 0 where culled). ``scale`` and
    ``opacity`` activated, ``rotation`` any-norm wxyz, ``color`` [N, 3]."""
    W, H = cam.width, cam.height
    p_hom = xyz @ cam.full_proj[:, :3].T + cam.full_proj[:, 3]
    p_w = 1.0 / (p_hom[..., 3] + 1e-7)
    p = p_hom[..., :3] * p_w[..., None]
    depth = xyz @ cam.view[2, :3] + cam.view[2, 3]
    cxx, cxy, cyy = _cov2d(xyz, _cov3d(scale, rotation), cam)
    det = cxx * cyy - cxy * cxy
    ok_det = det != 0.0
    det_inv = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 1e-12)))
    mx = ((p[..., 0] + 1.0) * W - 1.0) * 0.5
    my = ((p[..., 1] + 1.0) * H - 1.0) * 0.5
    visible = (depth > 0.2) & ok_det & alive
    radius = torch.where(visible, radius, 0.0).to(torch.int64)
    soa = torch.stack([mx, my, cyy * det_inv, -cxy * det_inv, cxx * det_inv,
                       color[:, 0], color[:, 1], color[:, 2], opacity.reshape(-1)], dim=1)
    return soa, depth, radius


def sh0_color(features_dc):
    """Degree-0 spherical harmonics colour, +0.5 and clamped at 0."""
    return torch.clamp_min(C0 * features_dc.reshape(-1, 3) + 0.5, 0.0)


def tile_lists(mx, my, depth, radius, width: int, height: int):
    """Every (tile, splat) pair of the splats' tile rectangles, tile-major,
    front to back within a tile. Returns (splat [I] int64, starts [T + 1])."""
    ty, tx = (height + TILE - 1) // TILE, (width + TILE - 1) // TILE
    vis = radius > 0
    order = torch.argsort(torch.where(vis, depth, torch.full_like(depth, float("inf"))),
                          stable=True)
    ids = order[vis[order]]
    r = radius[ids].to(mx.dtype)
    x, y = mx[ids], my[ids]

    def cell(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int64)

    x0, y0 = cell((x - r) / TILE, tx), cell((y - r) / TILE, ty)
    x1, y1 = cell((x + r + TILE - 1) / TILE, tx), cell((y + r + TILE - 1) / TILE, ty)
    w = (x1 - x0).clamp_min(0)
    cnt = w * (y1 - y0).clamp_min(0)
    rep = torch.repeat_interleave(torch.arange(ids.shape[0], device=mx.device), cnt)
    local = torch.arange(rep.shape[0], device=mx.device) - (torch.cumsum(cnt, 0) - cnt)[rep]
    wr = w[rep]
    tile = (y0[rep] + torch.div(local, wr, rounding_mode="floor")) * tx + x0[rep] + local % wr
    o = torch.argsort(tile, stable=True)
    starts = torch.searchsorted(tile[o], torch.arange(ty * tx + 1, device=mx.device))
    return ids[rep[o]], starts


def _pixels(tiles, tx, dtype):
    lin = torch.arange(P, device=tiles.device)
    px = (tiles % tx)[:, None] * TILE + lin % TILE
    py = torch.div(tiles, tx, rounding_mode="floor")[:, None] * TILE + lin // TILE
    return px.to(dtype), py.to(dtype)


def _alphas(data, valid, px, py):
    """[t, L, P] alpha with the skip rule and the termination applied, and
    the inclusive product of (1 - alpha) over every kept entry."""
    dx = data[..., 0, None] - px[:, None, :]
    dy = data[..., 1, None] - py[:, None, :]
    a, b, c = data[..., 2, None], data[..., 3, None], data[..., 4, None]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    raw = data[..., 8, None] * torch.exp(torch.clamp_max(power, 0.0))
    # min(raw, 0.99) whose gradient passes the clamp, as the CUDA backward's
    alpha = torch.where(raw > ALPHA_MAX, ALPHA_MAX + (raw - raw.detach()), raw)
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & valid[..., None]
    alpha = torch.where(keep, alpha, 0.0)
    q = torch.cumprod(1.0 - alpha, dim=1)
    return torch.where(q >= T_EPS, alpha, 0.0), q, keep


def _blend_block(data, valid, px, py, bg):
    alpha, _, _ = _alphas(data, valid, px, py)
    t_incl = torch.cumprod(1.0 - alpha, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
    col = torch.einsum("tlp,tlc->tpc", alpha * t_excl, data[..., 5:8])
    t_fin = t_incl[:, -1]
    return col + t_fin[..., None] * bg, t_fin


def _blocks(starts):
    """Tiles grouped by list length: (tiles [t], list length L) per block."""
    counts = starts[1:] - starts[:-1]
    order = torch.argsort(counts, descending=True)
    c = counts[order].tolist()
    i, out = 0, []
    while i < len(c) and c[i] > 0:
        L = c[i]
        n = max(1, BLOCK_ELEMS // (L * P))
        out.append((order[i:i + n], L))
        i += n
    return out


def _gather(soa, splat, starts, tiles, L):
    s = starts[tiles]
    pos = s[:, None] + torch.arange(L, device=soa.device)
    valid = pos < starts[tiles + 1][:, None]
    idx = splat[torch.clamp_max(pos, splat.shape[0] - 1)]
    return soa[idx], valid


def blend(soa, depth, radius, width: int, height: int, bg, grad: bool = False):
    """The dense blend: (image [H, W, 3], t_final [H, W])."""
    ty, tx = (height + TILE - 1) // TILE, (width + TILE - 1) // TILE
    splat, starts = tile_lists(soa[:, 0].detach(), soa[:, 1].detach(), depth.detach(),
                               radius, width, height)
    img = bg.expand(ty * tx, P, 3).clone()
    tfin = torch.ones((ty * tx, P), dtype=soa.dtype, device=soa.device)
    for tiles, L in _blocks(starts):
        data, valid = _gather(soa, splat, starts, tiles, L)
        px, py = _pixels(tiles, tx, soa.dtype)
        if grad:
            c, t = checkpoint(_blend_block, data, valid, px, py, bg, use_reentrant=False)
        else:
            c, t = _blend_block(data, valid, px, py, bg)
        img = img.index_copy(0, tiles, c)
        tfin = tfin.index_copy(0, tiles, t)
    img = img.reshape(ty, tx, TILE, TILE, 3).permute(0, 2, 1, 3, 4).reshape(ty * TILE, tx * TILE, 3)
    tfin = tfin.reshape(ty, tx, TILE, TILE).permute(0, 2, 1, 3).reshape(ty * TILE, tx * TILE)
    return img[:height, :width], tfin[:height, :width]


@torch.no_grad()
def pair_counts(soa, depth, radius, width: int, height: int) -> dict:
    """The blend's data-dependent work: ``evaluated``, the (splat, pixel)
    pairs a front-to-back loop per pixel computes up to its termination,
    and ``blended``, those of them it blends (kept and before termination);
    with ``instances`` (tile, splat) pairs, ``visible`` splats and
    ``pixels``."""
    tx = (width + TILE - 1) // TILE
    splat, starts = tile_lists(soa[:, 0], soa[:, 1], depth, radius, width, height)
    evaluated = blended = 0
    for tiles, L in _blocks(starts):
        data, valid = _gather(soa, splat, starts, tiles, L)
        px, py = _pixels(tiles, tx, soa.dtype)
        alpha, q, _ = _alphas(data, valid, px, py)
        q_excl = torch.cat([torch.ones_like(q[:, :1]), q[:, :-1]], dim=1)
        evaluated += int(((q_excl >= T_EPS) & valid[..., None]).sum())
        blended += int((alpha > 0).sum())
    return {"evaluated": evaluated, "blended": blended, "instances": int(splat.shape[0]),
            "visible": int((radius > 0).sum()), "pixels": width * height}
