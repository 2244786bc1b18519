"""Debug mesh rasterizer — the training snapshots' FLAME-mesh overlay.

Port of ``fateavatar_tpu/render/mesh_render.py`` (the nvdiffrast panel of
the reference, mesh_rendering/__init__.py:218-278, train/trainer.py:501) in
plain torch: project the vertices, shade each face by its normal, and for
each chunk of faces test the pixels of each face's ``span`` x ``span``
window, interpolate depth barycentrically and keep the nearest face per
pixel with a scatter-min z-buffer. Built for snapshot frequency, not the hot
path.
"""

from __future__ import annotations

import torch

from fateavatar_tpu_torch.ops.camera import Camera
from fateavatar_tpu_torch.ops.mesh import compute_face_normals


def render_mesh(
    verts: torch.Tensor,       # [V, 3] world space
    faces: torch.Tensor,       # [F, 3]
    camera: Camera,
    width: int,
    height: int,
    face_chunk: int = 256,
    span: int = 64,
    light_dir=(0.0, 0.0, 1.0),
    base_color=(0.75, 0.75, 0.75),
):
    """Front-lit shaded render + alpha mask. Faces project to at most a
    ``span`` x ``span`` pixel window (larger faces are clipped — fine for
    debug overlays of dense head meshes).

    Returns (rgb [H, W, 3], alpha [H, W])."""
    dev = verts.device
    inf = torch.tensor(float("inf"), device=dev)
    hom = verts @ camera.full_proj[:, :3].T + camera.full_proj[:, 3]
    w = hom[:, 3:4] + 1e-7
    ndc = hom[:, :3] / w
    px = ((ndc[:, 0] + 1) * width - 1) * 0.5
    py = ((ndc[:, 1] + 1) * height - 1) * 0.5
    depth = verts @ camera.view[2, :3] + camera.view[2, 3]

    n = compute_face_normals(verts, faces)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    ld = torch.tensor(light_dir, dtype=torch.float32, device=dev)
    ld = ld / torch.linalg.norm(ld)
    shade = torch.abs(n @ ld) * 0.8 + 0.2
    color = shade[:, None] * torch.tensor(base_color, dtype=torch.float32, device=dev)

    tri_x, tri_y, tri_z = px[faces], py[faces], depth[faces]      # [F, 3]
    valid_face = ~torch.any(tri_z <= 0.01, dim=-1)

    hw = height * width
    zbuf = torch.full((height, width), float("inf"), device=dev)
    rgb = torch.zeros((height, width, 3), device=dev)
    s = torch.arange(span, device=dev)
    oy, ox = torch.meshgrid(s, s, indexing="ij")                 # [span, span]

    for c0 in range(0, faces.shape[0], face_chunk):
        cx, cy, cz = tri_x[c0:c0 + face_chunk], tri_y[c0:c0 + face_chunk], tri_z[c0:c0 + face_chunk]
        ccol, cvalid = color[c0:c0 + face_chunk], valid_face[c0:c0 + face_chunk]
        x0 = torch.floor(cx.min(dim=-1).values).to(torch.int64).clamp(0, width - 1)
        y0 = torch.floor(cy.min(dim=-1).values).to(torch.int64).clamp(0, height - 1)
        pxs = x0[:, None, None] + ox[None]                        # [C, span, span]
        pys = y0[:, None, None] + oy[None]
        fx, fy = pxs.to(torch.float32), pys.to(torch.float32)

        x1, y1 = cx[:, 0, None, None], cy[:, 0, None, None]
        x2, y2 = cx[:, 1, None, None], cy[:, 1, None, None]
        x3, y3 = cx[:, 2, None, None], cy[:, 2, None, None]
        det = (y2 - y3) * (x1 - x3) + (x3 - x2) * (y1 - y3)
        det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
        l1 = ((y2 - y3) * (fx - x3) + (x3 - x2) * (fy - y3)) / det
        l2 = ((y3 - y1) * (fx - x3) + (x1 - x3) * (fy - y3)) / det
        l3 = 1.0 - l1 - l2
        inside = (l1 >= 0) & (l2 >= 0) & (l3 >= 0)
        inside &= (pxs < width) & (pys < height)
        inside &= cvalid[:, None, None]

        z = (l1 * cz[:, 0, None, None] + l2 * cz[:, 1, None, None]
             + l3 * cz[:, 2, None, None])
        z = torch.where(inside, z, inf)
        flat_idx = torch.where(inside, pys * width + pxs, hw).reshape(-1)
        zflat = z.reshape(-1)

        # z-buffer via scatter-min, then the colour where this chunk won
        zb = torch.full((hw + 1,), float("inf"), device=dev).scatter_reduce(
            0, flat_idx, zflat, reduce="amin")
        zb2 = zb[:-1].reshape(height, width)
        new_zbuf = torch.minimum(zbuf, zb2)
        at = flat_idx.clamp(0, hw - 1)
        won = (inside & (z <= zb2.reshape(-1)[at].reshape(z.shape))
               & (z <= new_zbuf.reshape(-1)[at].reshape(z.shape)))
        col = ccol[:, None, None, :].expand(*z.shape, 3)
        closer = new_zbuf < zbuf
        rgb_new = rgb.clone()
        for ch in range(3):
            chan = torch.zeros((hw + 1,), device=dev).scatter_reduce(
                0, flat_idx, torch.where(won, col[..., ch], 0.0).reshape(-1), reduce="amax")
            rgb_new[..., ch] = torch.where(closer, chan[:-1].reshape(height, width),
                                           rgb_new[..., ch])
        zbuf, rgb = new_zbuf, rgb_new
    alpha = torch.isfinite(zbuf).to(torch.float32)
    return rgb, alpha


def overlay_mesh(image, verts, faces, camera, opacity: float = 0.6):
    """Blend a mesh render over an image (the snapshot overlay panel,
    train/trainer.py:496-507). ``image`` [H, W, 3] (numpy or tensor)."""
    image = torch.as_tensor(image, dtype=torch.float32, device=verts.device)
    h, w = image.shape[:2]
    rgb, alpha = render_mesh(verts, faces, camera, w, h)
    a = alpha[..., None] * opacity
    return image * (1 - a) + rgb * a
