"""Triangle-mesh geometry ops used by ``init_fateavatar``,
``build_gaussians`` and the baselines.

Port of the corresponding part of ``fateavatar_tpu/ops/mesh.py``: face
frames and normals, vertex normals, face areas, barycentric reweighting,
``laplacian_smoothing`` and ``mesh_normal_consistency`` (the regularizers
of training) with its host-side ``build_face_adjacency``.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-20


def _dot(x, y):
    return torch.sum(x * y, dim=-1, keepdim=True)


def safe_normalize(x: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp_min(_dot(x, x), eps))


def _length(x, eps: float = _EPS):
    return torch.sqrt(torch.clamp_min(_dot(x, x), eps))


def face_vertices(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Per-face vertex coordinates: [..., V, C], [F, 3] -> [..., F, 3, C]."""
    return verts[..., faces, :]


def compute_face_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Unnormalized face normals (mesh_compute.py:27-36)."""
    fv = face_vertices(verts, faces)
    v0, v1, v2 = fv[..., 0, :], fv[..., 1, :], fv[..., 2, :]
    return torch.linalg.cross(v1 - v0, v2 - v0)


def compute_face_orientation(verts: torch.Tensor, faces: torch.Tensor,
                             return_scale: bool = False):
    """Orthonormal tangent frame per face + optional scale
    (mesh_compute.py:38-59): a0 = normalize(e0), a1 = normalize(a0 x e2),
    a2 = -normalize(a1 x a0); scale = (|e0| + |dot(a2, e2)|) / 2.
    Returns orientation [..., F, 3, 3] (columns a0, a1, a2)."""
    fv = face_vertices(verts, faces)
    v0, v1, v2 = fv[..., 0, :], fv[..., 1, :], fv[..., 2, :]

    a0 = safe_normalize(v1 - v0)
    a1 = safe_normalize(torch.linalg.cross(a0, v2 - v0))
    a2 = -safe_normalize(torch.linalg.cross(a1, a0))
    orientation = torch.stack([a0, a1, a2], dim=-1)

    if return_scale:
        s0 = _length(v1 - v0)
        s1 = torch.abs(_dot(a2, v2 - v0))
        return orientation, (s0 + s1) / 2.0
    return orientation, None


def compute_vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted unit vertex normals (mesh_compute.py:61-80): each face's
    unnormalized normal added to its three vertices (one ``index_add_`` per
    corner, as the JAX package adds them), (0, 0, 1) where the sum vanishes."""
    fn = compute_face_normals(verts, faces)                  # [..., F, 3]
    dim = verts.dim() - 2
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_add(dim, faces[:, k], fn)
    fallback = vn.new_tensor([0.0, 0.0, 1.0])
    vn = torch.where(_dot(vn, vn) > 1e-20, vn, fallback)
    return safe_normalize(vn)


def face_areas(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Triangle areas [..., F] (pytorch3d's mesh_face_areas_normals)."""
    return 0.5 * torch.linalg.norm(compute_face_normals(verts, faces), dim=-1)


def reweight_verts_by_barycoords(
    verts: torch.Tensor,
    faces: torch.Tensor,
    face_index: torch.Tensor,
    bary_coords: torch.Tensor,
) -> torch.Tensor:
    """Barycentric interpolation of per-vertex attributes onto N points:
    verts [..., V, C], faces [F, 3], face_index [N], bary [N, 3] -> [..., N, C]
    (mesh_sampling.py:171-200)."""
    fv = face_vertices(verts, faces)             # [..., F, 3, C]
    sampled = fv[..., face_index, :, :]          # [..., N, 3, C]
    return torch.sum(bary_coords[..., :, :, None] * sampled, dim=-2)


def reweight_uvcoords_by_barycoords(
    uvcoords: torch.Tensor,
    uvfaces: torch.Tensor,
    face_index: torch.Tensor,
    bary_coords: torch.Tensor,
) -> torch.Tensor:
    """UV-space variant returning homogeneous-extended UVs
    (mesh_sampling.py:202-234)."""
    ones = torch.ones(uvcoords.shape[:-1] + (1,), dtype=uvcoords.dtype,
                      device=uvcoords.device)
    uv_h = torch.cat([uvcoords, ones], dim=-1)
    return reweight_verts_by_barycoords(uv_h, uvfaces, face_index, bary_coords)


def laplacian_smoothing(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Uniform-graph Laplacian residual L @ verts, where L has -1 on the
    diagonal and 1/deg(i) for each neighbour (pytorch3d
    ``Meshes.laplacian_packed`` as train/loss.py:173 applies it). Every edge
    of every face counts, so an edge shared by two faces counts twice, as in
    the JAX package. Returns [..., V, 3] residuals."""
    # the edges (0, 1), (1, 2), (2, 0) of every face, by column slices (an
    # index list would be copied from the host, which a CUDA graph cannot
    # capture)
    a, b = faces, torch.roll(faces, -1, dims=1)
    src = torch.cat([a[:, 0], a[:, 1], a[:, 2], b[:, 0], b[:, 1], b[:, 2]])
    dst = torch.cat([b[:, 0], b[:, 1], b[:, 2], a[:, 0], a[:, 1], a[:, 2]])
    nv = verts.shape[-2]
    deg = torch.zeros((nv,), dtype=verts.dtype, device=verts.device).index_add_(
        0, src, torch.ones_like(src, dtype=verts.dtype))
    nbr_sum = torch.zeros_like(verts).index_add_(
        verts.dim() - 2, src, verts.index_select(verts.dim() - 2, dst))
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp_min(deg, 1.0), 0.0)
    return nbr_sum * inv_deg[:, None] - verts


def mesh_normal_consistency(verts: torch.Tensor, faces: torch.Tensor,
                            face_adjacency: torch.Tensor) -> torch.Tensor:
    """Mean (1 - cos) between the unit normals of face pairs sharing an edge
    (pytorch3d ``mesh_normal_consistency``, train/loss.py:187).
    ``face_adjacency`` [E, 2] holds the pairs, built once on the host by
    :func:`build_face_adjacency`."""
    n = safe_normalize(compute_face_normals(verts, faces))
    n0 = n.index_select(-2, face_adjacency[:, 0])
    n1 = n.index_select(-2, face_adjacency[:, 1])
    return torch.mean(1.0 - torch.sum(n0 * n1, dim=-1))


def build_face_adjacency(faces) -> np.ndarray:
    """Face pairs sharing an edge, [E, 2] int64 on the host, in the JAX
    package's order: for each face in turn, each edge (a, b), (b, c), (c, a)
    already seen pairs the face that saw it first with this one. A mesh with
    no shared edge gives [(0, 0)]."""
    faces = np.asarray(faces)
    edge_map = {}
    pairs = []
    for fi, (a, b, c) in enumerate(faces.tolist()):
        for e in ((a, b), (b, c), (c, a)):
            key = (min(e), max(e))
            if key in edge_map:
                pairs.append((edge_map[key], fi))
            else:
                edge_map[key] = fi
    if not pairs:
        pairs = [(0, 0)]
    return np.asarray(pairs, dtype=np.int64)
