"""Minimal Wavefront OBJ reading and writing (host side, numpy).

Copy of ``fateavatar_tpu/utils/obj_io.py``'s ``load_obj``, ``save_obj`` and
``sphere_obj_mesh``: v/vt/f with ``v/vt`` face syntax — enough for the FLAME
head template with UVs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ObjMesh:
    verts: np.ndarray          # [V, 3] float32
    faces: np.ndarray          # [F, 3] int32 (vertex indices)
    uvcoords: np.ndarray       # [Vt, 2] float32 (may be empty)
    uvfaces: np.ndarray        # [F, 3] int32 (uv indices, may be empty)


def load_obj(path: str) -> ObjMesh:
    verts, uvs, faces, uvfaces = [], [], [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                toks = line.split()[1:]
                # triangulate fan for polygons
                def parse(tok):
                    parts = tok.split("/")
                    vi = int(parts[0]) - 1
                    ti = int(parts[1]) - 1 if len(parts) > 1 and parts[1] else -1
                    return vi, ti

                parsed = [parse(t) for t in toks]
                for i in range(1, len(parsed) - 1):
                    faces.append([parsed[0][0], parsed[i][0], parsed[i + 1][0]])
                    uvfaces.append([parsed[0][1], parsed[i][1], parsed[i + 1][1]])
    return ObjMesh(
        verts=np.asarray(verts, np.float32),
        faces=np.asarray(faces, np.int32),
        uvcoords=np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32),
        uvfaces=np.asarray(uvfaces, np.int32) if uvs else np.zeros((0, 3), np.int32),
    )


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def sphere_obj_mesh(n_verts: int = 256, seed: int = 0) -> ObjMesh:
    """Synthetic UV-unwrapped sphere mesh for tests: spherical UV chart."""
    idx = np.arange(n_verts, dtype=np.float64)
    phi = np.arccos(1.0 - 2.0 * (idx + 0.5) / n_verts)
    theta = np.pi * (1.0 + 5.0**0.5) * idx
    pts = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=-1,
    ) * 0.1

    from scipy.spatial import ConvexHull

    hull = ConvexHull(pts)
    faces = hull.simplices.astype(np.int32)
    tri = pts[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    c = tri.mean(axis=1)
    flip = (n * c).sum(-1) < 0
    faces[flip] = faces[flip][:, ::-1]

    # simple spherical UVs (not seam-correct; fine for sampling tests)
    u = (np.arctan2(pts[:, 1], pts[:, 0]) / (2 * np.pi) + 0.5) * 0.98 + 0.01
    v = (pts[:, 2] / 0.1 * 0.5 + 0.5) * 0.98 + 0.01
    uv = np.stack([u, v], axis=-1).astype(np.float32)
    return ObjMesh(
        verts=pts.astype(np.float32),
        faces=faces,
        uvcoords=uv,
        uvfaces=faces.copy(),
    )
