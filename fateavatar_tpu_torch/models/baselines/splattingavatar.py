"""SplattingAvatar baseline: a lifted UVD splat embedding on a walking mesh.

Port of ``fateavatar_tpu/models/baselines/splattingavatar.py``
(model/baseline/splattingavatar.py:40-904 of the reference). Splats live as
(face, barycentric, signed distance d) embeddings; posing blends per-vertex
quaternions from the canonical -> posed face frames, and the scaling follows
the face-area ratio. The in-plane (u, v) displacement accumulates in a
learnable ``uvd`` and a TRIANGLE WALK periodically commits it: it re-baries
the splats, crossing edges where needed (the reference's C++ walk,
submodules/simple_phongsurf, as a bounded barycentric ray walk over an edge
adjacency table: the JAX package's ``lax.scan`` of 16 steps is a loop of 16
steps on tensors here).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from fateavatar_tpu_torch.flame.flame import FlameModel, flame_forward
from fateavatar_tpu_torch.ops.camera import Camera
from fateavatar_tpu_torch.ops.gathers import gather_live_rows
from fateavatar_tpu_torch.ops.knn import mean_knn_distance
from fateavatar_tpu_torch.ops.mesh import (
    compute_vertex_normals,
    face_vertices,
    reweight_verts_by_barycoords,
    safe_normalize,
)
from fateavatar_tpu_torch.ops.quaternion import matrix_to_quat, quat_multiply
from fateavatar_tpu_torch.render.render import RenderConfig, render
from fateavatar_tpu_torch.render.splats import Gaussians, inverse_sigmoid

WALK_STEPS = 16


# ---------------------------------------------------------------------------
# per-vertex quaternions (splattingavatar.py:819-901)
# ---------------------------------------------------------------------------

def triangle_frames(tri: torch.Tensor) -> torch.Tensor:
    """TBN frame per triangle (splattingavatar.py:777-789): columns
    X = normalize(d x n), Y = normalize(d x X), Z = normalize(d), d = b - a."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    n = safe_normalize(torch.linalg.cross(b - a, c - a))
    d = b - a
    X = safe_normalize(torch.linalg.cross(d, n))
    Y = safe_normalize(torch.linalg.cross(d, X))
    Z = safe_normalize(d)
    return torch.stack([X, Y, Z], dim=-1)


def face_areas(verts, faces):
    """Triangle areas [F, 1] (this module's own cross product order)."""
    tri = face_vertices(verts, faces)
    n = torch.linalg.cross(tri[..., 2, :] - tri[..., 1, :], tri[..., 0, :] - tri[..., 1, :])
    return torch.linalg.norm(n, dim=-1, keepdim=True) / 2.0


def per_vert_quaternion(cano_verts, verts, faces, cano_face_areas):
    """Area-weighted blend of the per-face canonical -> posed rotations onto
    the vertices (splattingavatar.py:856-884), one ``index_add`` per corner."""
    R_cano = triangle_frames(face_vertices(cano_verts, faces))
    R_pose = triangle_frames(face_vertices(verts, faces))
    q_face = matrix_to_quat(R_pose @ R_cano.transpose(-1, -2))      # [F, 4]
    wq = cano_face_areas * q_face
    vq = verts.new_zeros((verts.shape[0], 4))
    for k in range(3):
        vq = vq.index_add(0, faces[:, k], wq)
    return vq / torch.linalg.norm(vq, dim=-1, keepdim=True).clamp_min(1e-6)


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SplatConfig:
    num_samples: int = 10000
    capacity: int = 60000
    img_height: int = 512
    img_width: int = 512
    percent_dense: float = 0.01


@dataclass
class SplatModel:
    flame: FlameModel
    faces: torch.Tensor            # [F, 3] int64
    cano_verts: torch.Tensor       # [V, 3]
    cano_norms: torch.Tensor       # [V, 3]
    cano_face_areas: torch.Tensor  # [F, 1]
    face_adjacency: torch.Tensor   # [F, 3] neighbour across each edge (-1 = border)
    bg_color: torch.Tensor
    cfg: SplatConfig


@dataclass
class SplatParams:
    uvd: torch.Tensor            # [N, 3] in-plane walk accumulation + normal offset
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor


@dataclass
class SplatState:
    sample_fidxs: torch.Tensor   # [N] int64
    sample_bary: torch.Tensor    # [N, 3]
    alive: torch.Tensor
    xyz_gradient_accum: torch.Tensor
    denom: torch.Tensor
    max_radii2d: torch.Tensor


def build_face_adjacency_table(faces: np.ndarray) -> np.ndarray:
    """[F, 3] neighbour face across edge k = (v_k, v_{k+1}); -1 on borders."""
    faces = np.asarray(faces)
    edge_map = {}
    adj = np.full((len(faces), 3), -1, np.int32)
    for fi, f in enumerate(faces):
        for k in range(3):
            e = (f[k], f[(k + 1) % 3])
            key = (min(e), max(e))
            if key in edge_map:
                fj, kj = edge_map[key]
                adj[fi, k] = fj
                adj[fj, kj] = fi
            else:
                edge_map[key] = (fi, k)
    return adj


def init_splattingavatar(flame: FlameModel, cfg: SplatConfig, bg_color=(1.0, 1.0, 1.0),
                         seed: int = 0):
    """Random barycentric samples over the canonical FLAME mesh (numpy,
    seeded: the JAX package's draws; splattingavatar.py:130-180, 725-741)
    and neutral splat attributes. On FLAME's device."""
    dev = flame.v_template.device
    cano_verts = flame_forward(flame, flame.canonical_exp, flame.canonical_pose)[0][0]
    faces = flame.faces
    ns, N = cfg.num_samples, cfg.capacity
    if N < ns:
        raise ValueError(f"capacity {N} must hold the {ns} samples")
    rng = np.random.default_rng(seed)
    fidxs = rng.integers(0, faces.shape[0], size=ns)
    b0 = rng.random(ns)
    b1 = rng.random(ns) * (1 - b0)
    bary = np.stack([b0, b1, 1 - b0 - b1], -1)
    perm = rng.permuted(np.tile(np.arange(3), (ns, 1)), axis=1)
    bary = np.take_along_axis(bary, perm, axis=1).astype(np.float32)
    fidxs = torch.as_tensor(fidxs, dtype=torch.int64, device=dev)
    bary = torch.as_tensor(bary, device=dev)
    scale_init = torch.log(torch.mean(mean_knn_distance(
        reweight_verts_by_barycoords(cano_verts, faces, fidxs, bary))))

    def cap(x, fill=0):
        return torch.cat([x, x.new_full((N - x.shape[0],) + tuple(x.shape[1:]), fill)])

    params = SplatParams(
        uvd=torch.zeros((N, 3), device=dev),
        features_dc=torch.zeros((N, 1, 3), device=dev),
        features_rest=torch.zeros((N, 1, 3), device=dev),
        scaling=scale_init.expand(N, 3).clone(),
        rotation=torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev).repeat(N, 1),
        opacity=inverse_sigmoid(torch.tensor(0.1, device=dev)).expand(N, 1).clone(),
    )
    state = SplatState(
        sample_fidxs=cap(fidxs),
        sample_bary=cap(bary),
        alive=cap(torch.ones((ns,), dtype=torch.bool, device=dev), False),
        xyz_gradient_accum=torch.zeros((N,), device=dev),
        denom=torch.zeros((N,), device=dev),
        max_radii2d=torch.zeros((N,), device=dev),
    )
    model = SplatModel(
        flame=flame, faces=faces, cano_verts=cano_verts,
        cano_norms=compute_vertex_normals(cano_verts, faces),
        cano_face_areas=face_areas(cano_verts, faces),
        face_adjacency=torch.as_tensor(build_face_adjacency_table(faces.cpu().numpy()),
                                       dtype=torch.int64, device=dev),
        bg_color=torch.tensor(bg_color, dtype=torch.float32, device=dev),
        cfg=cfg,
    )
    return model, params, state


def splat_forward(model: SplatModel, params: SplatParams, state: SplatState, expression,
                  flame_pose, camera: Camera, bg_color=None,
                  render_cfg: RenderConfig = RenderConfig(), means2d_probe=None):
    """splattingavatar.py:185-280: pose the mesh, blend per-vertex
    quaternions, area-ratio scaling, the normal offset uvd.z."""
    v = flame_forward(model.flame, expression[None], flame_pose[None])[0][0]
    faces = model.faces
    vert_norms = compute_vertex_normals(v, faces)
    vq = per_vert_quaternion(model.cano_verts, v, faces, model.cano_face_areas)
    area_ratio = (face_areas(v, faces) + 1e-4) / (model.cano_face_areas + 1e-4)

    # each face's corners, corner normals, corner quaternions and area ratio
    # in one [F, 31] table, one row gather per splat
    F = faces.shape[0]
    packed = torch.cat([v[faces].reshape(F, 9), vert_norms[faces].reshape(F, 9),
                        vq[faces].reshape(F, 12), area_ratio], 1)
    gp = gather_live_rows(packed, state.sample_fidxs, state.alive)
    bary = state.sample_bary
    base_xyz = torch.sum(bary[:, :, None] * gp[:, :9].reshape(-1, 3, 3), dim=-2)
    base_normal = safe_normalize(torch.sum(bary[:, :, None] * gp[:, 9:18].reshape(-1, 3, 3),
                                           dim=-2))
    base_quat = torch.einsum("nij,ni->nj", gp[:, 18:30].reshape(-1, 3, 4), bary)
    g_ratio = gp[:, 30:31]

    gaussians = Gaussians(
        xyz=base_xyz + base_normal * params.uvd[:, 2:3],
        scaling=params.scaling * g_ratio,
        rotation=quat_multiply(base_quat, params.rotation),
        opacity=params.opacity,
        features_dc=params.features_dc,
        features_rest=params.features_rest,
        alive=state.alive,
        sh_degree=0,
    )
    bg = model.bg_color if bg_color is None else bg_color
    out = render(camera, gaussians, bg, config=render_cfg, means2d_probe=means2d_probe)
    return {
        "rgb_image": out["render"],
        "scale": torch.exp(params.scaling),
        "alive": state.alive,
        "visibility_filter": out["visibility_filter"],
        "radii": out["radii"],
        "overflow": out["overflow"],
    }


# ---------------------------------------------------------------------------
# the triangle walk (submodules/simple_phongsurf's C++ walk in the reference)
# ---------------------------------------------------------------------------

def _solve_2x2(e1, e2, r):
    """(s, t) with the projection of r onto span(e1, e2) = s e1 + t e2, by
    the 2x2 Gram solve."""
    a11, a12, a22 = (torch.sum(x * y, -1) for x, y in ((e1, e1), (e1, e2), (e2, e2)))
    r1, r2 = torch.sum(r * e1, -1), torch.sum(r * e2, -1)
    det = (a11 * a22 - a12 * a12).clamp_min(1e-20)
    return (r1 * a22 - r2 * a12) / det, (r2 * a11 - r1 * a12) / det


@torch.no_grad()
def triangle_walk(verts: torch.Tensor, faces: torch.Tensor, adjacency: torch.Tensor,
                  fidxs: torch.Tensor, bary: torch.Tensor, delta: torch.Tensor,
                  max_steps: int = WALK_STEPS):
    """Walk surface points by an in-plane displacement, crossing edges.

    The barycentric ray walk of the JAX package (phongsurf_py3d.py:16,
    triangle_walk.cpp walkSurfacePoint): in the current triangle, express
    the remaining displacement (projected into its plane) as a barycentric
    direction; advance until a coordinate would go negative; cross that edge
    into the neighbour with the leftover displacement; stop at borders or
    when the step fits; at most ``max_steps`` steps. The exit edge is the
    first coordinate of the smallest exit step (``torch.argmin`` returns the
    first of equal minima, as ``jnp.argmin`` does; a row with no exit reads
    all ``inf`` and takes coordinate 0). Returns (new fidxs, new bary)."""
    tri_all = verts[faces]                                  # [F, 3, 3]
    f, b, d = fidxs, bary, delta
    active = torch.linalg.norm(delta, dim=-1) > 1e-9
    for _ in range(max_steps):
        tri = tri_all[f]                                    # [N, 3, 3]
        v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
        n = torch.linalg.cross(v1 - v0, v2 - v0)
        n_unit = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
        d_in = d - n_unit * torch.sum(d * n_unit, dim=-1, keepdim=True)
        s, t = _solve_2x2(v1 - v0, v2 - v0, d_in)
        db = torch.stack([-(s + t), s, t], dim=-1)          # d(bary)/d(step)

        # the largest step u in [0, 1] with b + u db >= 0
        with_dir = db < -1e-12
        u_max = torch.where(with_dir, -b / torch.where(with_dir, db, -1.0), torch.inf)
        u_exit = torch.amin(u_max, dim=-1)
        exit_coord = torch.argmin(u_max, dim=-1)
        u = torch.where(active, torch.clamp_max(u_exit, 1.0), 0.0)

        b_new = torch.clamp_min(b + u[:, None] * db, 0.0)
        b_new = b_new / torch.sum(b_new, dim=-1, keepdim=True).clamp_min(1e-12)
        d_left = d_in * (1.0 - u)[:, None]

        # coordinate c reaches 0 on the edge opposite vertex c; adjacency is
        # indexed by edge (v_k, v_k+1), opposite vertex k+2: edge (c + 1) % 3
        crossing = active & (u_exit < 1.0)
        neighbour = adjacency[f, (exit_coord + 1) % 3]
        can_cross = crossing & (neighbour >= 0)

        # the walked point's barycentrics in the (possibly new) triangle
        pos = torch.einsum("ni,nic->nc", b_new, verts[faces[f]])
        nf = torch.where(can_cross, neighbour, f)
        ntri = tri_all[nf]
        w0 = ntri[:, 0]
        bs, bt = _solve_2x2(ntri[:, 1] - w0, ntri[:, 2] - w0, pos - w0)
        nb = torch.clamp_min(torch.stack([1 - bs - bt, bs, bt], -1), 0.0)
        nb = nb / torch.sum(nb, -1, keepdim=True).clamp_min(1e-12)

        # inactive rows (zero delta, dead capacity) pass through untouched
        b = torch.where(active[:, None], nb, b)
        f = torch.where(active, nf, f)
        d = d_left
        active = can_cross & (torch.linalg.norm(d_left, dim=-1) > 1e-9)
    return f, b


def walking_on_triangles(model: SplatModel, params: SplatParams, state: SplatState):
    """Commit the accumulated in-plane uvd displacement
    (splattingavatar.py:668-696): walk by (u, v) along the canonical
    triangle's tangent axes X and Y, then zero uvd.xy. The caller zeros the
    uvd.xy Adam moments."""
    frames = triangle_frames(model.cano_verts[model.faces[state.sample_fidxs]])
    delta3d = frames[..., :, 0] * params.uvd[:, 0:1] + frames[..., :, 1] * params.uvd[:, 1:2]
    delta3d = torch.where(state.alive[:, None], delta3d, 0.0)
    new_f, new_b = triangle_walk(model.cano_verts, model.faces, model.face_adjacency,
                                 state.sample_fidxs, state.sample_bary, delta3d.detach())
    uvd = torch.cat([torch.zeros_like(params.uvd[:, :2]), params.uvd[:, 2:]], dim=1)
    return (dataclasses.replace(params, uvd=uvd),
            dataclasses.replace(state, sample_fidxs=new_f, sample_bary=new_b))
