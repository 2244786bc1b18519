"""Plain geometry of the reference: FLAME skinning, face frames, quaternions
and the pinhole camera.

A frozen copy of the port's plain code (``flame/flame.py``, ``ops/mesh.py``,
``ops/quaternion.py``, ``ops/camera.py``, ``flame/loader.make_flame``), which
follow the published FLAME (lbs.py) and 3DGS camera conventions. It imports
nothing of the port. Every function works in the dtype of its inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Flame:
    v_template: torch.Tensor     # [V, 3]
    shapedirs: torch.Tensor      # [V, 3, n_shape + n_exp]
    posedirs: torch.Tensor       # [36, V*3]
    j_regressor: torch.Tensor    # [J, V]
    lbs_weights: torch.Tensor    # [V, J]
    parents: tuple
    faces: torch.Tensor          # [F, 3] int64
    n_shape: int
    n_exp: int
    canonical_exp: torch.Tensor  # [1, n_exp]
    canonical_pose: torch.Tensor  # [1, 15]


def make_flame(data: dict, n_shape: int, n_exp: int, canonical_pose: float, device,
               dtype=torch.float32) -> Flame:
    """The FLAME of the pickle ``data``: shapedirs sliced to the first
    ``n_shape`` shape columns and ``n_exp`` expression columns from column
    300, posedirs as [36, V*3], no identity shape, a zero canonical
    expression and the jaw opened by ``canonical_pose``."""
    sd = data["shapedirs"]
    exp_start = 300 if sd.shape[-1] > 300 else n_shape
    shapedirs = np.concatenate([sd[:, :, :n_shape], sd[:, :, exp_start:exp_start + n_exp]], 2)
    posedirs = data["posedirs"].reshape(-1, data["posedirs"].shape[-1]).T
    parents = data["kintree_table"][0].astype(np.int64).copy()
    parents[0] = -1
    cpose = np.zeros((1, 15), np.float32)
    cpose[0, 6] = canonical_pose

    def t(x, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(x), device=device).to(dt)

    return Flame(v_template=t(data["v_template"]), shapedirs=t(shapedirs),
                 posedirs=t(posedirs), j_regressor=t(data["J_regressor"]),
                 lbs_weights=t(data["weights"]), parents=tuple(int(p) for p in parents),
                 faces=t(data["f"], torch.int64), n_shape=n_shape, n_exp=n_exp,
                 canonical_exp=t(np.zeros((1, n_exp), np.float32)), canonical_pose=t(cpose))


def axis_angle_to_matrix(aa, eps: float = 1e-8):
    angle = torch.linalg.norm(aa + eps, dim=-1, keepdim=True)
    axis = aa / angle
    rx, ry, rz = axis.unbind(-1)
    z = torch.zeros_like(rx)
    k = torch.stack([z, -rz, ry, rz, z, -rx, -ry, rx, z], -1).reshape(aa.shape[:-1] + (3, 3))
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + sin * k + (1.0 - cos) * (k @ k)


def _rigid_transforms(rot_mats, joints, parents):
    """Relative joint transforms [B, J, 4, 4] of the kinematic chain."""
    B, J = joints.shape[:2]
    rel = joints.clone()
    rel[:, 1:] -= torch.stack([joints[:, p] for p in parents[1:]], dim=1)
    bot = rot_mats.new_zeros((B, 1, 4))
    bot[..., 3] = 1.0

    def tmat(R, t):
        return torch.cat([torch.cat([R, t[..., None]], dim=-1), bot], dim=-2)

    chain = [tmat(rot_mats[:, 0], rel[:, 0])]
    for j in range(1, J):
        chain.append(chain[parents[j]] @ tmat(rot_mats[:, j], rel[:, j]))
    A = torch.stack(chain, dim=1)
    joints_h = torch.cat([joints, joints.new_zeros((B, J, 1))], dim=-1)
    out = A.clone()
    out[:, :, :, 3] -= torch.einsum("bjmn,bjn->bjm", A, joints_h)
    return out


def flame_forward(fl: Flame, expression, pose, delta_shapedirs=None, delta_posedirs=None,
                  delta_vertex=None):
    """Posed vertices [B, V, 3] of expression [B, n_exp] and pose [B, 15]
    (linear blend skinning), with the personalization deltas where given."""
    return flame_lbs(fl, expression, pose, delta_shapedirs, delta_posedirs, delta_vertex)[0]


def flame_lbs(fl: Flame, expression, pose, delta_shapedirs=None, delta_posedirs=None,
              delta_vertex=None):
    """(posed vertices [B, V, 3], pose feature [B, 36], joint transforms
    [B, J, 4, 4]) of :func:`flame_forward`."""
    B = expression.shape[0]
    betas = torch.cat([expression.new_zeros((B, fl.n_shape)), expression[:, :fl.n_exp]], 1)
    v_t = fl.v_template if delta_vertex is None else fl.v_template + delta_vertex
    sd = fl.shapedirs if delta_shapedirs is None else fl.shapedirs + delta_shapedirs
    pd = fl.posedirs if delta_posedirs is None else fl.posedirs + delta_posedirs
    v_shaped = v_t[None] + torch.einsum("bl,mkl->bmk", betas, sd)
    J = torch.einsum("bik,ji->bjk", v_shaped, fl.j_regressor)
    rot = axis_angle_to_matrix(pose.reshape(B, -1, 3))
    ident = torch.eye(3, dtype=pose.dtype, device=pose.device)
    feat = (rot[:, 1:] - ident).reshape(B, -1)
    v_posed = v_shaped + (feat @ pd).reshape(B, -1, 3)
    A = _rigid_transforms(rot, J, fl.parents)
    T = torch.einsum("vj,bjmn->bvmn", fl.lbs_weights, A)
    verts = torch.einsum("bvmn,bvn->bvm", T[:, :, :3, :3], v_posed) + T[:, :, :3, 3]
    return verts, feat, A


def _normalize(x, eps=1e-20):
    return x / torch.sqrt(torch.clamp_min(torch.sum(x * x, -1, keepdim=True), eps))


def face_frames(verts, faces):
    """Per face: the orthonormal frame [F, 3, 3] (columns a0, a1, a2), the
    scale [F, 1] and the unnormalized normal [F, 3]."""
    fv = verts[faces]
    v0, v1, v2 = fv[:, 0], fv[:, 1], fv[:, 2]
    a0 = _normalize(v1 - v0)
    a1 = _normalize(torch.linalg.cross(a0, v2 - v0))
    a2 = -_normalize(torch.linalg.cross(a1, a0))
    e0 = v1 - v0
    s0 = torch.sqrt(torch.clamp_min(torch.sum(e0 * e0, -1, keepdim=True), 1e-20))
    s1 = torch.abs(torch.sum(a2 * (v2 - v0), -1, keepdim=True))
    normal = torch.linalg.cross(v1 - v0, v2 - v0)
    return torch.stack([a0, a1, a2], -1), (s0 + s1) / 2.0, normal


def matrix_to_quat(m):
    """Rotation matrices -> wxyz quaternions (w >= 0), the largest of the
    four candidate leading terms."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], -1)], -2)
    lead = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22,
                        1.0 + m22 - m00 - m11], -1)
    best = torch.argmax(lead, dim=-1, keepdim=True)
    q = torch.take_along_dim(cands, best[..., None], dim=-2).squeeze(-2)
    q = q / (2.0 * torch.sqrt(torch.take_along_dim(lead, best, dim=-1).clamp_min(1e-8)))
    q = torch.where(q[..., :1] < 0, -q, q)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-8)


def quat_multiply(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def laplacian(verts, faces):
    """Uniform-graph Laplacian residual of ``verts`` [V, 3]: every edge of
    every face counts (an edge of two faces twice)."""
    a, b = faces, torch.roll(faces, -1, dims=1)
    src = torch.cat([a[:, 0], a[:, 1], a[:, 2], b[:, 0], b[:, 1], b[:, 2]])
    dst = torch.cat([b[:, 0], b[:, 1], b[:, 2], a[:, 0], a[:, 1], a[:, 2]])
    nv = verts.shape[-2]
    deg = torch.zeros((nv,), dtype=verts.dtype, device=verts.device).index_add_(
        0, src, torch.ones_like(src, dtype=verts.dtype))
    nbr = torch.zeros_like(verts).index_add_(0, src, verts[dst])
    inv = torch.where(deg > 0, 1.0 / torch.clamp_min(deg, 1.0), 0.0)
    return nbr * inv[:, None] - verts


def camera_t(R, T, fovx: float, fovy: float, width: int, height: int,
             znear: float = 0.01, zfar: float = 100.0) -> "Cam":
    """:func:`camera` with the translation ``T`` a tensor [3] the camera is
    differentiable in (the tracked rows' camera); ``R`` host."""
    dt, dev = T.dtype, T.device
    Rv = torch.as_tensor(np.asarray(R, np.float64).T, device=dev).to(dt)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev, dtype=dt)
    view = torch.cat([torch.cat([Rv, T[:, None]], 1), bottom], 0)
    tx, ty = np.tan(np.float32(fovx) / 2.0), np.tan(np.float32(fovy) / 2.0)
    P = np.zeros((4, 4))
    P[0, 0], P[1, 1] = 1.0 / tx, 1.0 / ty
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    P = torch.as_tensor(P, device=dev).to(dt)
    return Cam(view=view, full_proj=P @ view, campos=-Rv.T @ T, tan_fovx=float(tx),
               tan_fovy=float(ty), width=width, height=height)


@dataclass
class Cam:
    view: torch.Tensor       # [4, 4] world -> view
    full_proj: torch.Tensor  # [4, 4] world -> clip
    campos: torch.Tensor     # [3]
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tan_fovy)


def camera(R, T, fovx: float, fovy: float, width: int, height: int, device,
           znear: float = 0.01, zfar: float = 100.0, dtype=torch.float32) -> Cam:
    """The 3DGS camera of rotation ``R`` (camera to world) and translation
    ``T`` (world to view), built in float64 and cast to ``dtype``."""
    R = np.asarray(R, np.float64)
    view = np.eye(4)
    view[:3, :3] = R.T
    view[:3, 3] = np.asarray(T, np.float64)
    tx, ty = np.tan(np.float32(fovx) / 2.0), np.tan(np.float32(fovy) / 2.0)
    P = np.zeros((4, 4))
    P[0, 0] = 1.0 / tx
    P[1, 1] = 1.0 / ty
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0

    def t(x):
        return torch.as_tensor(x, device=device).to(dtype)

    return Cam(view=t(view), full_proj=t(P @ view), campos=t(-view[:3, :3].T @ view[:3, 3]),
               tan_fovx=float(tx), tan_fovy=float(ty), width=width, height=height)
