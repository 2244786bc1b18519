"""FLAME head model: linear blend skinning.

Port of the forward part of ``fateavatar_tpu/flame/flame.py``
(``batch_rigid_transform``, ``lbs``, ``euler_xyz_matrix``,
``apply_world_transform``, ``flame_forward``), with the learned
personalization deltas (delta_shapedirs / delta_posedirs / delta_vertex),
the 68-point landmarks: static (``flame_landmarks``) and with the
yaw-binned jaw contour (``flame_landmarks_dynamic``), and the per-point
morphing of MonoGaussianAvatar (``forward_pts`` / ``inverse_pts``).

FLAME joint layout (5 joints): 0 root/global, 1 neck, 2 jaw, 3 left eye,
4 right eye. ``full_pose`` is [B, 15] axis-angle stacked in that order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from fateavatar_tpu_torch.ops.quaternion import axis_angle_to_matrix


@dataclass
class FlameModel:
    """Frozen FLAME assets, float32 unless noted.

    v_template already includes the subject's identity shape. ``parents`` is
    a tuple of ints (the kinematic chain is static).
    """

    v_template: torch.Tensor          # [V, 3]
    shapedirs: torch.Tensor           # [V, 3, n_shape + n_exp]
    posedirs: torch.Tensor            # [36, V*3]
    j_regressor: torch.Tensor         # [J, V]
    lbs_weights: torch.Tensor         # [V, J]
    parents: Tuple[int, ...]          # [J], parents[0] == -1
    faces: torch.Tensor               # [F, 3] int64
    n_shape: int
    n_exp: int
    canonical_exp: Optional[torch.Tensor] = None    # [1, n_exp]
    canonical_pose: Optional[torch.Tensor] = None   # [1, 15]
    # 68-point landmark embedding (FLAME.py:66-93): the static full-68 set
    # ordered [17 contour ++ 51 static], and the dynamic contour table
    # (79 yaw bins x 17 points, benchmark/nersemble/FLAME.py:213-260)
    lmk_faces_idx: Optional[torch.Tensor] = None            # [L] int64
    lmk_bary_coords: Optional[torch.Tensor] = None          # [L, 3]
    dynamic_lmk_faces_idx: Optional[torch.Tensor] = None    # [79, 17] int64
    dynamic_lmk_bary_coords: Optional[torch.Tensor] = None  # [79, 17, 3]

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]


def batch_rigid_transform(
    rot_mats: torch.Tensor, joints: torch.Tensor, parents
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-kinematic chain (flame/lbs.py:285-342).

    rot_mats [B, J, 3, 3], joints [B, J, 3] -> (posed_joints [B, J, 3],
    rel_transforms [B, J, 4, 4]).
    """
    parents = [int(p) for p in parents]
    B, J = joints.shape[:2]
    rel_joints = joints.clone()
    # parents one by one: an index list would be copied from the host, which
    # a CUDA graph cannot capture
    rel_joints[:, 1:] -= torch.stack([joints[:, p] for p in parents[1:]], dim=1)

    # the homogeneous row [0, 0, 0, 1], made on the device (no host copy, so
    # the forward can be captured in a CUDA graph)
    bot = rot_mats.new_zeros((B, 1, 4))
    bot[..., 3] = 1.0

    def tmat(R, t):
        return torch.cat([torch.cat([R, t[..., None]], dim=-1), bot], dim=-2)

    transforms = [tmat(rot_mats[:, 0], rel_joints[:, 0])]
    for j in range(1, J):
        transforms.append(transforms[parents[j]] @ tmat(rot_mats[:, j], rel_joints[:, j]))
    A = torch.stack(transforms, dim=1)                           # [B, J, 4, 4]

    posed_joints = A[:, :, :3, 3]
    # subtract the rest-pose joint contribution: rel = A - pad(A @ [j;0])
    joints_h = torch.cat([joints, joints.new_zeros((B, J, 1))], dim=-1)
    correction = torch.einsum("bjmn,bjn->bjm", A, joints_h)      # [B, J, 4]
    rel = A.clone()
    rel[:, :, :, 3] -= correction
    return posed_joints, rel


def lbs(
    betas: torch.Tensor,
    pose: torch.Tensor,
    v_template: torch.Tensor,
    shapedirs: torch.Tensor,
    posedirs: torch.Tensor,
    j_regressor: torch.Tensor,
    parents,
    lbs_weights: torch.Tensor,
):
    """Linear blend skinning (flame/lbs.py:24-100).

    betas [B, n_shape+n_exp], pose [B, J*3] axis-angle, v_template [B, V, 3]
    or [V, 3]. Returns (verts [B, V, 3], pose_feature [B, (J-1)*9],
    rel_transforms [B, J, 4, 4]).
    """
    B = max(betas.shape[0], pose.shape[0])
    if v_template.ndim == 2:
        v_template = v_template.expand((B,) + v_template.shape)

    v_shaped = v_template + torch.einsum("bl,mkl->bmk", betas, shapedirs)
    J = torch.einsum("bik,ji->bjk", v_shaped, j_regressor)

    rot_mats = axis_angle_to_matrix(pose.reshape(B, -1, 3))     # [B, J, 3, 3]
    ident = torch.eye(3, dtype=pose.dtype, device=pose.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)      # [B, 36]
    pose_offsets = (pose_feature @ posedirs).reshape(B, -1, 3)
    v_posed = v_shaped + pose_offsets

    _, A = batch_rigid_transform(rot_mats, J, parents)
    T = torch.einsum("vj,bjmn->bvmn", lbs_weights, A)            # [B, V, 4, 4]
    verts = torch.einsum("bvmn,bvn->bvm", T[:, :, :3, :3], v_posed) + T[:, :, :3, 3]
    return verts, pose_feature, A


def euler_xyz_matrix(euler: torch.Tensor) -> torch.Tensor:
    """Intrinsic-XYZ euler angles [..., 3] -> rotation matrices [..., 3, 3]
    (scipy 'XYZ' order, the NeRSemble tracking's model-to-world pose)."""
    cx, cy, cz = (torch.cos(euler[..., i]) for i in range(3))
    sx, sy, sz = (torch.sin(euler[..., i]) for i in range(3))
    zero = torch.zeros_like(cx)
    one = torch.ones_like(cx)
    rx = torch.stack([one, zero, zero,
                      zero, cx, -sx,
                      zero, sx, cx], -1).reshape(*cx.shape, 3, 3)
    ry = torch.stack([cy, zero, sy,
                      zero, one, zero,
                      -sy, zero, cy], -1).reshape(*cx.shape, 3, 3)
    rz = torch.stack([cz, -sz, zero,
                      sz, cz, zero,
                      zero, zero, one], -1).reshape(*cx.shape, 3, 3)
    return rx @ ry @ rz


def apply_world_transform(verts: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Model-to-world similarity of posed vertices. ``wt`` [B, 7] =
    (euler_xyz[3], translation[3], scale[1]); the scale multiplies the
    rotation block only."""
    R = euler_xyz_matrix(wt[:, :3]) * wt[:, 6][:, None, None]
    return torch.einsum("bvk,bjk->bvj", verts, R) + wt[:, None, 3:6]


def flame_forward(
    model: FlameModel,
    expression: torch.Tensor,
    full_pose: torch.Tensor,
    delta_shapedirs: Optional[torch.Tensor] = None,
    delta_posedirs: Optional[torch.Tensor] = None,
    delta_vertex: Optional[torch.Tensor] = None,
    world_transform: Optional[torch.Tensor] = None,
):
    """FLAME morphing with optional learned deltas. expression [B, n_exp],
    full_pose [B, 15], ``world_transform`` [B, 7] applied after posing.
    Returns (verts [B, V, 3], pose_feature, rel_transforms)."""
    B = expression.shape[0]
    betas = torch.cat(
        [expression.new_zeros((B, model.n_shape)), expression[:, : model.n_exp]],
        dim=1,
    )
    v_template = model.v_template
    if delta_vertex is not None:
        v_template = v_template + delta_vertex
    shapedirs = model.shapedirs
    if delta_shapedirs is not None:
        shapedirs = shapedirs + delta_shapedirs
    posedirs = model.posedirs
    if delta_posedirs is not None:
        posedirs = posedirs + delta_posedirs
    verts, pose_feature, A = lbs(
        betas, full_pose, v_template, shapedirs, posedirs,
        model.j_regressor, model.parents, model.lbs_weights,
    )
    if world_transform is not None:
        verts = apply_world_transform(verts, world_transform)
    return verts, pose_feature, A


def vertices2landmarks(vertices: torch.Tensor, faces: torch.Tensor,
                       lmk_faces_idx: torch.Tensor,
                       lmk_bary_coords: torch.Tensor) -> torch.Tensor:
    """Barycentric landmark extraction (flame/lbs.py:352-385).

    vertices [B, V, 3], faces [F, 3], lmk_faces_idx [L], lmk_bary [L, 3]
    -> [B, L, 3]."""
    lmk_verts = vertices[:, faces[lmk_faces_idx]]        # [B, L, 3, 3]
    return torch.einsum("blfk,lf->blk", lmk_verts, lmk_bary_coords)


def flame_landmarks(model: FlameModel, vertices: torch.Tensor) -> torch.Tensor:
    """68-point landmarks of already-posed FLAME vertices [B, V, 3]: the
    completion pipeline's keypoints, exact on the avatar's own mesh."""
    if model.lmk_faces_idx is None:
        raise ValueError("the FLAME model has no landmark embedding "
                         "(assets.landmark_embedding_path)")
    return vertices2landmarks(vertices, model.faces, model.lmk_faces_idx,
                              model.lmk_bary_coords)


def _neck_kin_chain(model: FlameModel, neck_idx: int = 1):
    """Joint chain neck -> root (FLAME.py:87-93)."""
    chain, cur = [], neck_idx
    while cur != -1:
        chain.append(cur)
        cur = model.parents[cur]
    return tuple(chain)


def rot_mat_to_euler_y(rot_mats: torch.Tensor) -> torch.Tensor:
    """Yaw angle from a rotation matrix (flame/lbs.py:344-350):
    atan2(-R[2,0], hypot(R[0,0], R[1,0]))."""
    sy = torch.sqrt(rot_mats[..., 0, 0] ** 2 + rot_mats[..., 1, 0] ** 2)
    return torch.atan2(-rot_mats[..., 2, 0], sy)


def find_dynamic_lmk_idx_and_bcoords(model: FlameModel, full_pose: torch.Tensor):
    """Yaw-binned jaw-contour selection (benchmark/nersemble/FLAME.py:213-260):
    the neck chain's rotations from ``full_pose`` [B, 15] composed, the
    relative yaw as a rounded degree bin clamped to [-39, 39] (negative yaws
    map to rows 40..78), and that row of the 79x17 contour table."""
    B = full_pose.shape[0]
    chain = _neck_kin_chain(model)
    aa = full_pose.reshape(B, -1, 3)[:, list(chain)]             # [B, C, 3]
    rot_mats = axis_angle_to_matrix(aa)                          # [B, C, 3, 3]
    rel = torch.eye(3, dtype=full_pose.dtype, device=full_pose.device).expand(B, 3, 3)
    for i in range(len(chain)):
        rel = rot_mats[:, i] @ rel
    return dynamic_lmk_rows_from_rot(model, rel)


def dynamic_lmk_rows_from_rot(model: FlameModel, rel: torch.Tensor):
    """Contour-row selection from a composed relative rotation [B, 3, 3]
    (a detector on an orbit render sees the camera azimuth as head yaw).
    Returns (faces [B, 17], bary [B, 17, 3])."""
    y_deg = torch.round(torch.clamp_max(
        -rot_mat_to_euler_y(rel) * 180.0 / math.pi, 39.0)).to(torch.int64)
    y_idx = torch.where(y_deg < 0, torch.where(y_deg < -39, 78, 39 - y_deg), y_deg)
    return model.dynamic_lmk_faces_idx[y_idx], model.dynamic_lmk_bary_coords[y_idx]


def flame_landmarks_dynamic(model: FlameModel, vertices: torch.Tensor,
                            full_pose: torch.Tensor) -> torch.Tensor:
    """68 landmarks with the yaw-dependent jaw contour: [17 dynamic contour
    ++ 51 static] per batch row (benchmark/nersemble/FLAME.py:319-325); the
    static full-68 set where the model has no dynamic table."""
    if model.dynamic_lmk_faces_idx is None:
        return flame_landmarks(model, vertices)
    B = vertices.shape[0]
    dyn_faces, dyn_bary = find_dynamic_lmk_idx_and_bcoords(model, full_pose)
    faces_idx = torch.cat([dyn_faces, model.lmk_faces_idx[-51:].expand(B, 51)], dim=1)
    bary = torch.cat([dyn_bary, model.lmk_bary_coords[-51:].expand(B, 51, 3)], dim=1)
    lmk_verts = vertices[torch.arange(B, device=vertices.device)[:, None, None],
                         model.faces[faces_idx]]                 # [B, 68, 3, 3]
    return torch.einsum("blfk,blf->blk", lmk_verts, bary)


# ---------------------------------------------------------------------------
# Per-point morphing (MonoGaussianAvatar path, flame/lbs.py:103-188)
# ---------------------------------------------------------------------------

def blend_shapes_pts(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """[N, S] x [N, 3, S] -> [N, 3] (lbs.py:210-230)."""
    return torch.einsum("ml,mkl->mk", betas, shape_disps)


def pose_correctives_pts(pose_feature: torch.Tensor, posedirs: torch.Tensor) -> torch.Tensor:
    """[N, 36] x [N, 36, 3] -> [N, 3] (lbs.py:232-235)."""
    return torch.einsum("mi,mik->mk", pose_feature, posedirs)


def _blend_transforms(transformations: torch.Tensor, lbs_weights: torch.Tensor):
    n, J = lbs_weights.shape
    return torch.einsum("mj,mjpq->mpq", lbs_weights, transformations.reshape(n, J, 4, 4))


def forward_skinning_pts(pnts: torch.Tensor, transformations: torch.Tensor,
                         lbs_weights: torch.Tensor) -> torch.Tensor:
    """Skin individual points with per-point joint weights (lbs.py:125-151)."""
    T = _blend_transforms(transformations, lbs_weights)
    return torch.einsum("mpq,mq->mp", T[:, :3, :3], pnts) + T[:, :3, 3]


def inverse_skinning_pts(pnts: torch.Tensor, transformations: torch.Tensor,
                         lbs_weights: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`forward_skinning_pts` (lbs.py:154-178). A blend of
    rigid transforms has the bottom row (0, 0, 0, s), s the weights' sum, so
    its inverse is [[A^-1, -A^-1 t / s], [0, 1 / s]]: A^-1 as the adjugate
    over the determinant, where the JAX package inverts the 4x4 by LU (the
    same value up to rounding; no solver call, so a CUDA graph can capture
    it)."""
    T = _blend_transforms(transformations, lbs_weights)
    A, t = T[:, :3, :3], T[:, :3, 3]
    c0, c1, c2 = A[:, :, 0], A[:, :, 1], A[:, :, 2]
    adj_t = torch.stack([torch.linalg.cross(c1, c2), torch.linalg.cross(c2, c0),
                         torch.linalg.cross(c0, c1)], dim=1)       # rows of adj(A)
    det = torch.sum(c0 * adj_t[:, 0], dim=-1)
    a_inv = adj_t / det[:, None, None]
    p = torch.einsum("mpq,mq->mp", a_inv, pnts)
    return p - torch.einsum("mpq,mq->mp", a_inv, t) / T[:, 3, 3:4]


def forward_pts(pnts_c, betas, transformations, pose_feature,
                shapedirs, posedirs, lbs_weights):
    """Canonical points -> posed points (lbs.py:103-121)."""
    pnts = pnts_c + blend_shapes_pts(betas, shapedirs)
    pnts = pnts + pose_correctives_pts(pose_feature, posedirs)
    return forward_skinning_pts(pnts, transformations, lbs_weights)


def inverse_pts(pnts_p, betas, transformations, pose_feature,
                shapedirs, posedirs, lbs_weights):
    """Posed points -> canonical points (lbs.py:180-188)."""
    pnts = inverse_skinning_pts(pnts_p, transformations, lbs_weights)
    pnts = pnts - blend_shapes_pts(betas, shapedirs)
    return pnts - pose_correctives_pts(pose_feature, posedirs)
