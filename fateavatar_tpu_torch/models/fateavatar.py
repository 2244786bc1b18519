"""FateAvatar: FLAME-rigged Gaussian head avatar with UV-sampled splats.

Port of ``fateavatar_tpu/models/fateavatar.py`` (config, containers,
``init_fateavatar``, ``build_gaussians``, ``fateavatar_forward``,
``fateavatar_inference``, ``fateavatar_visualization``). The model splits into three containers:

* :class:`FateAvatarModel`  — frozen assets + static config,
* :class:`FateAvatarParams` — trainable tensors (per-splat attributes at
  static capacity + FLAME personalization deltas),
* :class:`FateAvatarState`  — non-trainable state (splat binding, alive mask,
  densification statistics).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from fateavatar_tpu_torch.flame.flame import FlameModel, flame_forward
from fateavatar_tpu_torch.ops import sampling
from fateavatar_tpu_torch.ops.camera import Camera, make_camera
from fateavatar_tpu_torch.ops.gathers import gather_rows
from fateavatar_tpu_torch.ops.knn import mean_knn_distance
from fateavatar_tpu_torch.ops.mesh import (
    compute_face_normals,
    compute_face_orientation,
    reweight_uvcoords_by_barycoords,
    reweight_verts_by_barycoords,
)
from fateavatar_tpu_torch.ops.quaternion import (
    matrix_to_quat,
    quat_multiply,
    quat_to_axis_angle,
)
from fateavatar_tpu_torch.ops.sh import rgb_to_sh
from fateavatar_tpu_torch.render.render import RenderConfig, render
from fateavatar_tpu_torch.render.splats import Gaussians, inverse_sigmoid
from fateavatar_tpu_torch.utils.obj_io import ObjMesh


@dataclass(frozen=True)
class FateAvatarConfig:
    tex_size: int = 256
    normal_offset: float = 0.05
    delta_blendshape: bool = True
    delta_vertex: bool = True
    resize_scale: bool = True
    sh_degree: int = 0
    capacity: int = 200_000
    img_height: int = 512
    img_width: int = 512


@dataclass
class FateAvatarModel:
    """Frozen assets (reference model/fateavatar.py:96-194)."""

    flame: FlameModel
    faces: torch.Tensor                   # [F, 3] int64 (template == FLAME topology)
    uvcoords: torch.Tensor                # [Vt, 2]
    uvfaces: torch.Tensor                 # [F, 3] int64
    face_scaling_canonical: torch.Tensor  # [F, 1]
    uvcoords_sample: torch.Tensor         # [N, 2] UV of each initial splat
    mean_scaling: torch.Tensor            # [] knn init stats
    max_scaling: torch.Tensor
    scale_init: torch.Tensor
    bg_color: torch.Tensor                # [3]
    cfg: FateAvatarConfig


@dataclass
class FateAvatarParams:
    """Trainable tensors (fateavatar.py:166-194 + 87-94)."""

    offset: torch.Tensor           # [N, 1]  normal offset (tanh-activated)
    features_dc: torch.Tensor      # [N, 1, 3]
    features_rest: torch.Tensor    # [N, K-1, 3]
    scaling: torch.Tensor          # [N, 3] log scale
    rotation: torch.Tensor         # [N, 4] wxyz
    opacity: torch.Tensor          # [N, 1] logit
    delta_shapedirs: torch.Tensor  # [V, 3, S]
    delta_posedirs: torch.Tensor   # [36, V*3]
    delta_vertex: torch.Tensor     # [V, 3]


@dataclass
class FateAvatarState:
    """Non-trainable state (splat binding + densify stats)."""

    face_index: torch.Tensor          # [N] int64
    bary_coords: torch.Tensor         # [N, 3]
    alive: torch.Tensor               # [N] bool
    xyz_gradient_accum: torch.Tensor  # [N]
    denom: torch.Tensor               # [N]
    sample_flag: torch.Tensor         # [N]
    max_radii2d: torch.Tensor         # [N]


def init_fateavatar(
    template: ObjMesh,
    flame: FlameModel,
    cfg: FateAvatarConfig,
    bg_color=(1.0, 1.0, 1.0),
    seed: int = 0,
    device="cuda",
):
    """Build model/params/state the way FateAvatar.__init__ does
    (fateavatar.py:39-194): UV-uniform sampling of tex_size^2 splats on the
    template chart (numpy, seeded), KNN scale init, neutral attribute init,
    canonical face scales. ``flame`` must live on ``device``."""
    if template.verts.shape[0] != flame.num_verts:
        raise ValueError("template topology must match FLAME")
    n_init = cfg.tex_size * cfg.tex_size
    N = cfg.capacity
    if N < n_init:
        raise ValueError("capacity must hold the initial UV samples")

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=device)

    faces = t(template.faces, torch.int64)
    uvcoords = t(template.uvcoords)
    uvfaces = t(template.uvfaces, torch.int64)
    face_index_np, bary_np = sampling.uniform_sampling_barycoords(
        n_init, template.uvcoords, template.uvfaces, seed=seed)
    face_index = t(face_index_np, torch.int64)
    bary = t(bary_np)

    uv_sample = reweight_uvcoords_by_barycoords(
        uvcoords, uvfaces, face_index, bary)[..., :2]
    verts_sampling = reweight_verts_by_barycoords(
        t(template.verts), faces, face_index, bary)

    # scale init from mean 1-NN distance (fateavatar.py:596-608)
    mean_scaling = torch.mean(mean_knn_distance(verts_sampling))
    max_scaling = 10.0 * mean_scaling
    scale_init = torch.log(mean_scaling)

    # canonical face scale (fateavatar.py:84-85)
    cano_verts, _, _ = flame_forward(flame, flame.canonical_exp, flame.canonical_pose)
    _, face_scaling_cano = compute_face_orientation(
        cano_verts[0], faces, return_scale=True)

    k = (cfg.sh_degree + 1) ** 2

    def cap(x, fill=0):
        pad = x.new_full((N - x.shape[0],) + tuple(x.shape[1:]), fill)
        return torch.cat([x, pad])

    params = FateAvatarParams(
        offset=torch.zeros((N, 1), device=device),
        # logit(0.5) == 0 -> renders 0.5 grey through SH deg 0 (+0.5 shift)
        features_dc=torch.zeros((N, 1, 3), device=device),
        # at least one rest column even for sh_degree 0, as in the JAX
        # package; eval_sh never reads past (deg+1)^2 coefficients
        features_rest=torch.zeros((N, max(k - 1, 1), 3), device=device),
        scaling=scale_init.expand(N, 3).clone(),
        rotation=t([[1.0, 0.0, 0.0, 0.0]]).repeat(N, 1),
        opacity=inverse_sigmoid(t(0.1)).expand(N, 1).clone(),
        delta_shapedirs=torch.zeros_like(flame.shapedirs),
        delta_posedirs=torch.zeros_like(flame.posedirs),
        delta_vertex=torch.zeros_like(flame.v_template),
    )
    state = FateAvatarState(
        face_index=cap(face_index),
        bary_coords=cap(bary),
        alive=cap(torch.ones((n_init,), dtype=torch.bool, device=device), False),
        xyz_gradient_accum=torch.zeros((N,), device=device),
        denom=torch.zeros((N,), device=device),
        sample_flag=torch.zeros((N,), device=device),
        max_radii2d=torch.zeros((N,), device=device),
    )
    model = FateAvatarModel(
        flame=flame,
        faces=faces,
        uvcoords=uvcoords,
        uvfaces=uvfaces,
        face_scaling_canonical=face_scaling_cano,
        uvcoords_sample=cap(uv_sample),
        mean_scaling=mean_scaling,
        max_scaling=max_scaling,
        scale_init=scale_init,
        bg_color=t(bg_color),
        cfg=cfg,
    )
    return model, params, state


def bind_splats(model: FateAvatarModel, expression: torch.Tensor, flame_pose: torch.Tensor,
                face_index: torch.Tensor, bary_coords: torch.Tensor,
                delta_shapedirs: torch.Tensor, delta_posedirs: torch.Tensor,
                delta_vertex: torch.Tensor, world_transform: Optional[torch.Tensor] = None):
    """FLAME LBS (with the personalization deltas the config enables) and
    each splat's face frame: verts -> per-face frame/scale/normal -> one row
    gather per splat -> barycentric position. ``world_transform`` [7]
    (euler xyz, translation, scale) applies the NeRSemble tracking's
    model-to-world similarity to the posed vertices of both FLAME passes
    (benchmark/nersemble/fateavatar.py:206-230). Returns (pos [N, 3], face
    quaternion [N, 4], face normal [N, 3], face scale ratio [N, 1], verts,
    verts_orig)."""
    cfg = model.cfg
    wt = None if world_transform is None else world_transform[None]
    verts, _, _ = flame_forward(
        model.flame, expression[None], flame_pose[None],
        delta_shapedirs=delta_shapedirs if cfg.delta_blendshape else None,
        delta_posedirs=delta_posedirs if cfg.delta_blendshape else None,
        delta_vertex=delta_vertex if cfg.delta_vertex else None,
        world_transform=wt,
    )
    verts_orig, _, _ = flame_forward(model.flame, expression[None], flame_pose[None],
                                     world_transform=wt)
    v = verts[0]

    face_orien, face_scaling = compute_face_orientation(v, model.faces, return_scale=True)
    face_normals = compute_face_normals(v, model.faces)

    # every face-level quantity packed into ONE [F, 17] table, gathered per
    # splat in one row gather
    ratio = face_scaling / model.face_scaling_canonical       # [F, 1]
    face_quat = matrix_to_quat(face_orien)                    # [F, 4]
    tri = v[model.faces]                                      # [F, 3, 3]
    F = tri.shape[0]
    face_packed = torch.cat([
        face_quat, face_normals, ratio, tri.reshape(F, 9),
    ], dim=1)                                                 # [F, 17]
    gp = gather_rows(face_packed, face_index)                 # [N, 17]
    tri_n = gp[:, 8:17].reshape(-1, 3, 3)
    pos = torch.einsum("nk,nkd->nd", bary_coords, tri_n)      # [N, 3]
    return pos, gp[:, 0:4], gp[:, 4:7], gp[:, 7:8], verts, verts_orig


def build_gaussians(
    model: FateAvatarModel,
    params: FateAvatarParams,
    state: FateAvatarState,
    expression: torch.Tensor,   # [n_exp]
    flame_pose: torch.Tensor,   # [15]
    world_transform: Optional[torch.Tensor] = None,   # [7] model-to-world
):
    """FLAME-drive the splats (FateAvatar.forward, fateavatar.py:210-258):
    :func:`bind_splats` (with the optional model-to-world transform), then
    the shell offset along the face normal, quaternion compose, and the
    log-scale shift by the face scale ratio. Returns (gaussians, verts,
    verts_orig)."""
    cfg = model.cfg
    pos, g_quat, g_normal, g_ratio, verts, verts_orig = bind_splats(
        model, expression, flame_pose, state.face_index, state.bary_coords,
        params.delta_shapedirs, params.delta_posedirs, params.delta_vertex,
        world_transform=world_transform)

    xyz = pos + g_normal * cfg.normal_offset * torch.tanh(params.offset)
    rot = quat_multiply(g_quat, params.rotation)
    scaling = params.scaling
    if cfg.resize_scale:
        scaling = scaling + torch.log(torch.clamp_min(g_ratio, 1e-12))

    gaussians = Gaussians(
        xyz=xyz,
        scaling=scaling,
        rotation=rot,
        opacity=params.opacity,
        features_dc=params.features_dc,
        features_rest=params.features_rest,
        alive=state.alive,
        sh_degree=cfg.sh_degree,
    )
    return gaussians, verts, verts_orig


def fateavatar_forward(
    model: FateAvatarModel,
    params: FateAvatarParams,
    state: FateAvatarState,
    expression: torch.Tensor,
    flame_pose: torch.Tensor,
    camera: Camera,
    bg_color: Optional[torch.Tensor] = None,
    render_cfg: RenderConfig = RenderConfig(),
    means2d_probe: Optional[torch.Tensor] = None,
    world_transform: Optional[torch.Tensor] = None,
):
    """One frame forward (fateavatar.py:196-295). Returns the output dict:
    rgb_image [H,W,3], scale, raw_rot, viewspace_points, visibility_filter,
    radii, overflow, verts, verts_orig, faces, alive. ``means2d_probe`` is
    passed to :func:`render` (the densification signal of training);
    ``world_transform`` [7] to :func:`build_gaussians`."""
    bg = model.bg_color if bg_color is None else bg_color
    gaussians, verts, verts_orig = build_gaussians(
        model, params, state, expression, flame_pose, world_transform=world_transform)
    out = render(camera, gaussians, bg, config=render_cfg,
                 means2d_probe=means2d_probe)
    return {
        "rgb_image": out["render"],
        "scale": torch.exp(params.scaling),
        "raw_rot": quat_to_axis_angle(params.rotation),
        "viewspace_points": out["viewspace_points"],
        "visibility_filter": out["visibility_filter"],
        "radii": out["radii"],
        "overflow": out["overflow"],
        "verts": verts,
        "verts_orig": verts_orig,
        "faces": model.faces,
        "alive": state.alive,
    }


def fateavatar_inference(
    model, params, state, expression, flame_pose, camera,
    render_cfg: RenderConfig = RenderConfig(),
):
    """GUI/reenactment path (fateavatar.py:297-366): same forward, image only."""
    return fateavatar_forward(
        model, params, state, expression, flame_pose, camera,
        render_cfg=render_cfg,
    )["rgb_image"]


@torch.no_grad()
def fateavatar_visualization(
    model, params, state, expression, flame_pose, camera: Camera,
    render_cfg: RenderConfig = RenderConfig(),
):
    """Diagnostic renders (fateavatar.py:368-594): posed, canonical-pose
    (front camera), densification-sample highlight, gradient heat. Each goes
    through :func:`render`."""
    dev = params.offset.device
    out = fateavatar_forward(model, params, state, expression, flame_pose, camera,
                             render_cfg=render_cfg)

    # canonical camera: identity-ish frontal view at the same distance
    R_cano = torch.tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]], device=dev)
    T_cano = camera.view[:3, 3] * torch.tensor([0.0, 0.0, 1.0], device=dev)
    cam_cano = make_camera(R_cano, T_cano, camera.fovx, camera.fovy,
                           camera.width, camera.height, device=dev)

    gaussians_cano, _, _ = build_gaussians(
        model, params, state,
        model.flame.canonical_exp[0], model.flame.canonical_pose[0])
    cano_img = render(cam_cano, gaussians_cano, model.bg_color, config=render_cfg)

    # gradient heat: densification pressure as red intensity (fateavatar.py:505-538)
    grad_accum = torch.nan_to_num(
        state.xyz_gradient_accum / torch.clamp_min(state.denom, 1e-6))
    thresh = torch.quantile(grad_accum, 0.95)
    below = grad_accum <= thresh
    denom = torch.clamp_min(torch.max(torch.where(below, grad_accum, 0.0)), 1e-12)
    norm_grad = torch.where(below, grad_accum / denom, 1.0)
    zero = torch.zeros_like(norm_grad)
    red = torch.stack([0.99 * norm_grad, zero, zero], dim=-1)
    grad_gaussians = dataclasses.replace(
        gaussians_cano, features_dc=rgb_to_sh(red)[:, None, :],
        opacity=params.opacity + 5.0)
    grad_img = render(cam_cano, grad_gaussians, torch.zeros(3, device=dev),
                      config=render_cfg)

    # densification-sample highlight (fateavatar.py:540-563)
    sampled = state.sample_flag > 0.5
    blue = (180 / 255 - 0.5) / 0.282 * torch.tensor([0.0, 0.0, 1.0], device=dev)
    point_gaussians = dataclasses.replace(
        gaussians_cano,
        features_dc=blue.expand(gaussians_cano.features_dc.shape[0], 3)[:, None, :],
        opacity=torch.ones_like(params.opacity) + 5.0,
        scaling=-torch.ones_like(params.scaling) * 8.0,
        alive=state.alive & sampled)
    point_img = render(cam_cano, point_gaussians, model.bg_color, config=render_cfg)

    return {
        "rgb_image": out["rgb_image"],
        "cano_image": cano_img["render"],
        "grad_image": grad_img["render"],
        "point_image": point_img["render"],
        "scale": out["scale"],
        "raw_rot": out["raw_rot"],
        "verts": out["verts"],
        "faces": model.faces,
    }
