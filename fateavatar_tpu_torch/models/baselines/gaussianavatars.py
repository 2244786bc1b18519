"""GaussianAvatars baseline: rigged 3D Gaussians, one splat per FLAME face.

Port of ``fateavatar_tpu/models/baselines/gaussianavatars.py``
(model/baseline/gaussianavatars.py:19-498 of the reference). Splat
positions are learned LOCAL coordinates in each bound face's tangent frame;
the 3DGS clone / split / prune with binding bookkeeping is masked writes at
a static capacity:

* clone (gaussianavatars.py:298-352): grad >= threshold and small scale ->
  copied into free slots, same binding;
* split (gaussianavatars.py:354-417): grad >= threshold and large scale ->
  two samples from N(0, scale) rotated into the local frame, scale / 1.6,
  the original killed;
* prune (gaussianavatars.py:419-466): low opacity or oversized splats, but
  never the LAST splat bound to a face.

The split's normal draws come from a ``torch.Generator``
(:func:`split_draws`), or are given, so a test can feed ``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from fateavatar_tpu_torch.flame.flame import FlameModel, flame_forward
from fateavatar_tpu_torch.ops.camera import Camera
from fateavatar_tpu_torch.ops.gathers import gather_live_rows
from fateavatar_tpu_torch.ops.mesh import compute_face_orientation, face_vertices
from fateavatar_tpu_torch.ops.quaternion import matrix_to_quat, quat_multiply, quat_to_matrix
from fateavatar_tpu_torch.render.render import RenderConfig, render
from fateavatar_tpu_torch.render.splats import Gaussians, inverse_sigmoid


@dataclass(frozen=True)
class GAConfig:
    sh_degree: int = 3
    capacity: int = 200_000
    img_height: int = 512
    img_width: int = 512
    percent_dense: float = 0.01


@dataclass
class GAModel:
    flame: FlameModel
    bg_color: torch.Tensor
    cfg: GAConfig


@dataclass
class GAParams:
    xyz: torch.Tensor            # [N, 3] LOCAL face-frame coordinates
    features_dc: torch.Tensor    # [N, 1, 3]
    features_rest: torch.Tensor  # [N, K-1, 3]
    scaling: torch.Tensor        # [N, 3] log (local units)
    rotation: torch.Tensor       # [N, 4] wxyz (local)
    opacity: torch.Tensor        # [N, 1] logit


@dataclass
class GAState:
    binding: torch.Tensor             # [N] int64 face index
    alive: torch.Tensor               # [N] bool
    xyz_gradient_accum: torch.Tensor  # [N]
    denom: torch.Tensor               # [N]
    max_radii2d: torch.Tensor         # [N]


SPLAT_FIELDS = tuple(f.name for f in dataclasses.fields(GAParams))


def _cap(x: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    return torch.cat([x, x.new_full((n - x.shape[0],) + tuple(x.shape[1:]), fill)])


def init_gaussianavatars(flame: FlameModel, cfg: GAConfig, bg_color=(1.0, 1.0, 1.0),
                         seed: int = 0):
    """One splat per FLAME face, a random dim colour (numpy, seeded: the JAX
    package's draws), unit local scale (gaussianavatars.py:99-128). On
    FLAME's device."""
    dev = flame.v_template.device
    F = flame.faces.shape[0]
    N = cfg.capacity
    if N < F:
        raise ValueError(f"capacity {N} must hold one splat per face ({F})")
    rng = np.random.default_rng(seed)
    k = (cfg.sh_degree + 1) ** 2
    fdc = torch.as_tensor(rng.random((F, 1, 3)) / 255.0, dtype=torch.float32, device=dev)
    params = GAParams(
        xyz=torch.zeros((N, 3), device=dev),
        features_dc=_cap(fdc, N),
        features_rest=torch.zeros((N, max(k - 1, 1), 3), device=dev),
        scaling=torch.zeros((N, 3), device=dev),           # log(1) local units
        rotation=torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev).repeat(N, 1),
        opacity=inverse_sigmoid(torch.tensor(0.1, device=dev)).expand(N, 1).clone(),
    )
    state = GAState(
        binding=_cap(torch.arange(F, device=dev), N),
        alive=_cap(torch.ones((F,), dtype=torch.bool, device=dev), N, False),
        xyz_gradient_accum=torch.zeros((N,), device=dev),
        denom=torch.zeros((N,), device=dev),
        max_radii2d=torch.zeros((N,), device=dev),
    )
    model = GAModel(flame=flame, bg_color=torch.tensor(bg_color, dtype=torch.float32,
                                                       device=dev), cfg=cfg)
    return model, params, state


def build_gaussians(model: GAModel, params: GAParams, state: GAState, expression,
                    flame_pose, active_sh_degree: int):
    """Local -> world splats (gaussianavatars.py:140-172): xyz_world =
    R_face @ xyz_local * face_scale + face_center. Returns (gaussians, face
    scales)."""
    verts, _, _ = flame_forward(model.flame, expression[None], flame_pose[None])
    v = verts[0]
    faces = model.flame.faces
    face_center = face_vertices(v, faces).mean(dim=-2)
    face_orien, face_scaling = compute_face_orientation(v, faces, return_scale=True)
    face_quat = matrix_to_quat(face_orien)

    # every face quantity in one [F, 17] table, one row gather per splat
    F = face_orien.shape[0]
    packed = torch.cat([face_orien.reshape(F, 9), face_scaling, face_center, face_quat], 1)
    gp = gather_live_rows(packed, state.binding, state.alive)
    g_orien, g_scale = gp[:, :9].reshape(-1, 3, 3), gp[:, 9:10]
    g_center, g_quat = gp[:, 10:13], gp[:, 13:17]
    xyz = torch.einsum("nij,nj->ni", g_orien, params.xyz) * g_scale + g_center
    rot = quat_multiply(g_quat, params.rotation)
    scaling = params.scaling + torch.log(torch.clamp_min(g_scale, 1e-12))
    return Gaussians(
        xyz=xyz, scaling=scaling, rotation=rot, opacity=params.opacity,
        features_dc=params.features_dc, features_rest=params.features_rest,
        alive=state.alive, sh_degree=active_sh_degree,
    ), face_scaling


def ga_forward(model: GAModel, params: GAParams, state: GAState, expression, flame_pose,
               camera: Camera, active_sh_degree: int = 0, bg_color=None,
               render_cfg: RenderConfig = RenderConfig(), means2d_probe=None):
    gaussians, _ = build_gaussians(model, params, state, expression, flame_pose,
                                   active_sh_degree)
    bg = model.bg_color if bg_color is None else bg_color
    out = render(camera, gaussians, bg, config=render_cfg, means2d_probe=means2d_probe)
    return {
        "rgb_image": out["render"],
        "scale": torch.exp(params.scaling),
        "xyz": params.xyz,
        "alive": state.alive,
        "viewspace_points": out["viewspace_points"],
        "visibility_filter": out["visibility_filter"],
        "radii": out["radii"],
        "overflow": out["overflow"],
    }


# ---------------------------------------------------------------------------
# densification (static capacity)
# ---------------------------------------------------------------------------

def _select_slots(mask: torch.Tensor, budget: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``budget`` indices where ``mask`` holds (a stable sort, as
    jnp.argsort is), the rest of the budget pointing past the end (n): those
    writes are dropped."""
    n = mask.shape[0]
    budget = min(budget, n)
    order = torch.argsort((~mask).to(torch.int8), stable=True)   # True first
    idx = order[:budget]
    valid = torch.arange(budget, device=mask.device) < torch.sum(mask)
    return torch.where(valid, idx, n), valid


def _set_rows(arr: torch.Tensor, dst: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``arr.at[dst].set(vals, mode="drop")``: rows at ``dst`` = n go to a
    scratch row that is cut off."""
    n = arr.shape[0]
    out = torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])
    out[dst] = vals.to(arr.dtype)
    return out[:n]


def _rows(arr: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``arr[src]`` with the out-of-range index n clamped (its rows are
    written nowhere)."""
    return arr[src.clamp_max(arr.shape[0] - 1)]


def _copy_rows(params: GAParams, src, dst, new_xyz=None, new_scaling=None) -> GAParams:
    override = {"xyz": new_xyz, "scaling": new_scaling}
    return dataclasses.replace(params, **{
        f: _set_rows(v, dst, _rows(v, src) if override.get(f) is None else override[f])
        for f, v in ((f, getattr(params, f)) for f in SPLAT_FIELDS)})


def split_draws(generator: torch.Generator, budget: int, n: int):
    """The split's two [budget // 2, 3] standard-normal draws."""
    half = min(budget, n) // 2
    dev = generator.device
    return tuple(torch.randn((half, 3), generator=generator, device=dev) for _ in range(2))


def densify_and_prune(params: GAParams, state: GAState, max_grad: float, min_opacity: float,
                      extent: float, max_screen_size: Optional[float] = None,
                      budget: int = 8192, percent_dense: float = 0.01, noise=None,
                      generator: Optional[torch.Generator] = None):
    """Clone + split + prune (gaussianavatars.py:275-466). ``budget`` caps
    the new splats of one call. ``noise``: the split's two normal draws
    (:func:`split_draws`), else drawn from ``generator``. Returns (params,
    state, touched)."""
    n = state.alive.shape[0]
    budget = min(budget, n)
    grads = torch.nan_to_num(state.xyz_gradient_accum
                             / torch.clamp_min(state.denom, 1e-12))
    big_grad = (grads >= max_grad) & state.alive
    max_scale = torch.amax(torch.exp(params.scaling), dim=1)
    touched = torch.zeros((n,), dtype=torch.bool, device=grads.device)

    # ---- clone: small splats are duplicated in place
    clone_mask = big_grad & (max_scale <= percent_dense * extent)
    src_c, valid_c = _select_slots(clone_mask, budget)
    dst_c, free_ok = _select_slots(~state.alive, budget)
    write_c = valid_c & free_ok
    dst_c = torch.where(write_c, dst_c, n)
    params = _copy_rows(params, src_c, dst_c)
    alive = _set_rows(state.alive, dst_c, write_c)
    binding = _set_rows(state.binding, dst_c, _rows(state.binding, src_c))
    touched = _set_rows(touched, dst_c, write_c)

    # ---- split: large splats -> 2 resampled children, the original killed
    split_mask = big_grad & (max_scale > percent_dense * extent)
    half = budget // 2
    src_s, valid_s = _select_slots(split_mask, half)
    if noise is None:
        noise = split_draws(generator, budget, n)
    scaling_s = _rows(params.scaling, src_s)
    R = quat_to_matrix(_rows(params.rotation, src_s))
    xyz_s = _rows(params.xyz, src_s)
    for z in noise:
        dst, free = _select_slots(~alive, half)
        write = valid_s & free
        dst = torch.where(write, dst, n)
        child_xyz = torch.einsum("nij,nj->ni", R, z * torch.exp(scaling_s)) + xyz_s
        child_scaling = scaling_s - math.log(0.8 * 2)
        params = _copy_rows(params, src_s, dst, new_xyz=child_xyz, new_scaling=child_scaling)
        alive = _set_rows(alive, dst, write)
        binding = _set_rows(binding, dst, _rows(binding, src_s))
        touched = _set_rows(touched, dst, write)
    # kill the split originals (only those selected within the budget)
    killed = _set_rows(torch.zeros_like(alive), src_s, valid_s)
    alive = alive & ~killed

    # ---- prune
    prune = torch.sigmoid(params.opacity[:, 0]) < min_opacity
    if max_screen_size is not None:
        prune = prune | (state.max_radii2d > max_screen_size) | (max_scale > 0.1 * extent)
    prune = prune & alive
    # the binding guard: each face keeps its last splat (gaussianavatars.py:421-425)
    counter = torch.zeros((n,), dtype=torch.int32, device=alive.device).index_add_(
        0, binding, alive.to(torch.int32))
    prune_counter = torch.zeros_like(counter).index_add_(0, binding, prune.to(torch.int32))
    prune = prune & ((counter - prune_counter) > 0)[binding]
    alive = alive & ~prune

    new_state = dataclasses.replace(
        state, binding=binding, alive=alive,
        xyz_gradient_accum=torch.zeros_like(state.xyz_gradient_accum),
        denom=torch.zeros_like(state.denom),
        max_radii2d=torch.zeros_like(state.max_radii2d))
    return params, new_state, touched


def reset_opacity(params: GAParams) -> GAParams:
    cur = torch.sigmoid(params.opacity)
    return dataclasses.replace(params, opacity=inverse_sigmoid(torch.clamp_max(cur, 0.01)))


def expon_lr_schedule(lr_init, lr_final, max_steps, lr_delay_mult=1.0, lr_delay_steps=0):
    """The 3DGS xyz learning-rate schedule (tools/gs_utils/general_utils.py:29),
    a function of the host's step count."""

    def schedule(step):
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
        else:
            delay = 1.0
        t = min(max(step / max_steps, 0.0), 1.0)
        return delay * math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)

    return schedule
