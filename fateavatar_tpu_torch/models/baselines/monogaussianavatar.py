"""MonoGaussianAvatar baseline: a point-MLP Gaussian head avatar.

Port of ``fateavatar_tpu/models/baselines/monogaussianavatar.py``
(model/baseline/monogaussianavatar.py:19-883 of the reference). A learnable
point cloud (sphere-initialized, growing 400 -> 100k points) carries no
per-splat attributes: MLPs predict everything —

* :class:`GeometryNetwork` (8x256, softplus(100), skip at 3, PE-6): colour
  feature, scale, rotation, opacity (monogaussianavatar.py:569-658);
* :class:`ForwardDeformer` (4x128): per-point blendshapes, posedirs, lbs
  weights (softmax x 20) and a canonical offset (:784-869);
* :class:`GaussianNetwork` (2x64): deformation-conditioned attribute
  offsets (:717-782);
* :class:`RenderingNetwork`: registered, never called in the forward, as
  in the reference.

Points morph with FLAME's per-point inverse / forward path
(``flame.inverse_pts`` / ``forward_pts``). Each network's weights live in
``MonoParams`` as a dict of tensors by the module's parameter names
(``dense.k`` for flax's ``Dense_k``), applied with
``torch.func.functional_call``. The epoch-level prune / upsample is static
capacity maintenance (:func:`prune_and_upsample`); its draws come from a
``torch.Generator`` (:func:`upsample_draws`) or are given.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from fateavatar_tpu_torch.flame import flame as flame_mod
from fateavatar_tpu_torch.flame.flame import FlameModel, flame_forward
from fateavatar_tpu_torch.models.baselines.flashavatar import (
    dense_stack,
    net_weights,
    positional_encoding,
)
from fateavatar_tpu_torch.ops.camera import Camera
from fateavatar_tpu_torch.render.render import RenderConfig, render
from fateavatar_tpu_torch.render.splats import Gaussians


def softplus100(x):
    """Softplus with beta 100 (sharp, as the reference uses throughout)."""
    return F.softplus(100.0 * x) / 100.0


class GeometryNetwork(nn.Module):
    """monogaussianavatar.py:569-658 (weight norm omitted, init simplified,
    as in the JAX package). ``dense`` in flax's naming order: the trunk's
    ``depth - 1`` layers (0-6), then each head's outer layer before its
    inner one (colour 7 <- 8 <- 9, scales 10 <- 11, rotations 12 <- 13,
    opacity 14 <- 15)."""

    def __init__(self, multires: int = 6, width: int = 256, depth: int = 8,
                 skip_at: int = 3, device=None, generator=None):
        super().__init__()
        self.multires, self.skip_at, self.depth = multires, skip_at, depth
        d_in = 3 * (1 + 2 * multires) if multires > 0 else 3
        trunk = []
        cin = d_in
        for lvl in range(depth - 1):
            if lvl == skip_at:
                cin += d_in
            trunk.append((cin, width))
            cin = width
        heads = [(width, 3), (width, width), (width, width), (width, 3), (width, width),
                 (width, 4), (width, width), (width, 1), (width, width)]
        self.dense = dense_stack(trunk + heads, device, generator)

    def forward(self, pts):
        inp = positional_encoding(pts, self.multires) if self.multires > 0 else pts
        d = self.dense
        x = inp
        for lvl in range(self.depth - 1):
            if lvl == self.skip_at:
                x = torch.cat([x, inp], dim=-1) / np.sqrt(2.0)
            x = softplus100(d[lvl](x))
        h = self.depth - 1
        color = d[h](d[h + 1](softplus100(d[h + 2](x))))
        scales, rots, opacity = (d[h + k](softplus100(d[h + k + 1](x))) for k in (3, 5, 7))
        return color, scales, rots, opacity


class GaussianNetwork(nn.Module):
    """Offset-conditioned attribute deltas (monogaussianavatar.py:717-782).
    ``dense``: the trunk 0-1, then scale 2 <- 3, rotation 4 <- 5, opacity
    6 <- 7, colour 8 <- 9."""

    def __init__(self, width: int = 64, device=None, generator=None):
        super().__init__()
        heads = []
        for out in (3, 4, 1, 3):
            heads += [(width, out), (width, width)]
        self.dense = dense_stack([(3, width), (width, width)] + heads, device, generator)

    def forward(self, offset):
        d = self.dense
        x = torch.relu(d[1](torch.relu(d[0](offset))))
        scale, rot, opacity, color = (d[k](torch.relu(d[k + 1](x))) for k in (2, 4, 6, 8))
        return scale, rot, opacity, color


class RenderingNetwork(nn.Module):
    """Normal-conditioned colour net (monogaussianavatar.py:662-713),
    registered for parity; the reference never calls it in the forward."""

    def __init__(self, width: int = 64, device=None, generator=None):
        super().__init__()
        self.dense = dense_stack([(3, width), (width, width), (width, 3)], device, generator)

    def forward(self, normals):
        x = torch.relu(self.dense[1](torch.relu(self.dense[0](normals))))
        return torch.sigmoid(self.dense[2](x))


class ForwardDeformer(nn.Module):
    """Per-point blendshape / skinning predictor (monogaussianavatar.py:784-864).
    The blendshape (``dense.4``) and skinning (``dense.6``) heads start at
    zero, so training starts from FLAME's skinning with uniform weights."""

    def __init__(self, n_exp: int, width: int = 128, depth: int = 4,
                 ghostbone: bool = True, deform_c: bool = True, device=None, generator=None):
        super().__init__()
        self.n_exp, self.depth, self.deform_c = n_exp, depth, deform_c
        d_out = 36 * 3 + n_exp * 3 + (3 if deform_c else 0)
        shapes = ([(3, width)] + [(width, width)] * (depth - 1)
                  + [(width, d_out), (width, width), (width, 6 if ghostbone else 5)])
        self.dense = dense_stack(shapes, device, generator, zero=(depth, depth + 2))

    def forward(self, pts):
        x = pts
        for lvl in range(self.depth):
            x = softplus100(self.dense[lvl](x))
        blend = self.dense[self.depth](x)
        skin = self.dense[self.depth + 2](softplus100(self.dense[self.depth + 1](x)))
        lbs_weights = torch.softmax(20.0 * skin, dim=-1)
        posedirs = blend[:, :36 * 3].reshape(-1, 36, 3)
        shapedirs = blend[:, 36 * 3:36 * 3 + self.n_exp * 3].reshape(-1, 3, self.n_exp)
        pnts_c_flame = pts + blend[:, -3:] if self.deform_c else pts
        return shapedirs, posedirs, lbs_weights, pnts_c_flame


@dataclass(frozen=True)
class MonoConfig:
    n_init_points: int = 400
    max_points: int = 100_000
    prune_thresh: float = 0.1
    cam_scale: float = 3.0    # insta
    scene_scale: float = 1.0
    img_height: int = 512
    img_width: int = 512
    ghostbone: bool = True


@dataclass
class MonoModel:
    flame: FlameModel
    canonical_pose_feature: torch.Tensor     # [1, 36]
    canonical_transformations: torch.Tensor  # [1, J(+1), 4, 4] (ghost bone first)
    canonical_verts: torch.Tensor            # [V, 3]
    bg_color: torch.Tensor
    cfg: MonoConfig


@dataclass
class MonoParams:
    points: torch.Tensor       # [N_max, 3]
    geometry: dict             # each network's weights by name
    deformer: dict
    gaussian: dict
    rendering: dict


@dataclass
class MonoState:
    alive: torch.Tensor        # [N_max] bool
    visible: torch.Tensor      # [N_max] bool, accumulated over an epoch
    radius: torch.Tensor       # [] splat radius (decayed by the host's schedule)


NETS = ("geometry", "deformer", "gaussian", "rendering")


def _ghost(transforms: torch.Tensor) -> torch.Tensor:
    """Prepend the identity bone: [B, J, 4, 4] -> [B, J+1, 4, 4]."""
    eye = torch.eye(4, dtype=transforms.dtype, device=transforms.device)
    return torch.cat([eye.expand(transforms.shape[0], 1, 4, 4), transforms], dim=1)


def init_monogaussianavatar(flame: FlameModel, cfg: MonoConfig, bg_color=(1.0, 1.0, 1.0),
                            seed: int = 0):
    """Sphere point init (numpy, seeded: the JAX package's draws;
    monogaussianavatar.py:538-545) and the networks' init from a generator
    seeded with ``seed``. On FLAME's device. Returns (model, params, state,
    nets)."""
    dev = flame.v_template.device
    rng = np.random.default_rng(seed)
    N, n0 = cfg.max_points, cfg.n_init_points
    pts = rng.random((n0, 3)) * 2 - 1
    pts = pts / np.linalg.norm(pts, axis=-1, keepdims=True).clip(1e-8) * (0.5 / cfg.scene_scale)
    points = torch.zeros((N, 3), device=dev)
    points[:n0] = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    alive = torch.zeros((N,), dtype=torch.bool, device=dev)
    alive[:n0] = True

    cano_verts, cano_pf, cano_tf = flame_forward(flame, flame.canonical_exp,
                                                 flame.canonical_pose)
    if cfg.ghostbone:
        cano_tf = _ghost(cano_tf)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nets = {
        "geometry": GeometryNetwork(device=dev, generator=gen),
        "deformer": ForwardDeformer(flame.n_exp, ghostbone=cfg.ghostbone, device=dev,
                                    generator=gen),
        "gaussian": GaussianNetwork(device=dev, generator=gen),
        "rendering": RenderingNetwork(device=dev, generator=gen),
    }
    params = MonoParams(points=points, **{k: net_weights(nets[k]) for k in NETS})
    state = MonoState(
        alive=alive,
        visible=torch.zeros((N,), dtype=torch.bool, device=dev),
        radius=torch.tensor(0.15 * (0.75 ** math.log2(n0 / 100)) / cfg.scene_scale,
                            dtype=torch.float32, device=dev),
    )
    model = MonoModel(flame=flame, canonical_pose_feature=cano_pf,
                      canonical_transformations=cano_tf, canonical_verts=cano_verts[0],
                      bg_color=torch.tensor(bg_color, dtype=torch.float32, device=dev),
                      cfg=cfg)
    return model, params, state, nets


@torch.no_grad()
def nearest_vertex(pts: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """Each point's nearest vertex by |p|^2 - 2 p.v + |v|^2, as the JAX
    package sums it, the first of equal distances (``torch.argmin``, like
    ``jnp.argmin``). The [N, V] matrix is built in place: one copy of it
    (2.0 GB at 100,000 points and FLAME's 5,023 vertices)."""
    d2 = pts @ verts.T
    d2.mul_(-2.0).add_(torch.sum(pts ** 2, -1, keepdim=True)).add_(
        torch.sum(verts ** 2, -1)[None, :])
    return torch.argmin(d2, dim=-1)


def build_gaussians(model: MonoModel, params: MonoParams, state: MonoState, nets: dict,
                    expression, flame_pose, camera: Camera):
    """The splats of one frame (monogaussianavatar.py:150-254 up to the
    render): the networks' attributes, the points morphed canonical ->
    posed, and the camera with its translation scaled. Returns (gaussians,
    colours, camera, the deformer's outputs and the canonical points, the
    opacity logits)."""
    cfg = model.cfg
    pts = params.points
    n = pts.shape[0]
    _, pose_feature, transformations = flame_forward(model.flame, expression[None],
                                                     flame_pose[None])
    if cfg.ghostbone:
        transformations = _ghost(transformations)

    color_f, scale_f, rot_f, opac_f = functional_call(nets["geometry"], params.geometry,
                                                      (pts.detach(),))
    shapedirs, posedirs, lbs_weights, pnts_c_flame = functional_call(
        nets["deformer"], params.deformer, (pts,))

    # canonical -> posed (flame.forward_pts, FLAME.py:207-237)
    cano_exp = model.flame.canonical_exp
    pnts_c_orig = flame_mod.inverse_pts(
        pnts_c_flame, cano_exp.expand(n, cano_exp.shape[1]),
        model.canonical_transformations.expand((n,) + model.canonical_transformations.shape[1:]),
        model.canonical_pose_feature.expand(n, 36), shapedirs, posedirs, lbs_weights)
    pnts_d = flame_mod.forward_pts(
        pnts_c_orig, expression.expand(n, expression.shape[0]),
        transformations.expand((n,) + transformations.shape[1:]),
        pose_feature.expand(n, 36), shapedirs, posedirs, lbs_weights)

    offset = pnts_d.detach() - pnts_c_flame.detach()
    d_scale, d_rot, d_opac, d_color = functional_call(nets["gaussian"], params.gaussian,
                                                      (offset,))
    color = torch.sigmoid(color_f + d_color)
    scale = torch.sigmoid(scale_f + d_scale) * 0.025 / cfg.scene_scale
    opacity_logit = opac_f + d_opac
    # the container holds log scales; the radius pads the activated scale
    # (monogaussianavatar.py:417)
    gaussians = Gaussians(
        xyz=pnts_d,
        scaling=torch.log(torch.clamp_min(scale + state.radius, 1e-12)),
        rotation=rot_f + d_rot,
        opacity=opacity_logit,
        features_dc=pts.new_zeros((n, 1, 3)),
        features_rest=pts.new_zeros((n, 1, 3)),
        alive=state.alive,
        sh_degree=0,
    )
    # the camera's translation scaled (monogaussianavatar.py:157-160)
    view = camera.view.clone()
    view[:3, 3] = view[:3, 3] * cfg.cam_scale
    cam = dataclasses.replace(camera, view=view, full_proj=camera.proj @ view,
                              campos=-view[:3, :3].T @ view[:3, 3])
    deform = {"shapedirs": shapedirs, "posedirs": posedirs, "lbs_weights": lbs_weights,
              "pnts_c_flame": pnts_c_flame}
    return gaussians, color, cam, deform, opacity_logit


def mono_forward(model: MonoModel, params: MonoParams, state: MonoState, nets: dict,
                 expression, flame_pose, camera: Camera, bg_color=None,
                 render_cfg: RenderConfig = RenderConfig(), means2d_probe=None):
    """monogaussianavatar.py:150-254."""
    gaussians, color, cam, deform, opacity_logit = build_gaussians(
        model, params, state, nets, expression, flame_pose, camera)
    bg = model.bg_color if bg_color is None else bg_color
    out = render(cam, gaussians, bg, config=render_cfg, override_color=color,
                 means2d_probe=means2d_probe)
    visible_now = (torch.sigmoid(opacity_logit[:, 0]) >= model.cfg.prune_thresh) & state.alive
    return {
        "rgb_image": out["render"],
        "visibility_filter": out["visibility_filter"],
        "radii": out["radii"],
        "overflow": out["overflow"],
        "visible_now": visible_now,
        # the nearest canonical FLAME vertex, for the lbs distillation loss
        "index_batch": nearest_vertex(deform["pnts_c_flame"], model.canonical_verts),
        "shapedirs": deform["shapedirs"],
        "posedirs": deform["posedirs"],
        "lbs_weights": deform["lbs_weights"],
        "alive": state.alive,
    }


# ---------------------------------------------------------------------------
# epoch-level point maintenance (monogaussianavatar.py:430-467 + PointCloud)
# ---------------------------------------------------------------------------

UPSAMPLE_SCHEDULE = (
    (5, 400), (10, 800), (15, 1600), (20, 3200), (25, 6400),
    (30, 10000), (40, 20000), (50, 40000), (60, 80000),
)


def target_points_for_epoch(epoch: int, max_points: int) -> int:
    for limit, target in UPSAMPLE_SCHEDULE:
        if epoch < limit:
            return min(target, max_points)
    return max_points


def radius_decay(epoch: int, radius: float) -> float:
    if epoch in (5, 10, 15, 20, 25, 30, 40, 50):
        return 0.75 * radius
    if epoch == 60:
        return 0.9 * radius
    if epoch > 60 and epoch % 5 == 0:
        return 0.75 * radius
    return radius


def upsample_draws(generator: torch.Generator, alive: torch.Tensor, target: int):
    """The upsample's draws: ``target`` source points uniformly over the
    alive ones (over all when none is alive), and [target, 3] uniforms."""
    dev = generator.device
    probs = alive.to(torch.float32)
    probs = torch.where(torch.sum(probs) > 0, probs, torch.ones_like(probs))
    src = torch.multinomial(probs, target, replacement=True, generator=generator)
    return src, torch.rand((target, 3), generator=generator, device=dev)


@torch.no_grad()
def prune_and_upsample(params: MonoParams, state: MonoState, target: int,
                       noise_scale: float, draws=None,
                       generator: Optional[torch.Generator] = None, share=None):
    """Prune the points that were never visible, then clone random survivors
    with uniform noise into the dead slots until ``target`` are alive
    (PointCloud.prune / upsample_points). ``draws`` = (src [target], u
    [target, 3] in [0, 1)), else drawn from ``generator``
    (:func:`upsample_draws`). ``share(src, u)`` -> (src, u), when given,
    replaces the draws (replicas take one rank's). The dead slots fill in
    index order (a stable argsort, as jnp.argsort is). Returns (params,
    state, touched)."""
    n = state.alive.shape[0]
    alive = state.alive & state.visible
    need = torch.clamp_min(target - torch.sum(alive), 0)
    src, u = upsample_draws(generator, alive, target) if draws is None else draws
    if share is not None:
        src, u = share(src, u)
    new_pts = params.points[src] + (u - 0.5) * noise_scale
    slots = torch.argsort(alive.to(torch.int8), stable=True)[:target]     # dead first
    write = torch.arange(target, device=alive.device) < need
    slots = torch.where(write, slots, n)

    def put(arr, vals):
        out = torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])
        out[slots] = vals
        return out[:n]

    return (dataclasses.replace(params, points=put(params.points, new_pts)),
            dataclasses.replace(state, alive=put(alive, write),
                                visible=torch.zeros_like(state.visible)),
            put(torch.zeros_like(alive), write))
