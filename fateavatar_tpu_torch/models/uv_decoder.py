"""Neural baking: discrete Gaussians -> continuous UV attribute maps.

Port of ``fateavatar_tpu/models/uv_decoder.py`` (model/uv_decoder.py:36-690
of the reference). The decoder turns a learned constant into an 11-channel
texture (color 3 / opacity 1 / scaling 3 / rotation 3 / offset 1),
activates each slice, samples it at every splat's UV coordinate, and drives
the usual FLAME -> render path. Baked textures are directly editable
(``train/baker.py``'s ``UVEditor``).

Textures are ``[H, W, C]`` tensors, as in the JAX package. The decoder
network is an ``nn.Module`` (``models/unet.py``) that holds its parameters
and BatchNorm statistics; its constant input is a plain tensor beside it.

Key semantics preserved (with file:line refs to the reference):
* color activation tanh * (0.5 / C0)                     (uv_decoder.py:133-138)
* scaling softplus-capped at mean+std of the prior      (uv_decoder.py:140-149)
* offset tanh                                            (uv_decoder.py:151-156)
* rotation tanh*2pi axis-angle -> wxyz quaternion        (uv_decoder.py:158-174)
* texture lookup = bilinear grid-sample, border clamp,
  align_corners                                          (uv_decoder.py:179-202)
* prior splat set DOUBLED with a fresh 256^2 UV sampling (uv_decoder.py:303-308)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fateavatar_tpu_torch.models.fateavatar import (
    FateAvatarModel,
    FateAvatarParams,
    FateAvatarState,
    bind_splats,
)
from fateavatar_tpu_torch.models.unet import FeatureMap, UNet, UNetDecoder
from fateavatar_tpu_torch.ops import sampling
from fateavatar_tpu_torch.ops.camera import Camera
from fateavatar_tpu_torch.ops.knn import mean_knn_distance
from fateavatar_tpu_torch.ops.mesh import reweight_uvcoords_by_barycoords
from fateavatar_tpu_torch.ops.quaternion import (
    axis_angle_to_quat,
    quat_multiply,
    quat_to_axis_angle,
)
from fateavatar_tpu_torch.ops.sh import C0
from fateavatar_tpu_torch.render.render import RenderConfig, render
from fateavatar_tpu_torch.render.splats import Gaussians

TEXTURE_CHANNELS = {
    "color": 3, "opacity": 1, "scaling": 3, "rotation": 3, "offset": 1,
}
ATTRIBUTES = tuple(TEXTURE_CHANNELS)


# ---------------------------------------------------------------------------
# activations + texture lookup
# ---------------------------------------------------------------------------

def color_activation(x):
    return torch.tanh(x) * (0.5 / C0)


def scaling_activation(x, mean_scaling, max_scaling):
    return max_scaling - F.softplus(-(x + mean_scaling) + max_scaling)


def offset_activation(x):
    return torch.tanh(x)


def rotation_activation(x):
    """tanh*2pi axis-angle -> wxyz quaternion."""
    aa = torch.tanh(x) * (2.0 * math.pi)
    return axis_angle_to_quat(aa)


def activate_texture(name: str, tex: torch.Tensor, mean_scaling, max_scaling):
    if name == "color":
        return color_activation(tex)
    if name == "scaling":
        return scaling_activation(tex, mean_scaling, max_scaling)
    if name == "offset":
        return offset_activation(tex)
    if name == "rotation":
        return rotation_activation(tex)
    return tex


def texture_lookup(texture: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with border padding and align_corners semantics
    (uv_decoder.py:179-202). texture [H, W, C], uv [N, 2] (clipped to
    [0, 1]). The four corner texels come from ONE row gather of the
    flattened [H*W, C] texture: ``index_select``'s backward is an
    ``index_add_`` into the texture, where indexing ``texture[y0, x0]``
    would backpropagate through ``index_put_(accumulate=True)``, which
    serialises on the card."""
    h, w, c = texture.shape
    x = torch.clamp(uv[:, 0], 0.0, 1.0) * (w - 1)
    y = torch.clamp(uv[:, 1], 0.0, 1.0) * (h - 1)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    idx = torch.cat([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1])
    v00, v01, v10, v11 = texture.reshape(h * w, c).index_select(0, idx).reshape(4, -1, c)
    return (
        v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy + v11 * fx * fy
    )


def slice_texture(tex: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Split the 11-channel decoder output [H, W, 11] per attribute."""
    out = {}
    start = 0
    for name, ch in TEXTURE_CHANNELS.items():
        out[name] = tex[..., start:start + ch]
        start += ch
    return out


# ---------------------------------------------------------------------------
# decoder bundle
# ---------------------------------------------------------------------------

@dataclass
class UVDecoderModel:
    """Frozen context for baking: the avatar's priors + the doubled UV
    sampling (uv_decoder.py:286-340)."""

    avatar: FateAvatarModel
    # priors (raw parameter space, rotation normalized)
    prior_features_dc: torch.Tensor    # [N, 1, 3]
    prior_opacity: torch.Tensor        # [N, 1]
    prior_offset: torch.Tensor         # [N, 1]
    prior_rotation: torch.Tensor       # [N, 4] normalized
    prior_scaling: torch.Tensor        # [N, 3]
    # doubled binding: M = avatar capacity + 256^2 fresh samples
    face_index: torch.Tensor           # [M] int64
    bary_coords: torch.Tensor          # [M, 3]
    uv_sample: torch.Tensor            # [M, 2]
    alive: torch.Tensor                # [M] bool
    mean_scaling: torch.Tensor
    std_scaling: torch.Tensor
    max_scaling: torch.Tensor
    sample_radius: torch.Tensor
    # frozen FLAME deltas of the trained avatar
    delta_shapedirs: torch.Tensor
    delta_posedirs: torch.Tensor
    delta_vertex: torch.Tensor
    decode_type: str = "UNet"
    bake_attribute: tuple = ("color", "opacity")


def build_uv_decoder(
    avatar: FateAvatarModel,
    params: FateAvatarParams,
    state: FateAvatarState,
    decode_type: str = "UNet",
    bake_attribute=("color", "opacity"),
    fresh_samples: int = 256 * 256,
    seed: int = 0,
) -> Tuple[UVDecoderModel, nn.Module, torch.Tensor]:
    """Snapshot priors + double the sampling density + init the net, on the
    device of ``params``. Returns (decoder_model, net, const): the network
    (its parameters and BatchNorm statistics) and its constant input
    ([1, 512, 512, 11] for UNet and feature_map, [1, 8, 8, 512] for
    decode_only), both drawn from a generator seeded with ``seed``."""
    dev = params.offset.device
    # fresh uniform samples over the chart (uv_decoder.py:52-56); host
    # numpy, the JAX package's draws
    f_idx, f_bary = sampling.uniform_sampling_barycoords(
        fresh_samples, avatar.uvcoords.cpu().numpy(), avatar.uvfaces.cpu().numpy(),
        seed=seed,
    )
    face_index = torch.cat([state.face_index,
                            torch.from_numpy(f_idx.astype(np.int64)).to(dev)])
    bary = torch.cat([state.bary_coords, torch.from_numpy(f_bary).to(dev)])
    alive = torch.cat([state.alive, torch.ones((fresh_samples,), dtype=torch.bool,
                                               device=dev)])

    uv_sample = reweight_uvcoords_by_barycoords(
        avatar.uvcoords, avatar.uvfaces, face_index, bary)[..., :2]

    # sample radius from UV-space KNN over ALIVE points (uv_decoder.py:319-323)
    d = mean_knn_distance(torch.cat([uv_sample, torch.zeros_like(uv_sample[:, :1])], dim=-1))
    sample_radius = torch.mean(torch.where(alive, d, 0.0)) / torch.clamp_min(
        torch.mean(alive.to(torch.float32)), 1e-6)

    rot_norm = params.rotation / torch.linalg.norm(
        params.rotation, dim=-1, keepdim=True).clamp_min(1e-8)
    alive_f = state.alive.to(torch.float32)
    mean_scaling = torch.sum(params.scaling * alive_f[:, None]) / torch.clamp_min(
        torch.sum(alive_f) * 3, 1.0)
    var = torch.sum((params.scaling - mean_scaling) ** 2 * alive_f[:, None]) / torch.clamp_min(
        torch.sum(alive_f) * 3 - 1, 1.0)
    std_scaling = torch.sqrt(var)

    model = UVDecoderModel(
        avatar=avatar,
        prior_features_dc=params.features_dc,
        prior_opacity=params.opacity,
        prior_offset=params.offset,
        prior_rotation=rot_norm,
        prior_scaling=params.scaling,
        face_index=face_index,
        bary_coords=bary,
        uv_sample=uv_sample,
        alive=alive,
        mean_scaling=mean_scaling,
        std_scaling=std_scaling,
        max_scaling=mean_scaling + std_scaling,
        sample_radius=sample_radius,
        delta_shapedirs=params.delta_shapedirs,
        delta_posedirs=params.delta_posedirs,
        delta_vertex=params.delta_vertex,
        decode_type=decode_type,
        bake_attribute=tuple(bake_attribute),
    )

    out_ch = sum(TEXTURE_CHANNELS.values())
    gen = torch.Generator(device=dev).manual_seed(seed)
    if decode_type == "UNet":
        const_shape = (1, 512, 512, 11)
    elif decode_type == "decode_only":
        const_shape = (1, 8, 8, 512)
    elif decode_type == "feature_map":
        const_shape = (1, 512, 512, 11)
    else:
        raise NotImplementedError(decode_type)
    const = torch.rand(const_shape, generator=gen, device=dev) * 2.0 - 1.0
    if decode_type == "UNet":
        net = UNet(const_shape[-1], out_ch, device=dev, generator=gen)
    elif decode_type == "decode_only":
        net = UNetDecoder(const_shape[-1], out_ch, device=dev, generator=gen)
    else:
        net = FeatureMap(out_ch, device=dev, generator=gen)
    return model, net, const


def decode_textures(model: UVDecoderModel, net: nn.Module, const: torch.Tensor,
                    train: bool = True):
    """Run the decoder -> raw + activated texture dicts [H, W, C]. In
    training mode the network's BatchNorm statistics update in place."""
    tex = net(const, train)[0]  # drop batch dim
    raw = slice_texture(tex)
    act = {
        name: activate_texture(name, t, model.mean_scaling, model.max_scaling)
        for name, t in raw.items()
    }
    return raw, act


def sample_attributes(model: UVDecoderModel, act_textures: Dict[str, torch.Tensor]):
    """Activated textures -> per-splat value dict at the prior UVs. The
    textures share one size, so they are sampled in one lookup of their
    channels side by side (bilinear weights act per channel: the same
    values as one lookup each)."""
    names = list(act_textures)
    packed = torch.cat([act_textures[n] for n in names], dim=-1)
    values = texture_lookup(packed, model.uv_sample)
    widths = [act_textures[n].shape[-1] for n in names]
    return dict(zip(names, torch.split(values, widths, dim=-1)))


def _assemble_gaussians(model: UVDecoderModel, values: Dict[str, torch.Tensor],
                        expression, flame_pose):
    """FLAME-drive the baked splats (uv_decoder.py:413-498). ``values``
    holds the chosen per-splat attributes: color [M,3] (activated SH dc),
    opacity logits [M,1], scaling log [M,3], rotation wxyz [M,4], and
    ``offset_act`` [M,1], the offset already tanh-activated."""
    avatar = model.avatar
    cfg = avatar.cfg
    pos, g_quat, g_normal, g_ratio, verts, verts_orig = bind_splats(
        avatar, expression, flame_pose, model.face_index, model.bary_coords,
        model.delta_shapedirs, model.delta_posedirs, model.delta_vertex)

    xyz = pos + g_normal * cfg.normal_offset * values["offset_act"]
    rot = quat_multiply(g_quat, values["rotation"])
    scaling = values["scaling"]
    if cfg.resize_scale:
        scaling = scaling + torch.log(torch.clamp_min(g_ratio, 1e-12))

    m = model.face_index.shape[0]
    gaussians = Gaussians(
        xyz=xyz,
        scaling=scaling,
        rotation=rot,
        opacity=values["opacity"],
        features_dc=values["color"][:, None, :],
        features_rest=xyz.new_zeros((m, 1, 3)),
        alive=model.alive,
        sh_degree=0,
    )
    return gaussians, verts, verts_orig


def _merge_with_priors(model: UVDecoderModel, decoded: Dict[str, torch.Tensor]):
    """Per-attribute choice: baked value vs prior (uv_decoder.py:477-484).
    Decoded values cover the doubled splat set; the prior half reuses the
    avatar's trained attributes, the fresh half ALWAYS uses decoded values
    (the avatar has no priors for them)."""
    n = model.prior_opacity.shape[0]

    def pick(name, decoded_v, prior_v):
        if name in model.bake_attribute:
            return decoded_v
        return torch.cat([prior_v, decoded_v[n:]], dim=0)

    values = {
        "color": pick("color", decoded["color"], model.prior_features_dc[:, 0, :]),
        "opacity": pick("opacity", decoded["opacity"], model.prior_opacity),
        "scaling": pick("scaling", decoded["scaling"], model.prior_scaling),
        "rotation": pick("rotation", decoded["rotation"], model.prior_rotation),
    }
    # decoded offset is already tanh-activated; a prior offset needs tanh
    values["offset_act"] = pick("offset", decoded["offset"], torch.tanh(model.prior_offset))
    return values


def uv_decoder_forward(
    model: UVDecoderModel,
    net: nn.Module,
    const: torch.Tensor,
    expression: torch.Tensor,
    flame_pose: torch.Tensor,
    camera: Camera,
    bg_color: Optional[torch.Tensor] = None,
    render_cfg: RenderConfig = RenderConfig(),
    train: bool = True,
):
    """Decode -> sample -> FLAME-drive -> render (uv_decoder.py:387-542).
    Returns the output dict (in training mode the network's BatchNorm
    statistics have been updated in place)."""
    raw, act = decode_textures(model, net, const, train=train)
    decoded = sample_attributes(model, act)
    values = _merge_with_priors(model, decoded)
    gaussians, verts, verts_orig = _assemble_gaussians(model, values, expression, flame_pose)
    bg = model.avatar.bg_color if bg_color is None else bg_color
    out = render(camera, gaussians, bg, config=render_cfg)

    n = model.prior_opacity.shape[0]
    return {
        "rgb_image": out["render"],
        "scale": torch.exp(decoded["scaling"]),
        "raw_rot": quat_to_axis_angle(decoded["rotation"]),
        "visibility_filter": out["visibility_filter"],
        "radii": out["radii"],
        "overflow": out["overflow"],
        "verts": verts,
        "verts_orig": verts_orig,
        "faces": model.avatar.faces,
        "alive": model.alive,
        "texture_dict": raw,
        "act_texture_dict": act,
        # decode-vs-prior pairs for the reg loss (uv_decoder.py:530-539),
        # restricted to the prior half of the splat set
        "decode_color": decoded["color"][:n],
        "decode_opacity": decoded["opacity"][:n],
        "decode_scaling": decoded["scaling"][:n],
        "decode_rotation": decoded["rotation"][:n],
        "decode_offset": decoded["offset"][:n],
        "prior_features_dc": model.prior_features_dc[:, 0, :],
        "prior_opacity": model.prior_opacity,
        "prior_scaling": model.prior_scaling,
        "prior_rotation": model.prior_rotation,
        "prior_offset": torch.tanh(model.prior_offset),
        "prior_alive": model.alive[:n, None].to(torch.float32),
    }


def render_from_texture_dict(
    model: UVDecoderModel,
    textures: Dict[str, torch.Tensor],
    expression, flame_pose, camera,
    bg_color=None,
    render_cfg: RenderConfig = RenderConfig(),
    activated: bool = True,
):
    """Animate EDITED textures (uv_decoder.py:564-690).

    ``activated=True``: textures are fully activated already (the editor
    operates in activated space). ``activated=False``: raw decoder dumps —
    activate everything except color, which the reference's editing pipeline
    pre-activates outside (uv_decoder.py:109-131)."""
    if activated:
        act = dict(textures)
    else:
        act = {
            name: tex if name == "color" else activate_texture(
                name, tex, model.mean_scaling, model.max_scaling)
            for name, tex in textures.items()
        }
    decoded = sample_attributes(model, act)
    values = _merge_with_priors(model, decoded)
    gaussians, _, _ = _assemble_gaussians(model, values, expression, flame_pose)
    bg = model.avatar.bg_color if bg_color is None else bg_color
    out = render(camera, gaussians, bg, config=render_cfg)
    return {"rgb_image": out["render"]}


@torch.no_grad()
def export_avatar_params(
    model: UVDecoderModel, net: nn.Module, const: torch.Tensor,
) -> Tuple[FateAvatarParams, FateAvatarState]:
    """Write decoded attributes back into FateAvatar-shaped params/state at
    the doubled capacity (uv_decoder.py:342-385)."""
    _, act = decode_textures(model, net, const, train=False)
    decoded = sample_attributes(model, act)
    m = model.face_index.shape[0]
    zeros = decoded["opacity"].new_zeros((m,))

    # decoded offset is activated; FateAvatarParams stores pre-tanh values
    off = torch.clamp(decoded["offset"], -0.999, 0.999)
    params = FateAvatarParams(
        offset=torch.atanh(off),
        features_dc=decoded["color"][:, None, :],
        features_rest=decoded["color"].new_zeros((m, 1, 3)),
        scaling=decoded["scaling"],
        rotation=decoded["rotation"],
        opacity=decoded["opacity"],
        delta_shapedirs=model.delta_shapedirs,
        delta_posedirs=model.delta_posedirs,
        delta_vertex=model.delta_vertex,
    )
    state = FateAvatarState(
        face_index=model.face_index,
        bary_coords=model.bary_coords,
        alive=model.alive,
        xyz_gradient_accum=zeros,
        denom=zeros.clone(),
        sample_flag=zeros.clone(),
        max_radii2d=zeros.clone(),
    )
    return params, state
