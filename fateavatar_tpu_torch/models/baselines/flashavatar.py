"""FlashAvatar baseline: UV-embedded canonical splats + an MLP deformation.

Port of ``fateavatar_tpu/models/baselines/flashavatar.py``
(model/baseline/flashavatar.py:46-464 of the reference). Canonical splats
come from a non-strict 128^2 UV sampling; a 6-layer MLP(256) conditioned on
[PE(xyz_canonical), expression, jaw, eyes] predicts 10 deltas (position 3,
rotation 4, scale 3) applied before rendering:

* positional encoding with 8 octaves and the identity (flashavatar.py:404-440);
* deltas tanh-squashed; the rotation's real part exp()'d; the scale delta
  exp()'d and MULTIPLIED onto the log-scaling (flashavatar.py:253-276);
* quaternion composition splat x delta (flashavatar.py:382-394).

The deformer's weights live in ``FlashParams.deformer``, a dict of tensors
by the :class:`DeformMLP`'s parameter names, applied with
``torch.func.functional_call`` (the flax ``apply`` of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.func import functional_call

from fateavatar_tpu_torch.flame.flame import FlameModel, flame_forward
from fateavatar_tpu_torch.models.unet import _lecun_normal_
from fateavatar_tpu_torch.ops import sampling
from fateavatar_tpu_torch.ops.camera import Camera
from fateavatar_tpu_torch.ops.knn import mean_knn_distance
from fateavatar_tpu_torch.ops.mesh import reweight_verts_by_barycoords
from fateavatar_tpu_torch.ops.quaternion import quat_multiply
from fateavatar_tpu_torch.render.render import RenderConfig, render
from fateavatar_tpu_torch.render.splats import Gaussians, inverse_sigmoid
from fateavatar_tpu_torch.utils.obj_io import ObjMesh


def positional_encoding(x: torch.Tensor, n_freqs: int = 8) -> torch.Tensor:
    """[..., d] -> [..., d * (1 + 2 n_freqs)]: x, then sin and cos of x 2^k."""
    parts = [x]
    for k in range(n_freqs):
        f = 2.0 ** k
        parts.append(torch.sin(x * f))
        parts.append(torch.cos(x * f))
    return torch.cat(parts, dim=-1)


def dense_stack(shapes, device=None, generator: Optional[torch.Generator] = None,
                zero=()) -> nn.ModuleList:
    """Linear layers (in, out) in the order flax names them (``Dense_k`` ->
    ``dense.k``), each initialised as flax's ``nn.Dense`` is (LeCun normal
    weight from ``generator``, zero bias); the layers in ``zero`` all zero."""
    layers = nn.ModuleList()
    for k, (i, o) in enumerate(shapes):
        lin = nn.utils.skip_init(nn.Linear, i, o, device=device)
        if k in zero:
            nn.init.zeros_(lin.weight)
        else:
            _lecun_normal_(lin.weight, generator)
        nn.init.zeros_(lin.bias)
        layers.append(lin)
    return layers


def net_weights(net: nn.Module) -> dict:
    """A network's parameters as a dict of tensors by name (copies)."""
    return {k: v.detach().clone() for k, v in net.named_parameters()}


class DeformMLP(nn.Module):
    """6 hidden layers of 256, ReLU, a linear head (flashavatar.py:443-464)."""

    def __init__(self, in_dim: int, hidden_dim: int = 256, hidden_layers: int = 6,
                 output_dim: int = 10, device=None, generator=None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * hidden_layers + [output_dim]
        self.dense = dense_stack(list(zip(dims[:-1], dims[1:])), device, generator)

    def forward(self, x):
        for layer in self.dense[:-1]:
            x = torch.relu(layer(x))
        return self.dense[-1](x)


@dataclass(frozen=True)
class FlashConfig:
    tex_size: int = 128
    pts_freq: int = 8
    img_height: int = 512
    img_width: int = 512


@dataclass
class FlashModel:
    flame: FlameModel
    faces: torch.Tensor          # [F, 3] int64
    face_index: torch.Tensor     # [N] int64
    bary_coords: torch.Tensor    # [N, 3]
    cano_embedded: torch.Tensor  # [N, pe_dim] PE of the canonical template points
    bg_color: torch.Tensor
    cfg: FlashConfig


@dataclass
class FlashParams:
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    deformer: dict               # DeformMLP's weights by name


def init_flashavatar(template: ObjMesh, flame: FlameModel, cfg: FlashConfig,
                     bg_color=(1.0, 1.0, 1.0), seed: int = 0):
    """Non-strict UV sampling (the texels actually covered,
    flashavatar.py:160-165), the KNN scale init, neutral splat attributes,
    the deformer's init from a generator seeded with ``seed``. On FLAME's
    device. Returns (model, params, net)."""
    dev = flame.v_template.device
    f_idx, bary = sampling.uniform_sampling_barycoords(
        cfg.tex_size * cfg.tex_size, template.uvcoords, template.uvfaces, strict=False)
    face_index = torch.as_tensor(f_idx, dtype=torch.int64, device=dev)
    bary_coords = torch.as_tensor(bary, dtype=torch.float32, device=dev)
    faces = torch.as_tensor(template.faces, dtype=torch.int64, device=dev)
    verts_sampling = reweight_verts_by_barycoords(
        torch.as_tensor(template.verts, dtype=torch.float32, device=dev), faces,
        face_index, bary_coords)
    scale_init = torch.log(torch.mean(mean_knn_distance(verts_sampling)))
    cano_embedded = positional_encoding(verts_sampling, cfg.pts_freq)

    n = face_index.shape[0]
    cond_dim = cano_embedded.shape[-1] + flame.n_exp + 3 + 6
    net = DeformMLP(cond_dim, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
    params = FlashParams(
        features_dc=torch.zeros((n, 1, 3), device=dev),
        features_rest=torch.zeros((n, 1, 3), device=dev),
        scaling=scale_init.expand(n, 3).clone(),
        rotation=torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev).repeat(n, 1),
        opacity=inverse_sigmoid(torch.tensor(0.1, device=dev)).expand(n, 1).clone(),
        deformer=net_weights(net),
    )
    model = FlashModel(flame=flame, faces=faces, face_index=face_index,
                       bary_coords=bary_coords, cano_embedded=cano_embedded,
                       bg_color=torch.tensor(bg_color, dtype=torch.float32, device=dev),
                       cfg=cfg)
    return model, params, net


def flash_forward(model: FlashModel, params: FlashParams, net: DeformMLP, expression,
                  flame_pose, camera: Camera, bg_color=None,
                  render_cfg: RenderConfig = RenderConfig(), means2d_probe=None):
    """flashavatar.py:224-295: the deformer on [PE(cano), expression, jaw,
    eyes], its tanh'd deltas applied, render."""
    n = model.face_index.shape[0]
    cond = torch.cat([expression, flame_pose[6:9], flame_pose[9:15]])
    inp = torch.cat([model.cano_embedded, cond.expand(n, cond.shape[0])], dim=-1)
    deforms = torch.tanh(functional_call(net, params.deformer, (inp,)))
    pos_delta = deforms[:, :3]
    rot_delta = torch.cat([torch.exp(deforms[:, 3:4]), deforms[:, 4:7]], dim=-1)
    scale_delta = torch.exp(deforms[:, 7:10])

    verts, _, _ = flame_forward(model.flame, expression[None], flame_pose[None])
    pos = reweight_verts_by_barycoords(verts[0], model.faces, model.face_index,
                                       model.bary_coords)
    gaussians = Gaussians(
        xyz=pos + pos_delta,
        scaling=params.scaling * scale_delta,
        rotation=quat_multiply(params.rotation, rot_delta),
        opacity=params.opacity,
        features_dc=params.features_dc,
        features_rest=params.features_rest,
        alive=torch.ones((n,), dtype=torch.bool, device=pos.device),
        sh_degree=0,
    )
    bg = model.bg_color if bg_color is None else bg_color
    out = render(camera, gaussians, bg, config=render_cfg, means2d_probe=means2d_probe)
    return {
        "rgb_image": out["render"],
        "visibility_filter": out["visibility_filter"],
        "radii": out["radii"],
        "overflow": out["overflow"],
    }
