"""Plain FateAvatar: the forward of one frame, the training loss, Adam, and
the first training steps.

A frozen copy of the port's plain code (``models/fateavatar.py``'s
``bind_splats`` / ``build_gaussians``, ``train/losses.py``'s FateAvatar
terms and VGG16 perceptual loss, ``train/optim.py``'s per-field Adam), with
the rasterizer of :mod:`raster` in place of the port's binning and blend
kernels. Gradients come from autograd. It imports nothing of the port and
takes only what the benchmark made: the FLAME pickle's arrays, the avatar's
parameters and binding, the VGG weights, the frames and their codes.

``dtype`` is the precision of everything but the VGG stack, ``vgg_dtype``
that of the VGG stack (the configuration's bfloat16); a control runs them
one step lower (bfloat16, and float8 e4m3 for the VGG operands).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import geometry as G
from . import raster

VGG_BLOCK_ENDS = (2, 4, 7, 10)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
B1, B2, EPS = 0.9, 0.999, 1e-8


class Avatar:
    """The assets of one avatar in the reference's precision: FLAME, the
    canonical face scales, the background, the model settings (``mcfg``: the
    configuration's ``model`` section and ``img_res``)."""

    def __init__(self, flame_arrays: dict, n_shape: int, n_exp: int, mcfg: dict,
                 device, dtype=torch.float32):
        self.dtype, self.device, self.mcfg = dtype, device, mcfg
        self.flame = G.make_flame(flame_arrays, n_shape, n_exp, mcfg["canonical_pose"],
                                  device, dtype)
        cano = G.flame_forward(self.flame, self.flame.canonical_exp, self.flame.canonical_pose)
        _, self.face_scale_cano, _ = G.face_frames(cano[0], self.flame.faces)
        self.bg = torch.ones(3, dtype=dtype, device=device)

    def gaussians(self, params: dict, state: dict, expression, pose):
        """World-space splats of one frame: (xyz, activated scale, rotation,
        activated opacity, colour, verts, verts without the deltas)."""
        fl, cfg = self.flame, self.mcfg
        d_sd = params["delta_shapedirs"] if cfg["delta_blendshape"] else None
        d_pd = params["delta_posedirs"] if cfg["delta_blendshape"] else None
        d_v = params["delta_vertex"] if cfg["delta_vertex"] else None
        verts = G.flame_forward(fl, expression[None], pose[None], d_sd, d_pd, d_v)
        verts_orig = G.flame_forward(fl, expression[None], pose[None])
        v = verts[0]
        frame, scale, normal = G.face_frames(v, fl.faces)
        fi = state["face_index"]
        quat = G.matrix_to_quat(frame)[fi]
        tri = v[fl.faces][fi]                                      # [N, 3, 3]
        pos = torch.einsum("nk,nkd->nd", state["bary_coords"].to(v.dtype), tri)
        xyz = pos + normal[fi] * cfg["normal_offset"] * torch.tanh(params["offset"])
        rot = G.quat_multiply(quat, params["rotation"])
        scaling = params["scaling"]
        if cfg["resize_scale"]:
            ratio = (scale / self.face_scale_cano)[fi]
            scaling = scaling + torch.log(torch.clamp_min(ratio, 1e-12))
        return (xyz, torch.exp(scaling), rot, torch.sigmoid(params["opacity"]),
                raster.sh0_color(params["features_dc"]), verts, verts_orig)

    def render(self, params, state, expression, pose, cam, grad: bool = False):
        """(image [H, W, 3], outputs the loss reads)."""
        xyz, scale, rot, op, color, verts, verts_orig = self.gaussians(params, state,
                                                                       expression, pose)
        soa, depth, radius = raster.preprocess(cam, xyz, scale, rot, op, color, state["alive"])
        img, _ = raster.blend(soa, depth, radius, cam.width, cam.height, self.bg, grad=grad)
        return img, {"verts": verts, "verts_orig": verts_orig}

    def frame_soa(self, params, state, expression, pose, cam):
        """The blend's inputs of one frame (soa, depth, radius), for counts."""
        xyz, scale, rot, op, color, _, _ = self.gaussians(params, state, expression, pose)
        return raster.preprocess(cam, xyz, scale, rot, op, color, state["alive"])


def _to_f8(x):
    return x.to(torch.float8_e4m3fn).to(torch.bfloat16)


def vgg_features(weights, x, dtype, f8: bool = False):
    """The four VGG16 block outputs (to conv4_3) of NCHW ``x``, the
    convolutions in ``dtype`` (with ``f8``: operands rounded to float8 e4m3)."""
    x = x.to(dtype)
    feats, i = [], 0
    for end in VGG_BLOCK_ENDS:
        while i < end:
            w, b = weights[i]
            w, b = w.to(dtype), b.to(dtype)
            if f8:
                x, w = _to_f8(x), _to_f8(w)
            x = F.relu(F.conv2d(x, w, b, padding=1))
            i += 1
        feats.append(x)
        if end != VGG_BLOCK_ENDS[-1]:
            B, C, H, W = x.shape
            x = torch.amax(x.reshape(B, C, H // 2, 2, W // 2, 2), dim=(3, 5))
    return feats


def vgg_loss(weights, pred, gt, dtype, f8=False):
    """Sum over the four blocks of the mean L1 feature distance, after
    ImageNet normalisation and an antialiased bilinear resize to 224."""
    x, y = pred[None].permute(0, 3, 1, 2).float(), gt[None].permute(0, 3, 1, 2).float()
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[None, :, None, None]
    x, y = (x - mean) / std, (y - mean) / std
    x = F.interpolate(x, size=(224, 224), mode="bilinear", align_corners=False, antialias=True)
    y = F.interpolate(y, size=(224, 224), mode="bilinear", align_corners=False, antialias=True)
    fx = vgg_features(weights, x, dtype, f8)
    fy = vgg_features(weights, y.detach(), dtype, f8)
    return sum(torch.mean(torch.abs(a.float() - b.float())) for a, b in zip(fx, fy))


def loss(avatar: Avatar, lcfg: dict, vgg, vgg_dtype, f8, img, gt, params, state, out):
    """The configuration's FateAvatar loss (the terms it weights above 0
    that this reference knows: l1 rgb, vgg, scale anisotropy, laplacian)."""
    total = lcfg["rgb_weight"] * torch.mean(torch.abs(img - gt))
    if lcfg.get("vgg_weight", 0) > 0:
        total = total + lcfg["vgg_weight"] * vgg_loss(vgg, img, gt, vgg_dtype, f8).to(img.dtype)
    if lcfg.get("scale_weight", 0) > 0:
        s = torch.exp(params["scaling"])
        reg = F.relu(torch.amax(s, -1) / torch.clamp_min(torch.amin(s, -1), 1e-12)
                     - lcfg["scale_threshold"])
        w = state["alive"].to(s.dtype)
        total = total + lcfg["scale_weight"] * torch.sum(reg * w) / torch.clamp_min(w.sum(), 1.0)
    if lcfg.get("laplacian_weight", 0) > 0:
        faces = avatar.flame.faces
        lap = G.laplacian(out["verts"][0], faces)
        lap0 = G.laplacian(out["verts_orig"][0], faces).detach()
        total = total + lcfg["laplacian_weight"] * torch.mean(torch.sum((lap - lap0) ** 2, -1))
    return total


UNKNOWN_TERMS = ("dssim_weight", "lpips_weight", "rot_weight", "normal_weight", "flame_weight")
TRACK_FIELDS = ("expression", "flame_pose", "cam_t")


def _adam(p, g, m, v, count, lr):
    """One Adam step of a tensor (bias correction from a float32 count)."""
    c1, c2 = 1.0 - B1 ** count, 1.0 - B2 ** count
    m = B1 * m + (1 - B1) * g
    v = B2 * v + (1 - B2) * g * g
    return p + (-lr * (m / c1) / (torch.sqrt(v / c2) + EPS)).to(p.dtype), m, v


def train_steps(avatar: Avatar, lcfg: dict, lrs: dict, vgg, vgg_dtype, params0: dict,
                state: dict, frames, n_steps: int, f8: bool = False, track_lr=None):
    """``n_steps`` steps of the training step from ``params0``; frame i is a
    dict of ``expr``, ``pose``, ``R`` (host), ``T``, ``fov``, ``gt`` float
    [H, W, 3]. With ``track_lr``, each step is followed by the tracking
    refinement of its frame's rows (expression, pose, camera translation):
    their gradient of the frame's loss under the updated parameters, one
    row-wise Adam step (each row's first). Returns (losses, the first step's
    gradients by field, the parameters after the last step); with tracking
    both hold ``tables.<row field>`` too (the first frame's row gradient;
    every frame's rows after its step, stacked)."""
    for k in UNKNOWN_TERMS:
        if lcfg.get(k, 0) > 0:
            raise ValueError(f"the reference has no {k} term")
    dev = params0["offset"].device
    h, w = frames[0]["gt"].shape[:2]
    params = {k: v.detach().clone() for k, v in params0.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first, rows_after = [], None, []

    def frame_loss(p, f, expr, pose, T):
        cam = G.camera_t(f["R"], T, f["fov"], f["fov"], w, h)
        img, out = avatar.render(p, state, expr, pose, cam, grad=True)
        return loss(avatar, lcfg, vgg, vgg_dtype, f8, img, f["gt"], p, state, out)

    for i in range(n_steps):
        f = frames[i]
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        total = frame_loss(leaves, f, f["expr"], f["pose"], f["T"])
        grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        losses.append(float(total.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        count = torch.tensor(float(i + 1), device=dev)
        with torch.no_grad():
            for k in params:
                params[k], mu[k], nu[k] = _adam(params[k], grads[k], mu[k], nu[k], count,
                                                lrs.get(k, 0.0))
        del leaves, total, grads
        if track_lr is not None:
            rows = [x.detach().clone().requires_grad_() for x in (f["expr"], f["pose"], f["T"])]
            g_rows = torch.autograd.grad(frame_loss(params, f, *rows), rows)
            one = torch.tensor(1.0, device=dev)
            with torch.no_grad():
                new = [_adam(r, g, torch.zeros_like(r), torch.zeros_like(r), one, track_lr)[0]
                       for r, g in zip(rows, g_rows)]
            rows_after.append(new)
            if i == 0:
                first.update({f"tables.{k}": g.detach() for k, g in zip(TRACK_FIELDS, g_rows)})
    if track_lr is not None:
        for j, k in enumerate(TRACK_FIELDS):
            params[f"tables.{k}"] = torch.stack([r[j] for r in rows_after])
    return losses, first, params
