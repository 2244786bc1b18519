"""Plain MonoGaussianAvatar: one frame's forward, its training loss, Adam,
and the first training steps.

A frozen copy of the port's plain code (``models/baselines/
monogaussianavatar.py``'s networks and ``build_gaussians``, FLAME's
per-point ``inverse_pts`` / ``forward_pts``, ``train/losses.py``'s
``MonoGaussianAvatarLoss`` with ``d_ssim``, ``train/baseline_steps.py``'s
step and Adam), with the rasterizer of :mod:`raster`. The networks' weights
are the dicts of tensors the benchmark hands both sides. It imports nothing
of the port. Every function works in the dtype of its inputs.
"""

from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

from . import geometry as G
from . import raster
from .fateavatar import B1, B2, EPS


def softplus100(x):
    return F.softplus(100.0 * x) / 100.0


def positional_encoding(x, n_freqs):
    parts = [x]
    for k in range(n_freqs):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, dim=-1)


def _lin(w, k, x):
    return F.linear(x, w[f"dense.{k}.weight"], w[f"dense.{k}.bias"])


def geometry_net(w, pts, multires=6, depth=8, skip_at=3):
    inp = positional_encoding(pts, multires)
    x = inp
    for lvl in range(depth - 1):
        if lvl == skip_at:
            x = torch.cat([x, inp], dim=-1) / np.sqrt(2.0)
        x = softplus100(_lin(w, lvl, x))
    h = depth - 1
    color = _lin(w, h, _lin(w, h + 1, softplus100(_lin(w, h + 2, x))))
    scales, rots, opacity = (_lin(w, h + k, softplus100(_lin(w, h + k + 1, x)))
                             for k in (3, 5, 7))
    return color, scales, rots, opacity


def gaussian_net(w, offset):
    x = torch.relu(_lin(w, 1, torch.relu(_lin(w, 0, offset))))
    return tuple(_lin(w, k, torch.relu(_lin(w, k + 1, x))) for k in (2, 4, 6, 8))


def deformer_net(w, pts, n_exp, depth=4):
    x = pts
    for lvl in range(depth):
        x = softplus100(_lin(w, lvl, x))
    blend = _lin(w, depth, x)
    skin = _lin(w, depth + 2, softplus100(_lin(w, depth + 1, x)))
    lbs = torch.softmax(20.0 * skin, dim=-1)
    posedirs = blend[:, :108].reshape(-1, 36, 3)
    shapedirs = blend[:, 108:108 + n_exp * 3].reshape(-1, 3, n_exp)
    return shapedirs, posedirs, lbs, pts + blend[:, -3:]


def _blend_transforms(tf, lbs):
    n, J = lbs.shape
    return torch.einsum("mj,mjpq->mpq", lbs, tf.reshape(n, J, 4, 4))


def forward_pts(p, betas, tf, feat, shapedirs, posedirs, lbs):
    p = p + torch.einsum("ml,mkl->mk", betas, shapedirs)
    p = p + torch.einsum("mi,mik->mk", feat, posedirs)
    T = _blend_transforms(tf, lbs)
    return torch.einsum("mpq,mq->mp", T[:, :3, :3], p) + T[:, :3, 3]


def inverse_pts(p, betas, tf, feat, shapedirs, posedirs, lbs):
    T = _blend_transforms(tf, lbs)
    A, t = T[:, :3, :3], T[:, :3, 3]
    c0, c1, c2 = A[:, :, 0], A[:, :, 1], A[:, :, 2]
    adj = torch.stack([torch.linalg.cross(c1, c2), torch.linalg.cross(c2, c0),
                       torch.linalg.cross(c0, c1)], dim=1)
    det = torch.sum(c0 * adj[:, 0], dim=-1)
    a_inv = adj / det[:, None, None]
    q = torch.einsum("mpq,mq->mp", a_inv, p) - torch.einsum("mpq,mq->mp", a_inv, t) / T[:, 3, 3:4]
    q = q - torch.einsum("ml,mkl->mk", betas, shapedirs)
    return q - torch.einsum("mi,mik->mk", feat, posedirs)


def _ghost(tf):
    eye = torch.eye(4, dtype=tf.dtype, device=tf.device)
    return torch.cat([eye.expand(tf.shape[0], 1, 4, 4), tf], dim=1)


class Mono:
    """The assets of one MonoGaussianAvatar: FLAME and its canonical
    transforms; ``mcfg``: ``cam_scale``, ``scene_scale``, ``prune_thresh``."""

    def __init__(self, flame_arrays, n_shape, n_exp, canonical_pose, mcfg, device,
                 dtype=torch.float32):
        self.mcfg, self.dtype = mcfg, dtype
        self.flame = G.make_flame(flame_arrays, n_shape, n_exp, canonical_pose, device, dtype)
        fl = self.flame
        verts, feat, tf = G.flame_lbs(fl, fl.canonical_exp, fl.canonical_pose)
        self.cano_verts, self.cano_feat, self.cano_tf = verts[0], feat, _ghost(tf)
        self.bg = torch.ones(3, dtype=dtype, device=device)

    def render(self, params, state, expression, pose, cam, grad=False):
        fl, cfg = self.flame, self.mcfg
        pts = params["points"]
        n = pts.shape[0]
        _, feat, tf = G.flame_lbs(fl, expression[None], pose[None])
        tf = _ghost(tf)
        color_f, scale_f, rot_f, opac_f = geometry_net(params["geometry"], pts.detach())
        shapedirs, posedirs, lbs, pc = deformer_net(params["deformer"], pts, fl.n_exp)
        ce = fl.canonical_exp
        p_orig = inverse_pts(pc, ce.expand(n, ce.shape[1]),
                             self.cano_tf.expand((n,) + self.cano_tf.shape[1:]),
                             self.cano_feat.expand(n, 36), shapedirs, posedirs, lbs)
        pd = forward_pts(p_orig, expression.expand(n, expression.shape[0]),
                         tf.expand((n,) + tf.shape[1:]), feat.expand(n, 36),
                         shapedirs, posedirs, lbs)
        d_scale, d_rot, d_opac, d_color = gaussian_net(params["gaussian"],
                                                       pd.detach() - pc.detach())
        color = torch.sigmoid(color_f + d_color)
        scale = torch.sigmoid(scale_f + d_scale) * 0.025 / cfg["scene_scale"]
        scale = torch.exp(torch.log(torch.clamp_min(scale + state["radius"], 1e-12)))
        op = torch.sigmoid(opac_f + d_opac)
        # the camera's translation scaled by cam_scale
        scam = G.camera_t(cam["R"], cam["T"] * cfg["cam_scale"], cam["fov"], cam["fov"],
                          cam["w"], cam["h"])
        soa, depth, radius = raster.preprocess(scam, pd, scale, rot_f + d_rot, op, color,
                                               state["alive"])
        if grad is None:
            return soa, depth, radius
        img, _ = raster.blend(soa, depth, radius, cam["w"], cam["h"], self.bg, grad=grad)
        with torch.no_grad():
            d2 = pc @ self.cano_verts.T
            d2.mul_(-2.0).add_(torch.sum(pc ** 2, -1, keepdim=True)).add_(
                torch.sum(self.cano_verts ** 2, -1)[None, :])
            idx = torch.argmin(d2, dim=-1)
        return img, {"index": idx, "shapedirs": shapedirs, "posedirs": posedirs, "lbs": lbs}


def _blur(n, size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    B = np.zeros((n, n), np.float32)
    for i, wt in enumerate(g):
        off = i - size // 2
        idx = np.arange(max(0, -off), min(n, n - off))
        B[idx, idx + off] = wt
    return B


def d_ssim(a, b):
    """1 - SSIM, 11x11 Gaussian window (sigma 1.5), zero-padded, of [H, W, 3]."""
    x, y = a.permute(2, 0, 1), b.permute(2, 0, 1)
    c, h, w = x.shape
    Bh = torch.as_tensor(_blur(h), device=a.device).to(a.dtype)
    Bw = torch.as_tensor(_blur(w), device=a.device).to(a.dtype)
    s = torch.cat([x, y, x * x, y * y, x * y], 0)
    s = torch.einsum("hH,cHw->chw", Bh, s)
    s = torch.einsum("chw,Ww->chW", s, Bw)
    m1, m2 = s[:c], s[c:2 * c]
    s1, s2, s12 = s[2 * c:3 * c] - m1 * m1, s[3 * c:4 * c] - m2 * m2, s[4 * c:] - m1 * m2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * m1 * m2 + C1) * (2 * s12 + C2)) / ((m1 * m1 + m2 * m2 + C1) * (s1 + s2 + C2))
    return 1.0 - torch.mean(ssim)


def loss(mono: Mono, lcfg: dict, img, gt, out, alive):
    """rgb (l1) + dssim + the lbs / posedirs / shapedirs distillation to
    FLAME's values at each point's nearest canonical vertex."""
    fl = mono.flame
    total = lcfg["rgb_weight"] * torch.mean(torch.abs(img - gt))
    if lcfg["dssim_weight"] > 0:
        total = total + lcfg["dssim_weight"] * d_ssim(img, gt)
    idx, n = out["index"], out["index"].shape[0]
    a = alive.to(img.dtype)[:, None]
    denom = torch.clamp_min(a.sum(), 1.0)

    def mse(p, q):
        return torch.sum(torch.mean((p - q) ** 2, dim=-1, keepdim=True) * a) / denom

    gt_lbs = fl.lbs_weights[idx]
    gt_lbs = torch.cat([torch.zeros_like(gt_lbs[:, :1]), gt_lbs], dim=-1)
    lw = lcfg["lbs_weight"]
    total = total + mse(out["lbs"], gt_lbs) * lw * 0.1
    gt_pd = fl.posedirs.reshape(36, -1, 3).permute(1, 0, 2)[idx]
    total = total + mse(out["posedirs"].reshape(n, -1) * 10, gt_pd.reshape(n, -1) * 10) * lw * 10
    n_exp = out["shapedirs"].shape[-1]
    gt_sd = fl.shapedirs[..., -n_exp:][idx] if lcfg["dataset_type"] == "insta" else \
        fl.shapedirs[..., fl.n_shape:][idx]
    total = total + mse(out["shapedirs"].reshape(n, -1) * 10, gt_sd.reshape(n, -1) * 10) * lw * 10
    return total


def _flat(params):
    out = {"points": params["points"]}
    for net in ("geometry", "deformer", "gaussian", "rendering"):
        out.update({f"{net}.{k}": v for k, v in params[net].items()})
    return out


def _nest(flat):
    out = {"points": flat["points"]}
    for net in ("geometry", "deformer", "gaussian", "rendering"):
        out[net] = {k.split(".", 1)[1]: v for k, v in flat.items() if k.startswith(net + ".")}
    return out


def train_steps(mono: Mono, lcfg: dict, lr: float, params0: dict, state: dict, frames,
                n_steps: int):
    """``n_steps`` steps from ``params0`` (``points`` and each network's
    weights by name), one Adam rate for every tensor; frame i a dict of
    ``expr``, ``pose``, ``cam`` (R, T, fov, w, h) and ``gt``. Returns
    (losses, the first step's gradients, the parameters after the last
    step), flat by ``points`` and ``<net>.<weight>``."""
    params = {k: v.detach().clone() for k, v in _flat(params0).items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first = [], None
    for i in range(n_steps):
        f = frames[i]
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        img, out = mono.render(_nest(leaves), state, f["expr"], f["pose"], f["cam"], grad=True)
        total = loss(mono, lcfg, img, f["gt"], out, state["alive"])
        grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        losses.append(float(total.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        count = torch.tensor(float(i + 1), device=params["points"].device)
        c1, c2 = 1.0 - B1 ** count, 1.0 - B2 ** count
        with torch.no_grad():
            for k in params:
                mu[k] = B1 * mu[k] + (1 - B1) * grads[k]
                nu[k] = B2 * nu[k] + (1 - B2) * grads[k] * grads[k]
                params[k] = params[k] - lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + EPS)
        del leaves, img, out, total, grads
    return losses, first, params
