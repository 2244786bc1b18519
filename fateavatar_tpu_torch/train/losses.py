"""The losses (port of ``fateavatar_tpu/train/losses.py``: FateAvatar's,
train/loss.py:69-199 of the reference, and the four baselines',
train/loss.py:203-517).

Images are [H, W, 3] (or [B, H, W, 3]) float32 in [0, 1], the JAX package's
layout. Every term is a plain function of tensors; :class:`FateAvatarLoss`
and the baselines' loss classes compose them from a weights config. The VGG16 perceptual loss runs its
convolutions through ``torch.nn.functional.conv2d`` (the JAX package leaves
them to XLA, outside any Pallas kernel); its weights are random from a
``torch.Generator`` or loaded from a torchvision state dict / converted
``.npz``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fateavatar_tpu_torch.ops.mesh import laplacian_smoothing

# ---------------------------------------------------------------------------
# image terms
# ---------------------------------------------------------------------------


def l1_loss(pred, gt):
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred, gt):
    return torch.mean((pred - gt) ** 2)


def huber_loss(pred, gt, alpha: float = 0.1):
    """FlashAvatar's Huber loss (train/loss.py:217-221)."""
    diff = torch.abs(pred - gt)
    quad = 0.5 * diff ** 2
    lin = alpha * (diff - 0.5 * alpha)
    return torch.mean(torch.where(diff < alpha, quad, lin))


def as_float_rgb(x):
    """uint8 ground truth (the Trainer's device frame cache) as float32 in
    [0, 1]; float input passes through."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x


@functools.lru_cache(maxsize=8)
def _banded_blur_matrix(size: int, n: int) -> np.ndarray:
    """[n, n] banded matrix of the 1-D Gaussian window (sigma 1.5) with
    zero-padding boundaries ('SAME' convolution)."""
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * 1.5 ** 2))
    g = g / g.sum()
    B = np.zeros((n, n), np.float32)
    for i, w in enumerate(g):
        off = i - size // 2
        idx = np.arange(max(0, -off), min(n, n - off))
        B[idx, idx + off] = w
    return B


@functools.lru_cache(maxsize=8)
def _blur_matrix(size: int, n: int, device: torch.device) -> torch.Tensor:
    """:func:`_banded_blur_matrix` on ``device``, copied there once: a copy
    from the host on every call could not be captured in a CUDA graph."""
    return torch.as_tensor(_banded_blur_matrix(size, n), device=device)


def d_ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11):
    """1 - SSIM with an 11x11 sigma-1.5 Gaussian window
    (tools/loss_utils/dssim.py:28-58), the separable blur as two banded
    matrix products, as the JAX package computes it. [H,W,3] or [B,H,W,3]."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    x = img1.permute(0, 3, 1, 2)
    y = img2.permute(0, 3, 1, 2)
    b, c, h, w = x.shape
    Bh = _blur_matrix(window_size, h, x.device)
    Bw = _blur_matrix(window_size, w, x.device)
    s = torch.cat([x, y, x * x, y * y, x * y], dim=1).reshape(-1, h, w)
    blurred = torch.einsum("hH,cHw->chw", Bh, s)
    blurred = torch.einsum("chw,Ww->chW", blurred, Bw).reshape(b, 5 * c, h, w)
    mu1, mu2 = blurred[:, :c], blurred[:, c:2 * c]
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blurred[:, 2 * c:3 * c] - mu1_sq
    s2 = blurred[:, 3 * c:4 * c] - mu2_sq
    s12 = blurred[:, 4 * c:] - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return 1.0 - torch.mean(ssim_map)


def psnr(pred, gt):
    return -10.0 * torch.log10(torch.mean((pred - gt) ** 2))


# ---------------------------------------------------------------------------
# VGG16 perceptual loss (tools/loss_utils/vgg_feature.py:7-47)
# ---------------------------------------------------------------------------

_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512)
# block boundaries after convs: [:2], [2:4], [4:7], [7:10] with pools between
_BLOCK_ENDS = (2, 4, 7, 10)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=8)
def _imagenet_stats(device: torch.device):
    """ImageNet mean and std as [1, 3, 1, 1] tensors on ``device``, copied
    there once (a copy from the host per call could not be captured in a
    CUDA graph)."""
    return tuple(torch.tensor(v, device=device)[None, :, None, None]
                 for v in (_IMAGENET_MEAN, _IMAGENET_STD))


def vgg16_random_params(generator: torch.Generator, device="cuda",
                        dtype=torch.float32):
    """Random He-initialised VGG16 conv stack [(w [O,I,3,3], b [O]), ...]
    (the repo ships no weights). ``generator`` lives on ``device``."""
    params = []
    cin = 3
    for v in _VGG_CFG:
        if v == "M":
            continue
        w = torch.randn((v, cin, 3, 3), generator=generator, device=device,
                        dtype=dtype) * np.sqrt(2.0 / (cin * 9))
        params.append((w, torch.zeros((v,), device=device, dtype=dtype)))
        cin = v
    return params


def load_vgg16_from_torch(path: str, device="cuda"):
    """VGG16 conv weights from a converted ``.npz`` (w0, b0, ...) or a
    torchvision state dict (``features.<i>.weight`` / ``.bias``)."""
    if path.endswith(".npz"):
        data = np.load(path)
        n = sum(1 for k in data.files if k.startswith("w"))
        return [(torch.as_tensor(data[f"w{i}"], device=device),
                 torch.as_tensor(data[f"b{i}"], device=device)) for i in range(n)]
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    params = []
    layer = 0
    for v in _VGG_CFG:
        if v == "M":
            layer += 1
            continue
        params.append((sd[f"features.{layer}.weight"].to(device),
                       sd[f"features.{layer}.bias"].to(device)))
        layer += 2  # conv + relu
    return params


def _bilinear_resize(x, size: int):
    """NCHW bilinear resize with the antialiasing ``jax.image.resize``
    applies when it downsamples (a triangle kernel widened by the scale)."""
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


def _maxpool2x2(x):
    """Non-overlapping 2x2/2 max as reshape + amax: like the JAX package's
    reshape + max, its gradient splits evenly between tied maxima."""
    b, c, h, w = x.shape
    return torch.amax(x.reshape(b, c, h // 2, 2, w // 2, 2), dim=(3, 5))


def vgg16_features(params, x, dtype=None):
    """x: [B, 3, H, W] normalized. Returns the 4 block outputs (NCHW)."""
    if dtype is not None:
        x = x.to(dtype)
    feats = []
    i = 0
    for end in _BLOCK_ENDS:
        while i < end:
            w, b = params[i]
            if dtype is not None:
                w, b = w.to(dtype), b.to(dtype)
            x = F.relu(F.conv2d(x, w, b, padding=1))
            i += 1
        feats.append(x)
        if end != _BLOCK_ENDS[-1]:
            x = _maxpool2x2(x)
    return feats


def vgg_perceptual_loss(params, pred, gt, resize: bool = True, dtype=None):
    """Sum of L1 feature distances over 4 VGG16 blocks after ImageNet
    normalization and a 224 resize (vgg_feature.py:30-47). pred / gt are
    [H,W,3] or [B,H,W,3]; ``dtype`` optionally runs the conv stack in lower
    precision, the reductions stay float32. Normalization and resize run in
    float32 (the JAX package casts before them; PyTorch's antialiased
    resize has no bfloat16 kernel on the CPU)."""
    if pred.dim() == 3:
        pred, gt = pred[None], gt[None]
    x = pred.permute(0, 3, 1, 2)
    y = gt.permute(0, 3, 1, 2)
    mean, std = _imagenet_stats(x.device)
    x = (x - mean) / std
    y = (y - mean) / std
    if resize:
        x = _bilinear_resize(x, 224)
        y = _bilinear_resize(y, 224)
    # separate stacks: gt is constant, so its pass needs no input gradient
    fx = vgg16_features(params, x, dtype)
    fy = vgg16_features(params, y.detach(), dtype)
    loss = 0.0
    for a, b in zip(fx, fy):
        loss = loss + torch.mean(torch.abs(a.float() - b.float()))
    return loss


# ---------------------------------------------------------------------------
# geometric / splat regularizers
# ---------------------------------------------------------------------------


def scale_anisotropy_loss(scale, alive, threshold: float):
    """relu(max/min - threshold) over ALIVE splats (train/loss.py:145-151).
    ``scale`` is the ACTIVATED scale [N, 3]."""
    smax = torch.amax(scale, dim=-1)
    smin = torch.clamp_min(torch.amin(scale, dim=-1), 1e-12)
    reg = F.relu(smax / smin - threshold)
    w = alive.to(scale.dtype)
    return torch.sum(reg * w) / torch.clamp_min(torch.sum(w), 1.0)


def rotation_loss(raw_rot, alive):
    """Penalize x/z axis-angle components (train/loss.py:160-164)."""
    w = alive.to(raw_rot.dtype)
    denom = torch.clamp_min(torch.sum(w), 1.0)
    return (torch.sum(raw_rot[..., 0] ** 2 * w)
            + torch.sum(raw_rot[..., 2] ** 2 * w)) / denom


def laplacian_delta_loss(verts, verts_orig, faces):
    """|| L verts - L verts_orig ||^2 summed over xyz, meaned over verts —
    the personalization deltas' high-frequency component
    (train/loss.py:112-121; the basis Laplacian detached)."""
    lap = laplacian_smoothing(verts, faces)
    lap_orig = laplacian_smoothing(verts_orig, faces).detach()
    return torch.mean(torch.sum((lap - lap_orig) ** 2, dim=-1))


def flame_delta_loss(verts, verts_orig):
    """(verts - verts_orig)^2 mean (train/loss.py:192-197)."""
    return torch.mean((verts - verts_orig) ** 2)


# ---------------------------------------------------------------------------
# composed loss
# ---------------------------------------------------------------------------


@dataclass
class FateAvatarLossConfig:
    rgb_type: str = "l1"
    rgb_weight: float = 1.0
    vgg_weight: float = 0.0
    # compute dtype of the VGG conv stack: None = float32, or "bfloat16"
    vgg_dtype: Optional[str] = None
    dssim_weight: float = 0.0
    scale_weight: float = 0.0
    scale_threshold: float = 9.0
    lpips_weight: float = 0.0
    rot_weight: float = 0.0
    laplacian_weight: float = 0.0
    normal_weight: float = 0.0
    flame_weight: float = 0.0


class FateAvatarLoss:
    """Composable loss (train/loss.py:69-199). Construct once, then call on
    the forward's output dict and ``{"rgb": gt}``. ``vgg_params``: VGG16
    weights or None (term disabled). The LPIPS and normal-consistency terms
    are not ported (the flagship config weights them 0) and raise."""

    def __init__(self, cfg: FateAvatarLossConfig, vgg_params=None):
        self.cfg = cfg
        self.vgg_params = vgg_params
        if cfg.vgg_weight > 0 and vgg_params is None:
            raise ValueError(
                "vgg_weight > 0 requires vgg_params "
                "(losses.load_vgg16_from_torch or vgg16_random_params)")
        for name in ("lpips_weight", "normal_weight"):
            if getattr(cfg, name) > 0:
                raise NotImplementedError(f"loss term {name} > 0 is not ported")
        self._vgg_dtype = (None if cfg.vgg_dtype in (None, "float32")
                           else getattr(torch, cfg.vgg_dtype))

    def __call__(self, model_out: dict, ground_truth: dict):
        cfg = self.cfg
        pred = model_out["rgb_image"]
        gt = as_float_rgb(ground_truth["rgb"])

        rgb = l1_loss(pred, gt) if cfg.rgb_type == "l1" else l2_loss(pred, gt)
        loss = rgb * cfg.rgb_weight
        out = {"rgb_loss": rgb}

        if cfg.vgg_weight > 0:
            v = vgg_perceptual_loss(self.vgg_params, pred, gt, dtype=self._vgg_dtype)
            out["vgg_loss"] = v
            loss = loss + v * cfg.vgg_weight
        if cfg.dssim_weight > 0:
            v = d_ssim(pred, gt)
            out["dssim_loss"] = v
            loss = loss + v * cfg.dssim_weight
        if cfg.scale_weight > 0:
            v = scale_anisotropy_loss(model_out["scale"], model_out["alive"],
                                      cfg.scale_threshold)
            out["scale_loss"] = v
            loss = loss + v * cfg.scale_weight
        if cfg.rot_weight > 0:
            v = rotation_loss(model_out["raw_rot"], model_out["alive"])
            out["rot_loss"] = v
            loss = loss + v * cfg.rot_weight
        if cfg.laplacian_weight > 0:
            v = laplacian_delta_loss(model_out["verts"], model_out["verts_orig"],
                                     model_out["faces"])
            out["laplacian_loss"] = v
            loss = loss + v * cfg.laplacian_weight
        if cfg.flame_weight > 0:
            v = flame_delta_loss(model_out["verts"], model_out["verts_orig"])
            out["flame_loss"] = v
            loss = loss + v * cfg.flame_weight

        out["loss"] = loss
        return out


# ---------------------------------------------------------------------------
# the baselines' losses (train/loss.py:203-517)
# ---------------------------------------------------------------------------


@dataclass
class FlashAvatarLossConfig:
    huber_weight: float = 1.0
    lpips_weight: float = 0.0     # step-gated in the reference (>15k steps)
    mouth_weight: float = 40.0


class FlashAvatarLoss:
    """Huber + 40x mouth-region Huber (train/loss.py:203-255); the mouth
    term where the ground truth carries ``mouth_mask``."""

    def __init__(self, cfg: FlashAvatarLossConfig = FlashAvatarLossConfig()):
        self.cfg = cfg

    def __call__(self, model_out: dict, ground_truth: dict):
        pred, gt = model_out["rgb_image"], as_float_rgb(ground_truth["rgb"])
        loss = huber_loss(pred, gt, 0.1)
        if ground_truth.get("mouth_mask") is not None:
            m = ground_truth["mouth_mask"]
            loss = loss + self.cfg.mouth_weight * huber_loss(pred * m, gt * m, 0.1)
        return {"loss": loss * self.cfg.huber_weight, "huber_loss": loss}


@dataclass
class GaussianAvatarsLossConfig:
    rgb_weight: float = 0.8
    dssim_weight: float = 0.2
    scale_weight: float = 1.0
    xyz_weight: float = 0.01
    threshold_scale: float = 0.6
    threshold_xyz: float = 1.0


def _safe_norm(x, dim):
    """sqrt has an infinite gradient at 0 (the local xyz IS 0 at init)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-12)


class GaussianAvatarsLoss:
    """0.8 L1 + 0.2 DSSIM + local scale / xyz penalties over alive splats
    (train/loss.py:327-381)."""

    def __init__(self, cfg: GaussianAvatarsLossConfig = GaussianAvatarsLossConfig()):
        self.cfg = cfg

    def __call__(self, model_out: dict, ground_truth: dict):
        cfg = self.cfg
        pred, gt = model_out["rgb_image"], as_float_rgb(ground_truth["rgb"])
        rgb = l1_loss(pred, gt)
        loss = rgb * cfg.rgb_weight
        out = {"rgb_loss": rgb}
        if cfg.dssim_weight > 0:
            v = d_ssim(pred, gt)
            out["dssim_loss"] = v
            loss = loss + v * cfg.dssim_weight
        alive = model_out["alive"].to(pred.dtype)
        denom = torch.clamp_min(torch.sum(alive), 1.0)
        if cfg.scale_weight > 0:
            reg = F.relu(model_out["scale"] - cfg.threshold_scale)
            v = torch.sum(_safe_norm(reg, 1) * alive) / denom
            out["scale_loss"] = v
            loss = loss + v * cfg.scale_weight
        if cfg.xyz_weight > 0:
            reg = F.relu(_safe_norm(model_out["xyz"], 1) - cfg.threshold_xyz)
            v = torch.sum(reg * alive) / denom
            out["xyz_loss"] = v
            loss = loss + v * cfg.xyz_weight
        out["loss"] = loss
        return out


@dataclass
class SplattingAvatarLossConfig:
    rgb_weight: float = 1.0
    mse_weight: float = 10.0
    scale_weight: float = 1.0
    lpips_weight: float = 0.0
    scale_threshold: float = 10.0
    max_scaling: float = 0.008


class SplattingAvatarLoss:
    """L1 + 10 MSE + the mean max-scale of alive splats that are both large
    and anisotropic (train/loss.py:259-325)."""

    def __init__(self, cfg: SplattingAvatarLossConfig = SplattingAvatarLossConfig()):
        self.cfg = cfg

    def __call__(self, model_out: dict, ground_truth: dict):
        cfg = self.cfg
        pred, gt = model_out["rgb_image"], as_float_rgb(ground_truth["rgb"])
        rgb = l1_loss(pred, gt)
        loss = rgb * cfg.rgb_weight
        out = {"rgb_loss": rgb}
        if cfg.mse_weight > 0:
            v = l2_loss(pred, gt)
            out["mse_loss"] = v
            loss = loss + v * cfg.mse_weight
        if cfg.scale_weight > 0:
            scale = model_out["scale"]
            smax = torch.amax(scale, dim=-1)
            smin = torch.clamp_min(torch.amin(scale, dim=-1), 1e-12)
            bad = ((smax > cfg.max_scaling) & (smax / smin > cfg.scale_threshold)
                   & model_out["alive"])
            cnt = torch.sum(bad)
            v = torch.where(cnt > 0, torch.sum(torch.where(bad, smax, 0.0))
                            / torch.clamp_min(cnt, 1), 0.0)
            out["scale_loss"] = v
            loss = loss + v * cfg.scale_weight
        out["loss"] = loss
        return out


@dataclass
class MonoGaussianAvatarLossConfig:
    rgb_weight: float = 1.0
    vgg_weight: float = 0.0
    dssim_weight: float = 0.25
    lbs_weight: float = 10.0
    dataset_type: str = "insta"
    gt_lbs_milestones: tuple = ()
    gt_lbs_factor: float = 0.5


class MonoGaussianAvatarLoss:
    """rgb + dssim (+ vgg) + the lbs / posedirs / shapedirs distillation
    towards FLAME's values at each point's nearest canonical vertex
    (train/loss.py:385-517). ``var_expression`` optionally weights the
    shapedirs term by the inverse expression variance."""

    def __init__(self, cfg: MonoGaussianAvatarLossConfig, flame,
                 var_expression=None, vgg_params=None):
        self.cfg = cfg
        self.flame = flame
        self.var_expression = (
            None if var_expression is None else
            torch.as_tensor(var_expression, dtype=torch.float32,
                            device=flame.v_template.device))
        self.vgg_params = vgg_params
        self._lbs_scale = 1.0  # decayed at milestones (host side)

    def decay_at_epoch(self, epoch: int):
        if epoch in self.cfg.gt_lbs_milestones:
            self._lbs_scale *= self.cfg.gt_lbs_factor

    def __call__(self, model_out: dict, ground_truth: dict):
        cfg = self.cfg
        pred, gt = model_out["rgb_image"], as_float_rgb(ground_truth["rgb"])
        rgb = l1_loss(pred, gt)
        loss = rgb * cfg.rgb_weight
        out = {"rgb_loss": rgb}
        if cfg.vgg_weight > 0 and self.vgg_params is not None:
            v = vgg_perceptual_loss(self.vgg_params, pred, gt)
            out["vgg_loss"] = v
            loss = loss + v * cfg.vgg_weight
        if cfg.dssim_weight > 0:
            v = d_ssim(pred, gt)
            out["dssim_loss"] = v
            loss = loss + v * cfg.dssim_weight

        idx = model_out["index_batch"]
        n = idx.shape[0]
        flame = self.flame
        alive = model_out["alive"].to(pred.dtype)[:, None]
        denom = torch.clamp_min(torch.sum(alive), 1.0)
        lbs_w = cfg.lbs_weight * self._lbs_scale

        def masked_mse(a, b, var=None):
            d = (a - b) ** 2
            if var is not None:
                d = d / var / 50.0
            return torch.sum(torch.mean(d, dim=-1, keepdim=True) * alive) / denom

        gt_lbs = flame.lbs_weights[idx]
        if model_out["lbs_weights"].shape[-1] == 6:      # the ghost bone
            gt_lbs = torch.cat([torch.zeros_like(gt_lbs[:, :1]), gt_lbs], dim=-1)
        v = masked_mse(model_out["lbs_weights"], gt_lbs)
        out["lbs_loss"] = v
        loss = loss + v * lbs_w * 0.1

        gt_posedirs = flame.posedirs.reshape(36, -1, 3).permute(1, 0, 2)[idx]
        v = masked_mse(model_out["posedirs"].reshape(n, -1) * 10,
                       gt_posedirs.reshape(n, -1) * 10)
        out["posedirs_loss"] = v
        loss = loss + v * lbs_w * 10.0

        n_exp = model_out["shapedirs"].shape[-1]
        if cfg.dataset_type == "insta":
            gt_shapedirs = flame.shapedirs[..., -n_exp:][idx]
        else:
            gt_shapedirs = flame.shapedirs[..., flame.n_shape:][idx]
        var = None
        if self.var_expression is not None:
            var = self.var_expression.reshape(1, 1, -1)[..., :n_exp].expand(
                gt_shapedirs.shape).reshape(n, -1)
        v = masked_mse(model_out["shapedirs"].reshape(n, -1) * 10,
                       gt_shapedirs.reshape(n, -1) * 10, var=var)
        out["shapedirs_loss"] = v
        loss = loss + v * lbs_w * 10.0

        out["loss"] = loss
        return out
