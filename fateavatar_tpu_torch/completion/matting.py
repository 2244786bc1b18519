"""MODNet portrait matting for the completion pipeline.

Port of ``fateavatar_tpu/completion/matting.py``. The reference's stage ⑧
runs MODNet (modnet_photographic_portrait_matting) to matte pasted pseudo
views and extract torso boundaries (train/completion.py:888-1028): a
MobileNetV2 backbone + low-resolution (semantic), high-resolution (detail)
and fusion branches with IBNorm (half batch-norm, half instance-norm) conv
blocks. :class:`MODNet` holds the official ``state_dict``'s tensors under
their names and layouts; :func:`load_modnet_from_torch` reads the public
checkpoint (``module.`` prefix stripped). Without weights the pipeline
keeps its alpha-threshold fallback and the BiSeNet head-mask path
(``completion/segmentation.py``).

Inference is the MODNet eval path: only the fusion matte is produced (the
semantic/detail heads exist in checkpoints but are train-time outputs).
Images are NHWC at the boundaries, NCHW inside (cuDNN convolutions; the JAX
graph is plain XLA). ``jax.image.resize(..., "linear")`` antialiases, so
every resize here is ``F.interpolate(..., antialias=True)``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from fateavatar_tpu_torch.completion.flatnet import (
    FlatNet, Params, Spec, batch_norm, is_bn_stat, load_flat, random_from_spec,
    zeros_from_spec,
)

ENC_CHANNELS = (16, 24, 32, 96, 1280)   # MobileNetV2 taps used by MODNet
HR_CHANNELS = 32

# (t expansion, c out, n repeats, s stride): MobileNetV2 paper table 2
_MBV2 = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
         (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def modnet_param_spec() -> Spec:
    """Every tensor of the checkpoint (names and shapes of the JAX
    package's ``modnet_random_params``, in its order), with its init."""
    p: Spec = {}

    def conv(name, i, o, k=3, groups=1, bias=False):
        p[f"{name}.weight"] = ((o, i // groups, k, k), 1.0 / math.sqrt(i // groups * k * k))
        if bias:
            p[f"{name}.bias"] = ((o,), "zeros")

    def bn(name, c):
        p[f"{name}.weight"] = ((c,), "ones")
        p[f"{name}.bias"] = ((c,), "zeros")
        p[f"{name}.running_mean"] = ((c,), "zeros")
        p[f"{name}.running_var"] = ((c,), "ones")

    def ibnorm(name, c):
        # MODNet IBNorm: bnorm = c//2 channels, inorm = the rest
        bn(f"{name}.bnorm", c // 2)
        p[f"{name}.inorm.weight"] = ((c - c // 2,), "ones")
        p[f"{name}.inorm.bias"] = ((c - c // 2,), "zeros")

    def cir(name, i, o, k=3, with_ibn=True, bias=True):
        conv(f"{name}.layers.0", i, o, k, bias=bias)
        if with_ibn:
            ibnorm(f"{name}.layers.1", o)

    # backbone
    pre = "backbone.model.features"
    conv(f"{pre}.0.0", 3, 32, 3)
    bn(f"{pre}.0.1", 32)
    idx, in_c = 1, 32
    for t, c, n, s in _MBV2:
        for i in range(n):
            name = f"{pre}.{idx}.conv"
            hid = in_c * t
            if t != 1:
                conv(f"{name}.0", in_c, hid, 1)
                bn(f"{name}.1", hid)
                li = 3
            else:
                li = 0
            conv(f"{name}.{li}", hid, hid, 3, groups=hid)
            bn(f"{name}.{li + 1}", hid)
            conv(f"{name}.{li + 3}", hid, c, 1)
            bn(f"{name}.{li + 4}", c)
            in_c = c
            idx += 1
    conv(f"{pre}.18.0", in_c, 1280, 1)
    bn(f"{pre}.18.1", 1280)

    # lr branch
    e = ENC_CHANNELS
    p["lr_branch.se_block.fc.0.weight"] = ((e[4] // 4, e[4]), 1.0 / math.sqrt(e[4]))
    p["lr_branch.se_block.fc.2.weight"] = ((e[4], e[4] // 4), 1.0 / math.sqrt(e[4] // 4))
    cir("lr_branch.conv_lr16x", e[4], e[3], 5)
    cir("lr_branch.conv_lr8x", e[3], e[2], 5)
    cir("lr_branch.conv_lr", e[2], 1, 3, with_ibn=False)

    # hr branch
    hr = HR_CHANNELS
    cir("hr_branch.tohr_enc2x", e[0], hr, 1)
    cir("hr_branch.conv_enc2x", hr + 3, hr)
    cir("hr_branch.tohr_enc4x", e[1], hr, 1)
    cir("hr_branch.conv_enc4x", 2 * hr, 2 * hr)
    cir("hr_branch.conv_hr4x.0", 2 * hr + e[2] + 3, 2 * hr)
    cir("hr_branch.conv_hr4x.1", 2 * hr, 2 * hr)
    cir("hr_branch.conv_hr4x.2", 2 * hr, hr)
    cir("hr_branch.conv_hr2x.0", 2 * hr, 2 * hr)
    cir("hr_branch.conv_hr2x.1", 2 * hr, hr)
    cir("hr_branch.conv_hr2x.2", hr, hr)
    cir("hr_branch.conv_hr2x.3", hr, hr)
    cir("hr_branch.conv_hr.0", hr + 3, hr)
    cir("hr_branch.conv_hr.1", hr, 1, 1, with_ibn=False)

    # fusion branch
    cir("f_branch.conv_lr4x", e[2], hr, 5)
    cir("f_branch.conv_f2x", 2 * hr, hr)
    cir("f_branch.conv_f.0", hr + 3, hr // 2)
    cir("f_branch.conv_f.1", hr // 2, 1, 1, with_ibn=False)
    return p


class MODNet(FlatNet):
    """MODNet's tensors by their checkpoint names: zeros, or ``params``.
    ``forward(img)`` is the matte."""

    def __init__(self, params: Params = None, device="cuda"):
        super().__init__(params if params is not None
                         else zeros_from_spec(modnet_param_spec(), device), is_bn_stat)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return modnet_matte(self.params(), img)


def modnet_random_params(generator: torch.Generator, device="cuda") -> Params:
    """Seeded random parameters with checkpoint-exact names and shapes
    (tests, the smoke run); the draws are torch's, not ``jax.random``'s."""
    return random_from_spec(modnet_param_spec(), generator, device)


def modnet_from_arrays(raw: Dict[str, np.ndarray], device="cuda") -> MODNet:
    """A :class:`MODNet` holding ``raw`` (checkpoint name -> array); names
    it does not use (BN counters) are ignored, a missing one raises."""
    net = MODNet(device=device)
    load_flat(net, raw, "MODNet")
    return net


def load_modnet_from_torch(path: str, device="cuda") -> MODNet:
    """The public MODNet checkpoint (DataParallel state_dict with
    ``module.`` prefixes) as a :class:`MODNet` on ``device``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        if not hasattr(v, "detach"):
            continue
        k = k[len("module."):] if k.startswith("module.") else k
        out[k] = v.detach().cpu().numpy()
    if "lr_branch.conv_lr8x.layers.0.weight" not in out:
        raise ValueError(f"{path}: not a MODNet checkpoint "
                         f"(missing lr_branch keys)")
    return modnet_from_arrays(out, device)


# ---------------------------------------------------------------------------
# primitives, NCHW
# ---------------------------------------------------------------------------

def _conv(p, name, x, stride=1, groups=1, dilation=1):
    w = p[f"{name}.weight"]
    pad = ((w.shape[2] - 1) * dilation) // 2
    return F.conv2d(x, w, p.get(f"{name}.bias"), stride=stride, padding=pad,
                    dilation=dilation, groups=groups)


def _inorm(p, name, x, eps=1e-5):
    mean = torch.mean(x, dim=(2, 3), keepdim=True)
    var = torch.var(x, dim=(2, 3), keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * p[f"{name}.weight"][:, None, None] + p[f"{name}.bias"][:, None, None]


def _ibnorm(p, name, x):
    """IBNorm: first half channels batch-normed, second half instance-normed
    (MODNet src/models/modnet.py IBNorm)."""
    half = p[f"{name}.bnorm.weight"].shape[0]
    bn = batch_norm(p, f"{name}.bnorm", x[:, :half])
    inorm = _inorm(p, f"{name}.inorm", x[:, half:])
    return torch.cat([bn, inorm], dim=1)


def _conv_ibn_relu(p, name, x, stride=1, with_ibn=True, with_relu=True):
    """Conv2dIBNormRelu == Sequential(conv, IBNorm, ReLU) -> layers.{0,1,2}."""
    y = _conv(p, f"{name}.layers.0", x, stride)
    if with_ibn:
        y = _ibnorm(p, f"{name}.layers.1", y)
    if with_relu:
        y = F.relu(y)
    return y


def _se_block(p, name, x):
    """Squeeze-excitation over channels (MODNet SEBlock: pool + 2 linears)."""
    w = torch.mean(x, dim=(2, 3))                                 # [N, C]
    w = F.relu(w @ p[f"{name}.fc.0.weight"].T)                    # fc.1 = ReLU
    w = torch.sigmoid(w @ p[f"{name}.fc.2.weight"].T)             # fc.3 = Sigmoid
    return x * w[:, :, None, None]


def _resize(x, scale):
    """``jax.image.resize(..., "linear")`` by ``scale``: antialiased, to
    ``round(side * scale)``."""
    h, w = x.shape[2:]
    return F.interpolate(x, size=(int(round(h * scale)), int(round(w * scale))),
                         mode="bilinear", align_corners=False, antialias=True)


# ---------------------------------------------------------------------------
# MobileNetV2 backbone (features.0 .. features.18)
# ---------------------------------------------------------------------------

def _inverted_residual(p, name, x, stride):
    """MODNet's MobileNetV2 InvertedResidual: a flat Sequential
    [expand 1x1, bn, relu6, dw 3x3, bn, relu6, project 1x1, bn] -> indices
    conv.{0,1,3,4,6,7} (t=1 blocks drop the expansion -> conv.{0,1,3,4})."""
    inp = x.shape[1]
    h = x
    li = 0
    if f"{name}.conv.0.weight" in p and p[f"{name}.conv.0.weight"].shape[2] == 1:
        # 1x1 expand conv + bn + relu6
        h = _conv(p, f"{name}.conv.0", h)
        h = F.relu6(batch_norm(p, f"{name}.conv.1", h))
        li = 3
    # depthwise 3x3
    h = _conv(p, f"{name}.conv.{li}", h, stride=stride, groups=h.shape[1])
    h = F.relu6(batch_norm(p, f"{name}.conv.{li + 1}", h))
    # 1x1 project (linear)
    h = _conv(p, f"{name}.conv.{li + 3}", h)
    h = batch_norm(p, f"{name}.conv.{li + 4}", h)
    if stride == 1 and inp == h.shape[1]:
        h = h + x
    return h


def _backbone(p, x):
    """MobileNetV2 features with MODNet's taps. Returns enc2x, enc4x, enc32x
    (channels 16, 24, 1280: ENC_CHANNELS[0,1,4])."""
    pre = "backbone.model.features"
    # features.0: conv 3x3 s2 + bn + relu6
    h = _conv(p, f"{pre}.0.0", x, stride=2)
    h = F.relu6(batch_norm(p, f"{pre}.0.1", h))
    idx = 1
    taps = {}
    for t, c, n, s in _MBV2:
        for i in range(n):
            h = _inverted_residual(p, f"{pre}.{idx}", h, stride=s if i == 0 else 1)
            idx += 1
            if idx == 2:
                taps["enc2x"] = h
            elif idx == 4:
                taps["enc4x"] = h
    # features.18: conv 1x1 -> 1280 + bn + relu6
    h = _conv(p, f"{pre}.18.0", h)
    h = F.relu6(batch_norm(p, f"{pre}.18.1", h))
    taps["enc32x"] = h
    return taps["enc2x"], taps["enc4x"], taps["enc32x"]


# ---------------------------------------------------------------------------
# branches
# ---------------------------------------------------------------------------

def modnet_logits(p: Params, img: torch.Tensor) -> torch.Tensor:
    """The fusion branch's pre-sigmoid output: img [N,H,W,3] in [0,1] (H, W
    multiples of 32) -> [N,H,W,1]."""
    x = img.permute(0, 3, 1, 2) * 2.0 - 1.0                 # MODNet norm
    enc2x, enc4x, enc32x = _backbone(p, x)

    # LR (semantic) branch
    lr = _se_block(p, "lr_branch.se_block", enc32x)
    lr16x = _conv_ibn_relu(p, "lr_branch.conv_lr16x", _resize(lr, 2.0))
    lr8x = _conv_ibn_relu(p, "lr_branch.conv_lr8x", _resize(lr16x, 2.0))

    # HR (detail) branch
    img2x = _resize(x, 0.5)
    img4x = _resize(x, 0.25)
    e2 = _conv_ibn_relu(p, "hr_branch.tohr_enc2x", enc2x)
    hr4x = _conv_ibn_relu(p, "hr_branch.conv_enc2x", torch.cat([img2x, e2], 1), stride=2)
    e4 = _conv_ibn_relu(p, "hr_branch.tohr_enc4x", enc4x)
    hr4x = _conv_ibn_relu(p, "hr_branch.conv_enc4x", torch.cat([hr4x, e4], 1))
    lr4x = _resize(lr8x, 2.0)
    h = torch.cat([hr4x, lr4x, img4x], 1)
    for i in range(3):
        h = _conv_ibn_relu(p, f"hr_branch.conv_hr4x.{i}", h)
    hr2x = _resize(h, 2.0)
    h = torch.cat([hr2x, e2], 1)
    for i in range(4):
        h = _conv_ibn_relu(p, f"hr_branch.conv_hr2x.{i}", h)
    hr2x = h

    # fusion branch
    lr4x = _conv_ibn_relu(p, "f_branch.conv_lr4x", _resize(lr8x, 2.0))
    lr2x = _resize(lr4x, 2.0)
    f2x = _conv_ibn_relu(p, "f_branch.conv_f2x", torch.cat([lr2x, hr2x], 1))
    f = torch.cat([_resize(f2x, 2.0), x], 1)
    f = _conv_ibn_relu(p, "f_branch.conv_f.0", f)
    f = _conv_ibn_relu(p, "f_branch.conv_f.1", f, with_ibn=False, with_relu=False)
    return f.permute(0, 2, 3, 1)


def modnet_matte(p: Params, img: torch.Tensor) -> torch.Tensor:
    """img [N,H,W,3] in [0,1] (H, W multiples of 32) -> matte [N,H,W,1]."""
    return torch.sigmoid(modnet_logits(p, img))


class MODNetMatting:
    """Stage-⑧ matting plugin: callable on one [H,W,3] image in [0,1],
    returns the [H,W] matte (the ``matting_fn`` contract of
    completion/pseudo.py). The [0,1] image is padded with zeros to multiples
    of 32 before MODNet's ``*2-1``, so padded pixels enter as -1, as in the
    JAX package. Runs on the network's device."""

    def __init__(self, net: MODNet):
        self.net = net
        self.device = next(net.parameters()).device

    @torch.no_grad()
    def __call__(self, img) -> np.ndarray:
        h, w = np.shape(img)[:2]
        x = torch.as_tensor(np.asarray(img, np.float32), device=self.device)[None]
        ph, pw = (-h) % 32, (-w) % 32
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        return self.net(x)[0, :h, :w, 0].cpu().numpy()


def torso_boundary(matte: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Lowest foreground row per column: the torso-boundary extraction of
    completion.py:987-1026, used to clamp pseudo-view masks."""
    fg = matte > threshold
    rows = np.arange(matte.shape[0])[:, None]
    return np.where(fg.any(axis=0), np.max(np.where(fg, rows, -1), axis=0), -1)
