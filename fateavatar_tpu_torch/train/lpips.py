"""LPIPS (Learned Perceptual Image Patch Similarity).

Port of ``fateavatar_tpu/train/lpips.py``: the reference's ``lpips`` package
(train/metrics.py:65 uses net='alex' for the eval meter; train/loss.py:91
uses net='vgg' for the optional loss term), both backbones as plain
``torch.nn.functional`` convolutions on a params container.

LPIPS(x, y) = sum_l mean_hw sum_c lin_l[c] * (nx_l - ny_l)[c]^2, where nx_l
are the channel-unit-normalized backbone features and lin_l the learned
non-negative per-channel weights (R. Zhang et al., CVPR 2018; the
richzhang/PerceptualSimilarity v0.1 forward).

Weights come from ``.npz`` files in the JAX package's format (either package
reads the other's) or straight from the official torch state dicts through
:func:`load_lpips_from_torch`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# scaling layer constants (PerceptualSimilarity lpips/lpips.py ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision alexnet.features: (out_ch, kernel, stride, pad); M = maxpool 3/2
_ALEX_CFG: Tuple = ((64, 11, 4, 2), "M", (192, 5, 1, 2), "M",
                    (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
# relu outputs tapped after convs 1..5 (lpips/pretrained_networks.py alexnet)
_ALEX_SLICE_ENDS = (1, 2, 3, 4, 5)
_ALEX_CHANS = (64, 192, 384, 256, 256)

# the full torchvision VGG16 features (13 convs, M = maxpool 2/2); taps
# after convs 2/4/7/10/13 (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
_VGG_CFG: Tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                   512, 512, 512, "M", 512, 512, 512)
_VGG_SLICE_ENDS = (2, 4, 7, 10, 13)
_VGG_CHANS = (64, 128, 256, 512, 512)


@dataclass
class LpipsParams:
    backbone: str                                   # 'alex' | 'vgg'
    convs: List[Tuple[torch.Tensor, torch.Tensor]]  # [(w [O,I,k,k], b [O])]
    lins: List[torch.Tensor]                        # [C_l] non-negative


def _conv_specs(backbone: str):
    """[(out, in, kernel, stride, pad)] per conv, the tapped conv counts and
    the tapped channels."""
    if backbone == "alex":
        cin, specs = 3, []
        for v in _ALEX_CFG:
            if v == "M":
                continue
            out, k, s, p = v
            specs.append((out, cin, k, s, p))
            cin = out
        return specs, _ALEX_SLICE_ENDS, _ALEX_CHANS
    if backbone == "vgg":
        cin, specs = 3, []
        for v in _VGG_CFG:
            if v == "M":
                continue
            specs.append((v, cin, 3, 1, 1))
            cin = v
        return specs, _VGG_SLICE_ENDS, _VGG_CHANS
    raise ValueError(f"unknown LPIPS backbone {backbone!r}")


def lpips_random_params(generator: torch.Generator, backbone: str = "alex",
                        device="cuda", dtype=torch.float32) -> LpipsParams:
    """He-initialised random LPIPS params (the repository ships no weights):
    zero biases, lin heads |N(0, 1)| / C. ``generator`` lives on ``device``."""
    specs, _, chans = _conv_specs(backbone)

    def randn(shape):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)

    convs = [(randn((out, cin, k, k)) * np.sqrt(2.0 / (cin * k * k)),
              torch.zeros((out,), device=device, dtype=dtype))
             for out, cin, k, _, _ in specs]
    lins = [torch.abs(randn((c,))) / c for c in chans]
    return LpipsParams(backbone, convs, lins)


@functools.lru_cache(maxsize=8)
def _scaling(device: torch.device):
    """The scaling layer's shift and scale as [3] tensors on ``device``,
    copied there once (a copy from the host per call could not be captured
    in a CUDA graph)."""
    return tuple(torch.tensor(v, device=device) for v in (_SHIFT, _SCALE))


def lpips_features(params: LpipsParams, x: torch.Tensor) -> List[torch.Tensor]:
    """x: [B, 3, H, W] after the scaling layer. The 5 tapped ReLU outputs."""
    alex = params.backbone == "alex"
    _, slice_ends, _ = _conv_specs(params.backbone)
    feats = []
    conv_i = 0
    for v in (_ALEX_CFG if alex else _VGG_CFG):
        if v == "M":
            # VALID windows: no padding, floor of the output size
            x = F.max_pool2d(x, 3, 2) if alex else F.max_pool2d(x, 2, 2)
            continue
        w, b = params.convs[conv_i]
        stride, pad = (v[2], v[3]) if alex else (1, 1)
        x = F.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
        conv_i += 1
        if conv_i in slice_ends:
            feats.append(x)
    return feats


def _unit_normalize(x, eps: float = 1e-10):
    """Channel-dim unit normalization (lpips normalize_tensor): the eps is
    added to the norm, outside the square root."""
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


def lpips_distance(params: LpipsParams, pred: torch.Tensor, gt: torch.Tensor,
                   normalize: bool = True) -> torch.Tensor:
    """LPIPS distance between [H,W,3] or [B,H,W,3] images: a scalar, or [B]
    for a batch of more than one. ``normalize=True`` takes [0, 1] RGB and
    rescales it to [-1, 1] first (train/metrics.py:72)."""
    if pred.dim() == 3:
        pred, gt = pred[None], gt[None]
    if normalize:
        pred = 2.0 * pred - 1.0
        gt = 2.0 * gt - 1.0
    shift, scale = _scaling(pred.device)
    fx = lpips_features(params, ((pred - shift) / scale).permute(0, 3, 1, 2))
    fy = lpips_features(params, ((gt - shift) / scale).permute(0, 3, 1, 2))
    total = 0.0
    for a, b, lin in zip(fx, fy, params.lins):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2      # [B, C, H, W]
        # the 1x1 conv with the non-negative lin weights, then the spatial mean
        total = total + torch.einsum("bchw,c->b", d, lin) / (d.shape[2] * d.shape[3])
    return torch.squeeze(total)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def save_lpips_npz(path: str, params: LpipsParams) -> None:
    """The JAX package's ``.npz`` layout: ``backbone``, ``w<i>``, ``b<i>``,
    ``lin<i>``."""
    arrs = {"backbone": np.asarray(params.backbone)}
    for i, (w, b) in enumerate(params.convs):
        arrs[f"w{i}"] = w.detach().cpu().numpy()
        arrs[f"b{i}"] = b.detach().cpu().numpy()
    for i, lin in enumerate(params.lins):
        arrs[f"lin{i}"] = lin.detach().cpu().numpy()
    np.savez(path, **arrs)


def lpips_params_from_arrays(backbone: str, convs, lins, device="cuda") -> LpipsParams:
    """LpipsParams on ``device`` from numpy arrays: ``convs`` [(w, b)],
    ``lins`` [C_l] (any shape holding C_l values)."""
    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return LpipsParams(str(backbone), [(t(w), t(b)) for w, b in convs],
                       [t(lin).reshape(-1) for lin in lins])


def load_lpips_npz(path: str, device="cuda") -> LpipsParams:
    data = np.load(path)
    n = sum(1 for k in data.files if k.startswith("w"))
    return lpips_params_from_arrays(
        str(data["backbone"]), [(data[f"w{i}"], data[f"b{i}"]) for i in range(n)],
        [data[f"lin{i}"] for i in range(5)], device)


def load_lpips_from_torch(path: str, backbone: str = "alex",
                          backbone_path: Optional[str] = None,
                          device="cuda") -> LpipsParams:
    """LpipsParams from a converted ``.npz`` or from torch checkpoints, in
    one of two layouts:

    * ``path`` = a full LPIPS state dict (``torch.save(lpips.LPIPS(
      net='alex').state_dict(), ...)``): ``net.slice{k}.{i}.weight`` backbone
      convs and ``lin{k}.model.1.weight`` heads;
    * ``path`` = the official lin-only file (lpips/weights/v0.1/alex.pth)
      plus ``backbone_path`` = a torchvision backbone state dict
      (``features.{i}.weight``)."""
    if path.endswith(".npz"):
        return load_lpips_npz(path, device)

    sd = dict(torch.load(path, map_location="cpu", weights_only=True))
    lins = []
    for k in range(5):
        key = f"lin{k}.model.1.weight"
        if key not in sd:
            raise ValueError(f"missing {key} in {path}: not an LPIPS checkpoint")
        lins.append(sd[key].numpy().reshape(-1))

    conv_sd = sd
    full = any(k.startswith("net.") for k in sd)
    if not full:
        if backbone_path is None:
            raise ValueError(
                f"{path} carries only the lin heads; pass backbone_path="
                "<torchvision alexnet/vgg16 state dict>")
        conv_sd = dict(torch.load(backbone_path, map_location="cpu", weights_only=True))

    specs, _, chans = _conv_specs(backbone)
    for lin, c in zip(lins, chans):
        if lin.shape[0] != c:
            raise ValueError(f"lin head width {lin.shape[0]} != backbone {backbone} "
                             f"channels {c}: wrong backbone?")

    if full:   # lpips layout: net.slice{k}.{idx}.weight with idx global
        keys = sorted((k for k in conv_sd if k.startswith("net.") and k.endswith(".weight")),
                      key=lambda k: (int(k.split(".")[1][5:]), int(k.split(".")[2])))
        pairs = [(k, k[:-len("weight")] + "bias") for k in keys]
    else:      # torchvision layout: features.{i}.weight
        idxs = sorted(int(k.split(".")[1]) for k in conv_sd
                      if k.startswith("features.") and k.endswith(".weight"))
        pairs = [(f"features.{i}.weight", f"features.{i}.bias") for i in idxs]
    convs = [(conv_sd[w].numpy(), conv_sd[b].numpy()) for w, b in pairs]

    if len(convs) != len(specs):
        raise ValueError(f"found {len(convs)} convs, expected {len(specs)} for {backbone}")
    for (w, _), (out, cin, k, _, _) in zip(convs, specs):
        if tuple(w.shape) != (out, cin, k, k):
            raise ValueError(f"conv shape {tuple(w.shape)} != {(out, cin, k, k)}")
    return lpips_params_from_arrays(backbone, convs, lins, device)
