"""BiSeNet face parsing for the completion pipeline's mask stage.

Port of ``fateavatar_tpu/completion/segmentation.py``. The reference's stage
⑧ (train/completion.py:818-886) runs a BiSeNet face-parsing CNN (the
``79999_iter.pth`` checkpoint of face-parsing.PyTorch) to turn pasted
pseudo views into head masks: a ResNet-18 context path, attention
refinement, feature fusion, 19 face classes. :class:`BiSeNet` holds the
checkpoint's tensors under their own names in the checkpoint's layout (conv
kernels OIHW; the JAX package stores them HWIO, ``convert.
bisenet_state_dict`` transposes); :func:`load_bisenet_from_torch` reads the
public checkpoint. Without weights the pipeline keeps its alpha-threshold
fallback (``completion/pseudo.py``).

Images are NHWC at the boundaries, as in the JAX package; inside, the
convolutions run NCHW through cuDNN (the JAX graph is plain XLA, no Pallas).
Resizes follow ``jax.image.resize``: "nearest" samples at half-pixel centres
(``F.interpolate(mode="nearest-exact")``) and "bilinear" antialiases when it
shrinks (``antialias=True``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fateavatar_tpu_torch.completion.flatnet import (
    FlatNet, Params, batch_norm, is_bn_stat, load_flat,
)

N_CLASSES = 19
# face-parsing.PyTorch class ids
CLASS_NAMES = (
    "background", "skin", "l_brow", "r_brow", "l_eye", "r_eye", "eye_g",
    "l_ear", "r_ear", "ear_r", "nose", "mouth", "u_lip", "l_lip", "neck",
    "neck_l", "cloth", "hair", "hat",
)
# default head-mask classes: everything that is head/neck, excluding
# background and cloth (completion.py:846-852 keeps face+hair+ears+neck)
HEAD_CLASSES = tuple(
    i for i, n in enumerate(CLASS_NAMES) if n not in ("background", "cloth")
)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# parameters: shape table, random init, the module
# ---------------------------------------------------------------------------

def _shape_table(n_classes=N_CLASSES) -> Dict[str, tuple]:
    """Every tensor of the inference graph, conv kernels OIHW (the
    checkpoint's layout)."""
    t: Dict[str, tuple] = {}

    def bn(prefix, c):
        for s in ("weight", "bias", "running_mean", "running_var"):
            t[f"{prefix}.{s}"] = (c,)

    def cbr(prefix, cin, cout, k):
        t[f"{prefix}.conv.weight"] = (cout, cin, k, k)
        bn(f"{prefix}.bn", cout)

    t["cp.resnet.conv1.weight"] = (64, 3, 7, 7)
    bn("cp.resnet.bn1", 64)
    chans = {1: (64, 64), 2: (64, 128), 3: (128, 256), 4: (256, 512)}
    for layer, (cin, cout) in chans.items():
        for i in range(2):
            ci = cin if i == 0 else cout
            pre = f"cp.resnet.layer{layer}.{i}"
            t[f"{pre}.conv1.weight"] = (cout, ci, 3, 3)
            bn(f"{pre}.bn1", cout)
            t[f"{pre}.conv2.weight"] = (cout, cout, 3, 3)
            bn(f"{pre}.bn2", cout)
            if i == 0 and layer > 1:
                t[f"{pre}.downsample.0.weight"] = (cout, cin, 1, 1)
                bn(f"{pre}.downsample.1", cout)
    for name, cin in (("cp.arm16", 256), ("cp.arm32", 512)):
        cbr(f"{name}.conv", cin, 128, 3)
        t[f"{name}.conv_atten.weight"] = (128, 128, 1, 1)
        bn(f"{name}.bn_atten", 128)
    cbr("cp.conv_avg", 512, 128, 1)
    cbr("cp.conv_head32", 128, 128, 3)
    cbr("cp.conv_head16", 128, 128, 3)
    cbr("ffm.convblk", 256, 256, 1)
    t["ffm.conv1.weight"] = (64, 256, 1, 1)
    t["ffm.conv2.weight"] = (256, 64, 1, 1)
    cbr("conv_out.conv", 256, 256, 3)
    t["conv_out.conv_out.weight"] = (n_classes, 256, 1, 1)
    t["conv_out.conv_out.bias"] = (n_classes,)
    return t


def init_bisenet(rng: np.random.Generator | int = 0,
                 n_classes: int = N_CLASSES) -> Dict[str, np.ndarray]:
    """Random parameters with the real shapes (tests, the smoke run): the
    JAX package's numpy draws, each in its HWIO shape and transposed to
    OIHW, so a seed gives both packages the same network."""
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    params = {}
    for name, shape in _shape_table(n_classes).items():
        hwio = (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 else shape
        if name.endswith("running_var"):
            arr = np.abs(rng.normal(1.0, 0.1, hwio)) + 0.5
        elif name.endswith((".weight",)) and len(shape) == 1:
            arr = np.ones(hwio)
        elif name.endswith(("running_mean", ".bias")):
            arr = np.zeros(hwio)
        else:
            fan_in = int(np.prod(hwio[:-1])) if len(hwio) == 4 else hwio[0]
            arr = rng.normal(0, (2.0 / max(fan_in, 1)) ** 0.5, hwio)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        params[name] = arr.astype(np.float32)
    return params


class BiSeNet(FlatNet):
    """The face-parsing network's tensors by their checkpoint names (zeros
    until loaded). ``forward(images)`` gives the logits."""

    def __init__(self, n_classes: int = N_CLASSES, device="cuda"):
        super().__init__({k: torch.zeros(s, device=device)
                          for k, s in _shape_table(n_classes).items()}, is_bn_stat)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return bisenet_forward(self.params(), images)


def bisenet_from_arrays(raw: Dict[str, np.ndarray], device="cuda") -> BiSeNet:
    """A :class:`BiSeNet` holding ``raw`` (checkpoint name -> OIHW array);
    tensors it does not use (the aux heads, BN counters) are ignored."""
    net = BiSeNet(raw["conv_out.conv_out.bias"].shape[0], device=device)
    load_flat(net, raw, "BiSeNet")
    return net


def load_bisenet_from_torch(path: str, device="cuda") -> BiSeNet:
    """The public face-parsing.PyTorch checkpoint (79999_iter.pth, a plain
    state_dict) as a :class:`BiSeNet` on ``device``; aux heads
    (conv_out16/32) and BN num_batches_tracked counters are dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict) or "cp.resnet.conv1.weight" not in sd:
        raise ValueError(
            f"{path} does not look like a face-parsing.PyTorch state_dict"
        )
    return bisenet_from_arrays({k: v.detach().numpy() for k, v in sd.items()
                                if hasattr(v, "detach")}, device)


# ---------------------------------------------------------------------------
# primitive layers (inference only; BN folded at runtime), NCHW
# ---------------------------------------------------------------------------

def _conv(x, w, stride=1):
    """torch conv2d with SYMMETRIC padding k//2 (what the JAX graph spells
    out: XLA's "SAME" would pad stride-2 even inputs (0, 1))."""
    return F.conv2d(x, w, stride=stride, padding=(w.shape[2] // 2, w.shape[3] // 2))


def _conv_bn_relu(p, prefix, x, stride=1):
    """ConvBNReLU of face-parsing.PyTorch (conv no-bias + BN + relu)."""
    x = _conv(x, p[f"{prefix}.conv.weight"], stride)
    return F.relu(batch_norm(p, f"{prefix}.bn", x))


def _basic_block(p, prefix, x, stride=1):
    out = _conv(x, p[f"{prefix}.conv1.weight"], stride)
    out = F.relu(batch_norm(p, f"{prefix}.bn1", out))
    out = _conv(out, p[f"{prefix}.conv2.weight"], 1)
    out = batch_norm(p, f"{prefix}.bn2", out)
    if f"{prefix}.downsample.0.weight" in p:
        x = _conv(x, p[f"{prefix}.downsample.0.weight"], stride)
        x = batch_norm(p, f"{prefix}.downsample.1", x)
    return F.relu(out + x)


def _resnet18_features(p, x):
    """conv1 -> layer4, returning the 1/8, 1/16 and 1/32 feature maps."""
    x = _conv(x, p["cp.resnet.conv1.weight"], 2)
    x = F.relu(batch_norm(p, "cp.resnet.bn1", x))
    x = F.max_pool2d(x, 3, 2, padding=1)       # pads with -inf
    for i in range(2):
        x = _basic_block(p, f"cp.resnet.layer1.{i}", x, 1)
    for i in range(2):
        x = _basic_block(p, f"cp.resnet.layer2.{i}", x, 2 if i == 0 else 1)
    feat8 = x
    for i in range(2):
        x = _basic_block(p, f"cp.resnet.layer3.{i}", x, 2 if i == 0 else 1)
    feat16 = x
    for i in range(2):
        x = _basic_block(p, f"cp.resnet.layer4.{i}", x, 2 if i == 0 else 1)
    return feat8, feat16, x


def _arm(p, prefix, x):
    """AttentionRefinementModule: 3x3 ConvBNReLU then global-pool channel
    attention (1x1 conv + BN + sigmoid)."""
    feat = _conv_bn_relu(p, f"{prefix}.conv", x)
    atten = torch.mean(feat, dim=(2, 3), keepdim=True)
    atten = _conv(atten, p[f"{prefix}.conv_atten.weight"])
    atten = torch.sigmoid(batch_norm(p, f"{prefix}.bn_atten", atten))
    return feat * atten


def _upsample_nearest(x, ref_hw):
    """``jax.image.resize(..., "nearest")``: half-pixel centres."""
    return F.interpolate(x, size=tuple(ref_hw), mode="nearest-exact")


def bisenet_forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    """Face-parsing logits.

    images: [B, H, W, 3] float in [0, 1] (RGB). Returns [B, H, W, 19].
    Mirrors BiSeNet.forward of face-parsing.PyTorch (context path with
    ARM16/ARM32 + global-pool tail, feat8 as the spatial path, FFM fuse,
    main output head; aux heads dropped: inference only).
    """
    p = params
    mean = torch.tensor(_IMAGENET_MEAN, device=images.device)
    std = torch.tensor(_IMAGENET_STD, device=images.device)
    x = ((images - mean) / std).permute(0, 3, 1, 2)

    feat8, feat16, feat32 = _resnet18_features(p, x)

    avg = torch.mean(feat32, dim=(2, 3), keepdim=True)
    avg = _conv_bn_relu(p, "cp.conv_avg", avg)
    feat32_sum = _arm(p, "cp.arm32", feat32) + avg     # broadcast over H, W
    feat32_up = _upsample_nearest(feat32_sum, feat16.shape[2:])
    feat32_up = _conv_bn_relu(p, "cp.conv_head32", feat32_up)

    feat16_sum = _arm(p, "cp.arm16", feat16) + feat32_up
    feat16_up = _upsample_nearest(feat16_sum, feat8.shape[2:])
    feat16_up = _conv_bn_relu(p, "cp.conv_head16", feat16_up)

    # FeatureFusionModule: concat spatial (feat8) + context, 1x1 ConvBNReLU,
    # SE-style residual attention
    fcat = torch.cat([feat8, feat16_up], dim=1)
    feat = _conv_bn_relu(p, "ffm.convblk", fcat)
    atten = torch.mean(feat, dim=(2, 3), keepdim=True)
    atten = F.relu(_conv(atten, p["ffm.conv1.weight"]))
    atten = torch.sigmoid(_conv(atten, p["ffm.conv2.weight"]))
    feat = feat * atten + feat

    out = _conv_bn_relu(p, "conv_out.conv", feat)
    out = _conv(out, p["conv_out.conv_out.weight"])
    out = out + p["conv_out.conv_out.bias"][:, None, None]
    out = F.interpolate(out, size=tuple(images.shape[1:3]), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# mask derivation (the matting_fn contract of PseudoGenerator)
# ---------------------------------------------------------------------------

def parse_faces(params: Params, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] in [0,1] -> per-pixel class ids [B, H, W] int64."""
    return torch.argmax(bisenet_forward(params, images), dim=-1)


class BiSeNetMatting:
    """Stage-⑧ ``matting_fn(img [H,W,3] float) -> mask [H,W] float`` for
    :class:`fateavatar_tpu_torch.completion.pseudo.PseudoGenerator`. The
    image is resized to ``infer_size`` for the network (the checkpoint's
    training resolution), and the mask of the ``include`` classes is
    resized back (nearest). Runs on the network's device."""

    def __init__(self, net: BiSeNet, include: Sequence[int] = HEAD_CLASSES,
                 infer_size: int = 512):
        self.net = net
        self.infer_size = infer_size
        self.device = next(net.parameters()).device
        self.include = torch.as_tensor(sorted(include), dtype=torch.int64, device=self.device)

    @torch.no_grad()
    def classes(self, img) -> torch.Tensor:
        """The class ids of ``img`` at ``infer_size`` ([S, S] int64)."""
        x = torch.as_tensor(np.asarray(img, np.float32), device=self.device)[None]
        s = self.infer_size
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(s, s), mode="bilinear",
                          align_corners=False, antialias=True).permute(0, 2, 3, 1)
        return parse_faces(self.net.params(), x)[0]

    @torch.no_grad()
    def __call__(self, img) -> np.ndarray:
        m = torch.isin(self.classes(img), self.include).float()
        m = F.interpolate(m[None, None], size=tuple(np.shape(img)[:2]), mode="nearest-exact")
        return m[0, 0].cpu().numpy()


def make_bisenet_matting_fn(net: BiSeNet, include: Sequence[int] = HEAD_CLASSES,
                            infer_size: int = 512) -> BiSeNetMatting:
    """The JAX package's name for :class:`BiSeNetMatting`."""
    return BiSeNetMatting(net, include, infer_size)
