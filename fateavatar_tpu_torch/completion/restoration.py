"""GFPGAN face restoration for the completion pipeline's stage ④.

Port of ``fateavatar_tpu/completion/restoration.py``. The reference restores
each FFHQ-aligned crop with GFPGAN before GAN inversion
(train/completion.py:500-562, tools/sr_utils/__init__.py). This is the
**GFPGANv1Clean** inference graph (the pure-PyTorch "clean" architecture of
the public v1.3/v1.4 checkpoints): a U-Net degradation-removal encoder over
the 512² crop, a style code from the bottleneck, and a StyleGAN2 (clean)
decoder modulated per resolution by CS-SFT (channel-split spatial feature
transform) conditions from the U-Net's upsampling trunk.

:class:`GFPGAN` holds the official ``state_dict``'s tensors under their
names and layouts (conv_body_first, conv_body_down.N.*, final_linear,
conv_body_up.N.*, condition_scale.N.*, condition_shift.N.*,
stylegan_decoder.*); :func:`load_gfpgan_from_torch` reads the public
checkpoint (``params_ema``). ``stylegan_decoder.style_mlp.*`` are held but
not applied: the latents come from the encoder. Without weights the
pipeline keeps its identity fallback (crops pass through unrestored).

Semantics notes (clean-arch, basicsr):
  * ModulatedConv2d stores the 1/sqrt(fan_in) scale INSIDE the weight at
    init, so runtime applies the stored tensor directly; it runs as one
    grouped convolution over the batch, demodulation eps 1e-8 inside the
    rsqrt.
  * Up/downsampling inside the network is bilinear ``F.interpolate``
    (align_corners=False, no antialias); the plug-in's crop resize is
    ``jax.image.resize(..., "linear")``, which antialiases.
Images are NHWC at the boundaries, NCHW inside (cuDNN; the JAX graph is
plain XLA).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fateavatar_tpu_torch.completion.flatnet import (
    FlatNet, Params, Spec, load_flat, random_from_spec, zeros_from_spec,
)


@dataclass(frozen=True)
class GFPGANConfig:
    out_size: int = 512
    num_style_feat: int = 512
    channel_multiplier: int = 2
    num_mlp: int = 8
    narrow: float = 1.0
    sft_half: bool = True

    def decoder_channels(self, res: int) -> int:
        base = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128,
                256: 64, 512: 32, 1024: 16}[res]
        if res >= 64:
            base = base * self.channel_multiplier
        return int(min(base * self.narrow, 512))

    def unet_channels(self, res: int) -> int:
        base = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128,
                256: 64, 512: 32, 1024: 16}[res]
        if res >= 64:
            base = base * self.channel_multiplier
        return int(min(base * self.narrow * 0.5, 512))

    @property
    def log_size(self) -> int:
        return int(math.log2(self.out_size))

    @property
    def num_latent(self) -> int:
        return self.log_size * 2 - 2


def tiny_gfpgan_config() -> GFPGANConfig:
    return GFPGANConfig(out_size=32, num_style_feat=32, channel_multiplier=1,
                        num_mlp=2, narrow=0.125)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def gfpgan_param_spec(cfg: GFPGANConfig) -> Spec:
    """Every tensor the graph holds (names and shapes of the JAX package's
    ``gfpgan_random_params``, in its order), with its init."""
    p: Spec = {}

    def conv(name, i, o, k=3, bias=True):
        p[f"{name}.weight"] = ((o, i, k, k), 1.0 / math.sqrt(i * k * k))
        if bias:
            p[f"{name}.bias"] = ((o,), "zeros")

    def linear(name, i, o):
        p[f"{name}.weight"] = ((o, i), 1.0 / math.sqrt(i))
        p[f"{name}.bias"] = ((o,), "zeros")

    def mod_conv(name, i, o, k):
        p[f"{name}.weight"] = ((1, o, i, k, k), 1.0 / math.sqrt(i * k * k))
        linear(f"{name}.modulation", cfg.num_style_feat, i)
        p[f"{name}.modulation.bias"] = ((i,), "ones")

    def style_conv(name, i, o, k=3):
        mod_conv(f"{name}.modulated_conv", i, o, k)
        p[f"{name}.bias"] = ((1, o, 1, 1), "zeros")

    def to_rgb(name, i):
        mod_conv(f"{name}.modulated_conv", i, 3, 1)
        p[f"{name}.bias"] = ((1, 3, 1, 1), "zeros")

    # encoder
    conv("conv_body_first", 3, cfg.unet_channels(cfg.out_size), 1)
    res = cfg.out_size
    for idx in range(cfg.log_size - 2):
        i, o = cfg.unet_channels(res), cfg.unet_channels(res // 2)
        conv(f"conv_body_down.{idx}.conv1", i, i)
        conv(f"conv_body_down.{idx}.conv2", i, o)
        conv(f"conv_body_down.{idx}.skip", i, o, 1, bias=False)
        res //= 2
    conv("final_conv", cfg.unet_channels(4), cfg.unet_channels(4))
    linear("final_linear", cfg.unet_channels(4) * 16, cfg.num_latent * cfg.num_style_feat)

    # U-Net up trunk + SFT conditions
    res = 4
    for idx in range(cfg.log_size - 2):
        i, o = cfg.unet_channels(res), cfg.unet_channels(res * 2)
        conv(f"conv_body_up.{idx}.conv1", i, i)
        conv(f"conv_body_up.{idx}.conv2", i, o)
        conv(f"conv_body_up.{idx}.skip", i, o, 1, bias=False)
        dec_o = cfg.decoder_channels(res * 2)
        sft_o = dec_o // 2 if cfg.sft_half else dec_o
        conv(f"condition_scale.{idx}.0", o, o)
        conv(f"condition_scale.{idx}.2", o, sft_o)
        conv(f"condition_shift.{idx}.0", o, o)
        conv(f"condition_shift.{idx}.2", o, sft_o)
        res *= 2

    # stylegan decoder
    pre = "stylegan_decoder"
    for mi in range(cfg.num_mlp):
        linear(f"{pre}.style_mlp.{2 * mi + 1}", cfg.num_style_feat, cfg.num_style_feat)
    p[f"{pre}.constant_input.weight"] = ((1, cfg.decoder_channels(4), 4, 4), 1.0)
    style_conv(f"{pre}.style_conv1", cfg.decoder_channels(4), cfg.decoder_channels(4))
    to_rgb(f"{pre}.to_rgb1", cfg.decoder_channels(4))
    res = 4
    li = 0
    for _ in range(cfg.log_size - 2):
        i, o = cfg.decoder_channels(res), cfg.decoder_channels(res * 2)
        style_conv(f"{pre}.style_convs.{li}", i, o)
        style_conv(f"{pre}.style_convs.{li + 1}", o, o)
        to_rgb(f"{pre}.to_rgbs.{li // 2}", o)
        li += 2
        res *= 2
    return p


class GFPGAN(FlatNet):
    """GFPGANv1Clean's tensors by their checkpoint names: zeros at
    ``cfg``'s shapes, or ``params``. ``forward(x)`` restores crops in
    [-1, 1]."""

    def __init__(self, cfg: GFPGANConfig = GFPGANConfig(), params: Optional[Params] = None,
                 device="cuda"):
        super().__init__(params if params is not None
                         else zeros_from_spec(gfpgan_param_spec(cfg), device))
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gfpgan_restore(self.params(), self.cfg, x)


def gfpgan_random_params(generator: torch.Generator, cfg: GFPGANConfig,
                         device="cuda") -> Params:
    """Seeded random parameters with checkpoint-exact names and shapes
    (tests, the smoke run); the draws are torch's, not ``jax.random``'s."""
    return random_from_spec(gfpgan_param_spec(cfg), generator, device)


def gfpgan_from_arrays(raw: Dict[str, np.ndarray], cfg: GFPGANConfig = GFPGANConfig(),
                       device="cuda") -> Tuple[GFPGAN, list]:
    """A :class:`GFPGAN` at ``cfg`` holding ``raw`` (checkpoint name ->
    array). Returns it and the sorted names of ``raw`` the graph does not
    hold (the training-time ``toRGB.*`` and the decoder's ``noises``)."""
    net = GFPGAN(cfg, device=device)
    return net, load_flat(net, raw, "GFPGAN")


def load_gfpgan_from_torch(path: str, cfg: Optional[GFPGANConfig] = None, device="cuda"):
    """Load the public GFPGANv1.3/v1.4 checkpoint (a dict with
    'params_ema') or a bare state_dict. Returns (net, cfg, unused), where
    unused lists the checkpoint's keys the graph does not consume."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("params_ema", "params", "state_dict", "generator"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
            break
    raw = {k: v.detach().cpu().numpy() for k, v in sd.items() if hasattr(v, "detach")}
    cfg = cfg or GFPGANConfig()
    net, unused = gfpgan_from_arrays(raw, cfg, device)
    return net, cfg, unused


# ---------------------------------------------------------------------------
# primitives, NCHW
# ---------------------------------------------------------------------------

def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _conv(p, name, x):
    w = p[f"{name}.weight"]
    return F.conv2d(x, w, p.get(f"{name}.bias"), padding=w.shape[2] // 2)


def _linear(p, name, x):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _resize(x, factor):
    """bilinear, align_corners=False, no antialias (torch's default; the
    JAX graph passes antialias=False)."""
    h, w = x.shape[2:]
    return F.interpolate(x, size=(int(h * factor), int(w * factor)), mode="bilinear",
                         align_corners=False)


def _modulated_conv(p, name, x, style, demodulate=True):
    """basicsr clean ModulatedConv2d: stored weight [1,O,I,k,k] already
    carries 1/sqrt(fan_in); modulation is a Linear(num_style_feat -> I);
    one grouped conv over the batch."""
    weight = p[f"{name}.weight"][0]                       # [O,I,k,k]
    s = _linear(p, f"{name}.modulation", style)           # [N,I]
    o, i, kh, kw = weight.shape
    n = x.shape[0]
    w = weight[None] * s[:, None, :, None, None]
    if demodulate:
        d = torch.rsqrt(torch.sum(torch.square(w), dim=(2, 3, 4)) + 1e-8)
        w = w * d[:, :, None, None, None]
    y = F.conv2d(x.reshape(1, n * i, *x.shape[2:]), w.reshape(n * o, i, kh, kw),
                 padding=kh // 2, groups=n)
    return y.reshape(n, o, *y.shape[2:])


def _style_conv(p, name, x, style, upsample=False):
    if upsample:
        x = _resize(x, 2)
    y = _modulated_conv(p, f"{name}.modulated_conv", x, style)
    # clean StyleConv: learned noise strength `weight`, bias [1,O,1,1];
    # noise disabled at inference (deterministic restoration)
    y = y + p[f"{name}.bias"]
    return _lrelu(y) * math.sqrt(2.0)


def _to_rgb(p, name, x, style, skip=None):
    y = _modulated_conv(p, f"{name}.modulated_conv", x, style, demodulate=False)
    y = y + p[f"{name}.bias"]
    if skip is not None:
        y = y + _resize(skip, 2)
    return y


def _res_block(p, name, x, direction):
    """clean ResBlock/ResUpBlock: conv1 (same ch), resize, conv2 (ch
    change), 1x1 skip on the resized input, /sqrt(2)."""
    out = _lrelu(_conv(p, f"{name}.conv1", x))
    factor = 2.0 if direction == "up" else 0.5
    out = _resize(out, factor)
    out = _lrelu(_conv(p, f"{name}.conv2", out))
    skip = _conv(p, f"{name}.skip", _resize(x, factor))
    return (out + skip) / math.sqrt(2.0)


# ---------------------------------------------------------------------------
# StyleGAN2 clean decoder with CS-SFT
# ---------------------------------------------------------------------------

def _decoder(p, cfg: GFPGANConfig, latents, conditions):
    """stylegan_decoder forward. latents [N, num_latent, S];
    conditions: list of (scale, shift) per up-resolution."""
    pre = "stylegan_decoder"
    n = latents.shape[0]
    x = p[f"{pre}.constant_input.weight"].expand(n, -1, -1, -1)
    x = _style_conv(p, f"{pre}.style_conv1", x, latents[:, 0])
    skip = _to_rgb(p, f"{pre}.to_rgb1", x, latents[:, 1])
    i = 1
    for li in range(0, (cfg.log_size - 2) * 2, 2):
        x = _style_conv(p, f"{pre}.style_convs.{li}", x, latents[:, i], upsample=True)
        # CS-SFT on half (or all) channels after the upsampling conv
        ci = li // 2
        if ci < len(conditions):
            scale, shift = conditions[ci]
            if cfg.sft_half:
                half = x.shape[1] // 2
                x = torch.cat([x[:, :half], x[:, half:] * scale + shift], dim=1)
            else:
                x = x * scale + shift
        x = _style_conv(p, f"{pre}.style_convs.{li + 1}", x, latents[:, i + 1])
        skip = _to_rgb(p, f"{pre}.to_rgbs.{ci}", x, latents[:, i + 2], skip=skip)
        i += 2
    return skip                                            # [-1,1] image


def gfpgan_restore(p: Params, cfg: GFPGANConfig, x: torch.Tensor) -> torch.Tensor:
    """Restore a batch of aligned crops. x [N,S,S,3] in [-1,1] -> same."""
    feat = _lrelu(_conv(p, "conv_body_first", x.permute(0, 3, 1, 2)))
    unet_skips = []
    for idx in range(cfg.log_size - 2):
        feat = _res_block(p, f"conv_body_down.{idx}", feat, "down")
        unet_skips.insert(0, feat)
    feat = _lrelu(_conv(p, "final_conv", feat))

    # style code from the 4x4 bottleneck, flattened in NCHW order
    style = _linear(p, "final_linear", feat.reshape(feat.shape[0], -1))
    latents = style.reshape(style.shape[0], -1, cfg.num_style_feat)
    if latents.shape[1] == 1:
        latents = latents.expand(-1, cfg.num_latent, -1)

    conditions: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for idx in range(cfg.log_size - 2):
        feat = feat + unet_skips[idx]
        feat = _res_block(p, f"conv_body_up.{idx}", feat, "up")
        sc = _conv(p, f"condition_scale.{idx}.0", feat)
        sc = _conv(p, f"condition_scale.{idx}.2", _lrelu(sc))
        sh = _conv(p, f"condition_shift.{idx}.0", feat)
        sh = _conv(p, f"condition_shift.{idx}.2", _lrelu(sh))
        conditions.append((sc, sh))

    return _decoder(p, cfg, latents, conditions).permute(0, 2, 3, 1)


def _resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """NHWC ``jax.image.resize(..., "linear")``: antialiased."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True).permute(0, 2, 3, 1)


class GFPGANRestorer:
    """Stage-④ enhancer plugin: callable on [N,H,W,3] crops in [0,1];
    crops not at ``out_size`` are resized to it and back. Runs on the
    network's device; returns numpy."""

    def __init__(self, net: GFPGAN):
        self.net = net
        self.cfg = net.cfg
        self.device = next(net.parameters()).device

    @torch.no_grad()
    def __call__(self, crops) -> np.ndarray:
        x = torch.as_tensor(np.asarray(crops, np.float32), device=self.device)
        size = self.cfg.out_size
        orig = tuple(x.shape[1:3])
        if orig != (size, size):
            x = _resize_linear(x, (size, size))
        y = self.net(x * 2.0 - 1.0) * 0.5 + 0.5
        if orig != (size, size):
            y = _resize_linear(y, orig)
        return torch.clamp(y, 0.0, 1.0).cpu().numpy()
