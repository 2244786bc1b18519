"""Texture decoder networks for neural baking.

Port of ``fateavatar_tpu/models/unet.py`` (model/unet/arch.py:7-173 of the
reference) as ``nn.Module``s:

* :class:`UNet` — 4-down/4-up bilinear U-Net, 11ch -> 11ch at 512^2.
* :class:`UNetDecoder` — const 8x8x512 -> 256^2 upsampling decoder.
* :class:`FeatureMap` — a directly-optimized 512^2 texture.

Each network takes and returns NHWC tensors ``[B, H, W, C]``, the JAX
package's layout, so the textures stay ``[H, W, C]``; inside, the
convolutions run NCHW with OIHW weights. The 3x3 convolutions have no bias
(``padding=1`` is flax's ``"SAME"``), the final 1x1 has one. BatchNorm is
flax's (:class:`FlaxBatchNorm`), not ``torch.nn.BatchNorm2d``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal: a normal truncated at 2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]):
    std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _conv(cin, cout, k, bias, device, generator):
    """A conv initialised from ``generator`` only (``skip_init``: torch's
    own init would draw from the default generator first)."""
    conv = nn.utils.skip_init(nn.Conv2d, cin, cout, k, padding=k // 2, bias=bias,
                              device=device)
    _lecun_normal_(conv.weight, generator)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class FlaxBatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over NCHW: eps 1e-5, running statistics
    ``r = 0.99 r + 0.01 b`` with the BIASED batch variance (torch's
    ``BatchNorm2d`` updates with the unbiased one and calls 0.01 its
    momentum). Training mode normalises with the batch statistics, eval
    mode with the running ones. The running update is in place, on the
    module's buffers."""

    MOMENTUM = 0.99
    EPS = 1e-5

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))
        self.register_buffer("running_mean", torch.zeros(ch, device=device))
        self.register_buffer("running_var", torch.ones(ch, device=device))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if train:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                self.running_mean.mul_(self.MOMENTUM).add_(mean, alpha=1 - self.MOMENTUM)
                self.running_var.mul_(self.MOMENTUM).add_(var, alpha=1 - self.MOMENTUM)
            # no running buffers given: the batch statistics only
            return F.batch_norm(x, None, None, self.weight, self.bias, training=True,
                                eps=self.EPS)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.EPS)


class DoubleConv(nn.Module):
    def __init__(self, cin, out_ch, mid_ch=None, device=None, generator=None):
        super().__init__()
        mid = mid_ch or out_ch
        self.conv1 = _conv(cin, mid, 3, False, device, generator)
        self.bn1 = FlaxBatchNorm(mid, device)
        self.conv2 = _conv(mid, out_ch, 3, False, device, generator)
        self.bn2 = FlaxBatchNorm(out_ch, device)

    def forward(self, x, train: bool = True):
        x = F.relu(self.bn1(self.conv1(x), train))
        return F.relu(self.bn2(self.conv2(x), train))


def _upsample2x(x):
    """Bilinear 2x, half-pixel centres: ``jax.image.resize(..., "bilinear")``
    at exactly twice the size (at the edges JAX renormalises the weight past
    the border and torch clamps the source index: the same values)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class Down(nn.Module):
    def __init__(self, cin, out_ch, device=None, generator=None):
        super().__init__()
        self.conv = DoubleConv(cin, out_ch, device=device, generator=generator)

    def forward(self, x, train: bool = True):
        return self.conv(F.max_pool2d(x, 2, 2), train)


class Up(nn.Module):
    """Upsample, then concatenate ``[skip, x]`` on channels (in that order)."""

    def __init__(self, cin, out_ch, mid_ch, device=None, generator=None):
        super().__init__()
        self.conv = DoubleConv(cin, out_ch, mid_ch, device=device, generator=generator)

    def forward(self, x, skip, train: bool = True):
        return self.conv(torch.cat([skip, _upsample2x(x)], dim=1), train)


class UpNoSkip(nn.Module):
    def __init__(self, cin, out_ch, mid_ch, device=None, generator=None):
        super().__init__()
        self.conv = DoubleConv(cin, out_ch, mid_ch, device=device, generator=generator)

    def forward(self, x, train: bool = True):
        return self.conv(_upsample2x(x), train)


class UNet(nn.Module):
    """arch.py:7-37 (bilinear variant)."""

    def __init__(self, in_ch: int, out_ch: int, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.inc = DoubleConv(in_ch, 64, **kw)
        self.down1 = Down(64, 128, **kw)
        self.down2 = Down(128, 256, **kw)
        self.down3 = Down(256, 512, **kw)
        self.down4 = Down(512, 512, **kw)          # 1024 // 2 (bilinear factor)
        self.up1 = Up(1024, 256, 512, **kw)        # 512 // 2, mid 512
        self.up2 = Up(512, 128, 256, **kw)
        self.up3 = Up(256, 64, 128, **kw)
        self.up4 = Up(128, 64, 64, **kw)
        self.outc = _conv(64, out_ch, 1, True, device, generator)

    def forward(self, x, train: bool = True):
        x1 = self.inc(x.permute(0, 3, 1, 2), train)
        x2 = self.down1(x1, train)
        x3 = self.down2(x2, train)
        x4 = self.down3(x3, train)
        x5 = self.down4(x4, train)
        x = self.up1(x5, x4, train)
        x = self.up2(x, x3, train)
        x = self.up3(x, x2, train)
        x = self.up4(x, x1, train)
        return self.outc(x).permute(0, 2, 3, 1)


class UNetDecoder(nn.Module):
    """arch.py:41-66: const 8x8x512 -> 256x256xout."""

    def __init__(self, in_ch: int, out_ch: int, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.up1 = UpNoSkip(in_ch, 512, 256, **kw)   # 8 -> 16
        self.up2 = UpNoSkip(512, 256, 256, **kw)     # 16 -> 32
        self.up3 = UpNoSkip(256, 128, 128, **kw)     # 32 -> 64
        self.up4 = UpNoSkip(128, 64, 64, **kw)       # 64 -> 128
        self.up5 = UpNoSkip(64, 32, 32, **kw)        # 128 -> 256
        self.outc = _conv(32, out_ch, 1, True, device, generator)

    def forward(self, x, train: bool = True):
        x = x.permute(0, 3, 1, 2)
        for up in (self.up1, self.up2, self.up3, self.up4, self.up5):
            x = up(x, train)
        return self.outc(x).permute(0, 2, 3, 1)


class FeatureMap(nn.Module):
    """arch.py:70-80: the texture IS the parameter, ``[1, T, T, C]`` drawn
    from U(-1, 1); the input is ignored."""

    def __init__(self, out_ch: int, tex_size: int = 512, device=None, generator=None):
        super().__init__()
        u = torch.rand((1, tex_size, tex_size, out_ch), generator=generator, device=device)
        self.texture = nn.Parameter(u * 2.0 - 1.0)

    def forward(self, x, train: bool = True):
        return self.texture
