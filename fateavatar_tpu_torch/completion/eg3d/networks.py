"""EG3D-family 3D-aware generator (tri-plane / tri-grid).

Port of ``fateavatar_tpu/completion/eg3d/networks.py``: the generator behind
the completion pipeline's stage ⑤ (GAN inversion):

  mapping  : z (512) + camera label c (25) -> w (512) -> broadcast num_ws
  backbone : StyleGAN2 synthesis -> feature planes
             [3*D*C] channels (tri-plane D = 1, tri-grid D > 1)
  decoder  : per-sample 2-layer MLP (softplus hidden) -> sigma + feature
  renderer : two-pass importance-sampled volume rendering along camera rays
  superres : StyleGAN2 blocks upsampling the neural-resolution feature image

The parameters live in :class:`EG3DGenerator`, an ``nn.Module`` whose
``state_dict()`` keys are the flat names of the JAX package's param dict,
which follow the official ``G_ema`` layout (``backbone.mapping.fc{i}.*``,
``backbone.synthesis.b{res}.conv{0,1}.*`` and ``torgb.*``,
``decoder.net.{0,2}.*``, ``superresolution.block{i}.*``);
``backbone.mapping.w_avg`` and every ``noise_const`` are buffers. The
functions below take the flat dict :meth:`EG3DGenerator.params` returns, as
the JAX functions take theirs, and keep the JAX package's layouts at their
boundaries (images and planes NHWC); inside, the convolutions run NCHW.

Where the port departs on purpose: the JAX package samples the planes with
a hand-written bilinear gather (``_grid_sample_plane``); it is exactly
``F.grid_sample(mode="bilinear", padding_mode="zeros",
align_corners=False)``, which the port uses, so its backward recomputes the
taps instead of storing four gathered taps per sample. The EG3D graph has
no Pallas kernel in the JAX package (it is plain XLA there), so it is plain
PyTorch here: cuDNN convolutions and matrix products in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fateavatar_tpu_torch.completion.flatnet import FlatNet

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EG3DConfig:
    z_dim: int = 512
    c_dim: int = 25                  # 16 cam2world + 9 intrinsics (EG3D label)
    w_dim: int = 512
    num_mapping_layers: int = 8
    backbone_resolution: int = 256   # tri-plane texture resolution
    plane_channels: int = 32
    triplane_depth: int = 1          # 1 = EG3D tri-plane, >1 = tri-grid
    channel_base: int = 32768
    channel_max: int = 512
    decoder_hidden: int = 64
    decoder_out: int = 32            # feature channels fed to superres
    neural_resolution: int = 128     # volume-rendering resolution
    depth_resolution: int = 48
    depth_resolution_importance: int = 48
    ray_start: float = 2.25
    ray_end: float = 3.3
    box_warp: float = 1.0
    sr_resolution: int = 512         # final image resolution
    sr_channels: int = 128
    sigma_bias: float = -1.0         # softplus(sigma + bias), EG3D uses -1

    @property
    def backbone_img_channels(self) -> int:
        return 3 * self.triplane_depth * self.plane_channels

    @property
    def block_resolutions(self) -> Tuple[int, ...]:
        return tuple(2 ** i for i in range(2, int(math.log2(self.backbone_resolution)) + 1))

    def nf(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def num_ws(self) -> int:
        # StyleGAN2: 1 conv at 4x4, 2 per later block, +1 final torgb
        return 1 + 2 * (len(self.block_resolutions) - 1) + 1

    @property
    def sr_block_resolutions(self) -> Tuple[int, ...]:
        res, out = [], self.neural_resolution
        while out < self.sr_resolution:
            out *= 2
            res.append(out)
        return tuple(res)


def tiny_test_config() -> EG3DConfig:
    """A CPU-fast configuration used by the tests."""
    return EG3DConfig(
        z_dim=32, w_dim=32, num_mapping_layers=2, backbone_resolution=32,
        plane_channels=8, channel_base=512, channel_max=64, decoder_hidden=16,
        decoder_out=8, neural_resolution=16, depth_resolution=12,
        depth_resolution_importance=12, sr_resolution=32, sr_channels=16,
    )


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

BUFFERS = ("backbone.mapping.w_avg", ".noise_const")


def _is_buffer(name: str) -> bool:
    return name == BUFFERS[0] or name.endswith(BUFFERS[1])


def param_spec(cfg: EG3DConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every tensor of the generator: name -> (shape, init), init one of
    "randn", "mapping" (randn / 0.01: the runtime product weight*gain stays
    O(1/sqrt(in)) at lr_mult 0.01), "zeros", "ones"."""
    spec: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def fc(name, i, o, bias_init="zeros", w_init="randn"):
        spec[f"{name}.weight"] = ((o, i), w_init)
        spec[f"{name}.bias"] = ((o,), bias_init)

    fc("backbone.mapping.embed", cfg.c_dim, cfg.w_dim)
    in_dim = cfg.z_dim + cfg.w_dim
    for i in range(cfg.num_mapping_layers):
        fc(f"backbone.mapping.fc{i}", in_dim, cfg.w_dim, w_init="mapping")
        in_dim = cfg.w_dim
    spec["backbone.mapping.w_avg"] = ((cfg.w_dim,), "zeros")

    def conv_layer(name, i, o, k, res):
        spec[f"{name}.weight"] = ((o, i, k, k), "randn")
        spec[f"{name}.bias"] = ((o,), "zeros")
        spec[f"{name}.noise_const"] = ((res, res), "randn")
        spec[f"{name}.noise_strength"] = ((), "zeros")
        fc(f"{name}.affine", cfg.w_dim, i, bias_init="ones")

    def torgb_layer(name, i, o):
        spec[f"{name}.weight"] = ((o, i, 1, 1), "randn")
        spec[f"{name}.bias"] = ((o,), "zeros")
        fc(f"{name}.affine", cfg.w_dim, i, bias_init="ones")

    for res in cfg.block_resolutions:
        bname = f"backbone.synthesis.b{res}"
        o = cfg.nf(res)
        if res == 4:
            spec[f"{bname}.const"] = ((o, 4, 4), "randn")
            conv_layer(f"{bname}.conv1", o, o, 3, res)
        else:
            conv_layer(f"{bname}.conv0", cfg.nf(res // 2), o, 3, res)
            conv_layer(f"{bname}.conv1", o, o, 3, res)
        torgb_layer(f"{bname}.torgb", o, cfg.backbone_img_channels)

    fc("decoder.net.0", cfg.plane_channels, cfg.decoder_hidden)
    fc("decoder.net.2", cfg.decoder_hidden, 1 + cfg.decoder_out)

    in_ch = cfg.decoder_out
    for bi, res in enumerate(cfg.sr_block_resolutions):
        bname = f"superresolution.block{bi}"
        conv_layer(f"{bname}.conv0", in_ch, cfg.sr_channels, 3, res)
        conv_layer(f"{bname}.conv1", cfg.sr_channels, cfg.sr_channels, 3, res)
        torgb_layer(f"{bname}.torgb", cfg.sr_channels, 3)
        in_ch = cfg.sr_channels
    return spec


def eg3d_random_params(generator: torch.Generator, cfg: EG3DConfig,
                       device="cuda") -> Params:
    """Seeded random parameters with the checkpoint's names and shapes,
    drawn from ``generator`` in the spec's order (StyleGAN2 stores
    unit-variance weights). The draws are torch's, not ``jax.random``'s."""
    out: Params = {}
    for name, (shape, init) in param_spec(cfg).items():
        if init in ("randn", "mapping"):
            x = torch.randn(shape, generator=generator, device=device)
            out[name] = x / 0.01 if init == "mapping" else x
        else:
            out[name] = (torch.ones if init == "ones" else torch.zeros)(shape, device=device)
    return out


class EG3DGenerator(FlatNet):
    """The generator's tensors as a module tree whose ``state_dict()`` keys
    are the flat checkpoint names. Built empty (zeros) at ``cfg``'s shapes,
    or from ``params``; ``load_state_dict`` carries a ``G_ema`` state_dict
    or the JAX package's param dict across. :meth:`params` is the flat
    name -> tensor dict the functions below take."""

    def __init__(self, cfg: EG3DConfig, params: Optional[Params] = None, device="cuda"):
        super().__init__({name: (params[name] if params is not None
                                 else torch.zeros(shape, device=device))
                          for name, (shape, _) in param_spec(cfg).items()}, _is_buffer)
        self.cfg = cfg


# ---------------------------------------------------------------------------
# primitive layers (StyleGAN2-ADA runtime semantics)
# ---------------------------------------------------------------------------

def _fc(p: Params, name: str, x: torch.Tensor, act: str = "linear",
        lr_mult: float = 1.0) -> torch.Tensor:
    """FullyConnectedLayer: weight [out,in] stored unit-variance, runtime
    gain lr_mult/sqrt(in), bias gain lr_mult, optional lrelu (gain sqrt2)
    or softplus."""
    w = p[f"{name}.weight"]
    gain = lr_mult / math.sqrt(w.shape[1])
    y = x @ (w.T * gain)
    b = p.get(f"{name}.bias")
    if b is not None:
        y = y + b * lr_mult
    if act == "lrelu":
        y = F.leaky_relu(y, 0.2) * math.sqrt(2.0)
    elif act == "softplus":
        y = F.softplus(y)
    return y


def _normalize_2nd_moment(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)


_FIR = np.array([1.0, 3.0, 3.0, 1.0], np.float32)
_FIR = np.outer(_FIR, _FIR)
_FIR /= _FIR.sum()


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """upfirdn2d up=2 with the [1,3,3,1] filter at gain 4, NCHW. The JAX
    graph zero-stuffs (lhs dilation: 2H - 1 samples), pads 2 on each side
    and correlates with the 4x4 filter; that is ``conv_transpose2d`` at
    stride 2 with padding 1 (its implicit pad is 4 - 1 - 1 = 2), the filter
    being symmetric."""
    c = x.shape[1]
    f = torch.as_tensor(_FIR * 4.0, dtype=x.dtype, device=x.device)
    return F.conv_transpose2d(x, f.expand(c, 1, 4, 4), stride=2, padding=1, groups=c)


def _modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, styles: torch.Tensor,
                      demodulate: bool = True, up: bool = False) -> torch.Tensor:
    """StyleGAN2 modulated conv, NCHW: x [N,Cin,H,W], weight [O,I,kh,kw],
    styles [N,I]; one grouped conv over the batch ("SAME" padding)."""
    if up:
        x = _upsample2x(x)
    o, i, kh, kw = weight.shape
    n = x.shape[0]
    w = weight[None] * styles[:, None, :, None, None]          # [N,O,I,kh,kw]
    if demodulate:
        d = torch.rsqrt(torch.sum(torch.square(w), dim=(2, 3, 4)) + 1e-8)
        w = w * d[:, :, None, None, None]
    y = F.conv2d(x.reshape(1, n * i, *x.shape[2:]), w.reshape(n * o, i, kh, kw),
                 padding=kh // 2, groups=n)
    return y.reshape(n, o, *y.shape[2:])


def _synthesis_layer(p: Params, name: str, x: torch.Tensor, w: torch.Tensor,
                     up: bool = False, noise: bool = True) -> torch.Tensor:
    styles = _fc(p, f"{name}.affine", w)  # affine bias stored (init 1)
    y = _modulated_conv2d(x, p[f"{name}.weight"], styles, demodulate=True, up=up)
    if noise and f"{name}.noise_const" in p:
        y = y + p[f"{name}.noise_const"][None, None] * p[f"{name}.noise_strength"]
    y = y + p[f"{name}.bias"][None, :, None, None]
    y = F.leaky_relu(y, 0.2) * math.sqrt(2.0)
    return torch.clamp(y, -256.0, 256.0)


def _torgb(p: Params, name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    weight = p[f"{name}.weight"]
    styles = _fc(p, f"{name}.affine", w) * (1.0 / math.sqrt(weight.shape[1]))
    y = _modulated_conv2d(x, weight, styles, demodulate=False)
    return y + p[f"{name}.bias"][None, :, None, None]


# ---------------------------------------------------------------------------
# mapping + backbone synthesis
# ---------------------------------------------------------------------------

def mapping_network(p: Params, cfg: EG3DConfig, z: torch.Tensor, c: torch.Tensor,
                    truncation_psi: float = 1.0) -> torch.Tensor:
    """z [N,z_dim], c [N,c_dim] -> ws [N,num_ws,w_dim] (StyleGAN2-ADA
    MappingNetwork with EG3D camera conditioning)."""
    x = _normalize_2nd_moment(z)
    if cfg.c_dim > 0 and "backbone.mapping.embed.weight" in p:
        y = _normalize_2nd_moment(_fc(p, "backbone.mapping.embed", c))
        x = torch.cat([x, y], dim=-1)
    for i in range(cfg.num_mapping_layers):
        x = _fc(p, f"backbone.mapping.fc{i}", x, act="lrelu", lr_mult=0.01)
    if truncation_psi != 1.0 and "backbone.mapping.w_avg" in p:
        w_avg = p["backbone.mapping.w_avg"]
        x = w_avg + truncation_psi * (x - w_avg)
    return x[:, None, :].expand(-1, cfg.num_ws, -1)


def synthesis_backbone(p: Params, cfg: EG3DConfig, ws: torch.Tensor) -> torch.Tensor:
    """ws [N,num_ws,w_dim] -> planes [N,H,W,3*D*C] (NHWC, the JAX layout;
    channel i*D*C + d*C + c is plane i, slice d, channel c)."""
    n = ws.shape[0]
    img = x = None
    w_idx = 0
    for res in cfg.block_resolutions:
        bname = f"backbone.synthesis.b{res}"
        if res == 4:
            x = p[f"{bname}.const"][None].expand(n, -1, -1, -1)
            x = _synthesis_layer(p, f"{bname}.conv1", x, ws[:, w_idx])
            w_idx += 1
        else:
            x = _synthesis_layer(p, f"{bname}.conv0", x, ws[:, w_idx], up=True)
            x = _synthesis_layer(p, f"{bname}.conv1", x, ws[:, w_idx + 1])
            w_idx += 2
        y = _torgb(p, f"{bname}.torgb", x, ws[:, w_idx])
        img = y if img is None else _upsample2x(img) + y
    return img.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# tri-plane / tri-grid sampling + decoder
# ---------------------------------------------------------------------------

def sample_planes(cfg: EG3DConfig, planes: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """planes [H,W,3*D*C] (one sample), coords [M,3] world -> [M,3,C].

    Projections follow EG3D's generate_planes: (x,y), (x,z), (z,y). For a
    tri-grid (D > 1) the third coordinate interpolates linearly between the
    D depth slices of each plane. Each plane is bilinearly sampled with
    zeros padding and align_corners=False: ``F.grid_sample``."""
    h, w = planes.shape[:2]
    d, c = cfg.triplane_depth, cfg.plane_channels
    pl = planes.permute(2, 0, 1).reshape(3 * d, c, h, w)        # [3D, C, H, W]
    ndc = coords * (2.0 / cfg.box_warp)
    uvs = torch.stack([ndc[:, [0, 1]], ndc[:, [0, 2]], ndc[:, [2, 1]]])   # [3, M, 2]
    grid = uvs.repeat_interleave(d, dim=0)[:, None]             # [3D, 1, M, 2]
    s = F.grid_sample(pl, grid, mode="bilinear", padding_mode="zeros",
                      align_corners=False)[:, :, 0]             # [3D, C, M]
    s = s.reshape(3, d, c, -1).permute(0, 1, 3, 2)              # [3, D, M, C]
    if d == 1:
        return s[:, 0].permute(1, 0, 2)                         # [M, 3, C]
    third = torch.stack([ndc[:, 2], ndc[:, 1], ndc[:, 0]])      # [3, M]
    t = torch.clamp((third + 1.0) * 0.5, 0.0, 1.0) * (d - 1)
    lo = torch.clamp(torch.floor(t).to(torch.int64), 0, d - 2)
    frac = (t - lo)[..., None]
    idx = lo[:, None, :, None].expand(3, 1, lo.shape[1], c)
    s_lo = torch.gather(s, 1, idx)[:, 0]
    s_hi = torch.gather(s, 1, idx + 1)[:, 0]
    return (s_lo * (1 - frac) + s_hi * frac).permute(1, 0, 2)


def decode_samples(p: Params, cfg: EG3DConfig, feats: torch.Tensor):
    """feats [M,3,C] -> (sigma [M,1], rgb_feat [M,decoder_out]). OSGDecoder:
    mean over planes, FC-softplus-FC, sigmoid colour scaling."""
    x = torch.mean(feats, dim=1)
    x = _fc(p, "decoder.net.0", x, act="softplus")
    x = _fc(p, "decoder.net.2", x)
    sigma = x[:, :1]
    rgb = torch.sigmoid(x[:, 1:]) * (1 + 2 * 0.001) - 0.001
    return sigma, rgb


# ---------------------------------------------------------------------------
# ray sampling + two-pass importance volume rendering
# ---------------------------------------------------------------------------

def camera_rays(cam2world: torch.Tensor, intrinsics: torch.Tensor, resolution: int):
    """EG3D RaySampler: pixel-centre rays in world space. cam2world [4,4],
    intrinsics [3,3] normalized (fx, fy, cx, cy in units of the image
    size). Returns origins [R*R,3], directions [R*R,3]."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    uv = (torch.arange(resolution, dtype=torch.float32, device=cam2world.device) + 0.5
          ) / resolution
    v, u = torch.meshgrid(uv, uv, indexing="ij")                 # u right, v down
    x_cam = (u.reshape(-1) - cx) / fx
    y_cam = (v.reshape(-1) - cy) / fy
    dirs_cam = torch.stack([x_cam, y_cam, torch.ones_like(x_cam)], dim=-1)
    dirs_world = dirs_cam @ cam2world[:3, :3].T
    dirs_world = dirs_world / torch.linalg.norm(dirs_world, dim=-1, keepdim=True)
    origins = cam2world[:3, 3].expand(dirs_world.shape)
    return origins, dirs_world


def _composite(cfg: EG3DConfig, sigmas, rgbs, depths):
    """MipRayMarcher2 mid-point compositing. sigmas [R,S,1], rgbs [R,S,C],
    depths [R,S,1] sorted ascending -> (feature [R,C], depth [R,1], weight
    sum [R,1], weights [R,S-1,1])."""
    deltas = depths[:, 1:] - depths[:, :-1]
    sig_mid = F.softplus((sigmas[:, :-1] + sigmas[:, 1:]) * 0.5 + cfg.sigma_bias)
    rgb_mid = (rgbs[:, :-1] + rgbs[:, 1:]) * 0.5
    dep_mid = (depths[:, :-1] + depths[:, 1:]) * 0.5
    alpha = 1.0 - torch.exp(-sig_mid * deltas)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
    weights = alpha * trans
    feature = torch.sum(weights * rgb_mid, dim=1)
    depth = torch.sum(weights * dep_mid, dim=1)
    return feature, depth, torch.sum(weights, dim=1), weights


def _sample_importance(weights: torch.Tensor, depths: torch.Tensor, n_new: int,
                       jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_new`` depths per ray from the weight
    histogram over the bins between the coarse depths. weights [R,S-1,1],
    depths [R,S,1]. ``jitter`` [R, n_new] (uniform in +-0.5/n_new) moves the
    stratified positions; None keeps them at the bin centres."""
    w = weights[:, :, 0] + 1e-5                                  # [R,B]
    cdf = torch.cumsum(w, dim=-1)
    cdf = cdf / cdf[:, -1:]
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # [R,B+1]
    u = (torch.arange(n_new, dtype=torch.float32, device=w.device) + 0.5) / n_new
    u = u.expand(w.shape[0], n_new)
    if jitter is not None:
        u = u + jitter
    u = u.contiguous()
    idx = torch.clamp(torch.searchsorted(cdf, u) - 1, 0, w.shape[1] - 1)
    c0, c1 = torch.gather(cdf, 1, idx), torch.gather(cdf, 1, idx + 1)
    frac = torch.where(c1 > c0, (u - c0) / (c1 - c0 + 1e-10), 0.5)
    d = depths[:, :, 0]
    d_lo = torch.gather(d, 1, idx)
    d_hi = torch.gather(d, 1, torch.clamp(idx + 1, 0, d.shape[1] - 1))
    return (d_lo + frac * (d_hi - d_lo))[:, :, None]


def render_rays(p: Params, cfg: EG3DConfig, planes: torch.Tensor,
                origins: torch.Tensor, dirs: torch.Tensor,
                generator: Optional[torch.Generator] = None):
    """Two-pass importance rendering of [R] rays against one plane set
    [H,W,3*D*C]. With ``generator``, the fine pass's positions are jittered
    from it (the JAX package's ``key``); without, they are deterministic."""
    r = origins.shape[0]
    s = cfg.depth_resolution
    t = torch.linspace(cfg.ray_start, cfg.ray_end, s, dtype=torch.float32,
                       device=origins.device)
    depths = t[None, :, None].expand(r, s, 1)

    def run(depths_):
        pts = origins[:, None, :] + dirs[:, None, :] * depths_
        feats = sample_planes(cfg, planes, pts.reshape(-1, 3))
        sig, rgb = decode_samples(p, cfg, feats)
        return sig.reshape(r, -1, 1), rgb.reshape(r, -1, cfg.decoder_out)

    sig_c, rgb_c = run(depths)
    _, _, _, w_c = _composite(cfg, sig_c, rgb_c, depths)
    n_imp = cfg.depth_resolution_importance
    if n_imp > 0:
        jitter = None
        if generator is not None:
            jitter = (torch.rand((r, n_imp), generator=generator, device=origins.device)
                      - 0.5) / n_imp
        d_fine = _sample_importance(w_c.detach(), depths, n_imp, jitter)
        sig_f, rgb_f = run(d_fine)
        all_d = torch.cat([depths, d_fine], dim=1)
        order = torch.argsort(all_d[:, :, 0], dim=-1, stable=True)
        all_d = torch.gather(all_d, 1, order[..., None])
        all_sig = torch.gather(torch.cat([sig_c, sig_f], dim=1), 1, order[..., None])
        all_rgb = torch.gather(torch.cat([rgb_c, rgb_f], dim=1), 1,
                               order[..., None].expand(-1, -1, cfg.decoder_out))
    else:
        all_d, all_sig, all_rgb = depths, sig_c, rgb_c
    feature, depth, wsum, _ = _composite(cfg, all_sig, all_rgb, all_d)
    return feature, depth, wsum


# ---------------------------------------------------------------------------
# super-resolution
# ---------------------------------------------------------------------------

def superresolution(p: Params, cfg: EG3DConfig, rgb: torch.Tensor,
                    features: torch.Tensor, w_last: torch.Tensor) -> torch.Tensor:
    """EG3D SuperresolutionHybrid: StyleGAN2 blocks lifting the neural
    feature image to sr_resolution. rgb [N,3,h,w], features [N,F,h,w]
    (NCHW); returns [N,3,S,S]."""
    x = features
    for bi, _ in enumerate(cfg.sr_block_resolutions):
        bname = f"superresolution.block{bi}"
        x = _synthesis_layer(p, f"{bname}.conv0", x, w_last, up=True, noise=False)
        x = _synthesis_layer(p, f"{bname}.conv1", x, w_last, noise=False)
        rgb = _upsample2x(rgb) + _torgb(p, f"{bname}.torgb", x, w_last)
    return rgb


# ---------------------------------------------------------------------------
# full synthesis
# ---------------------------------------------------------------------------

def synthesis(p: Params, cfg: EG3DConfig, ws: torch.Tensor, c: torch.Tensor,
              generator: Optional[torch.Generator] = None, return_raw: bool = False):
    """ws [N,num_ws,w_dim], c [N,25] -> dict with 'image' [N,S,S,3] in
    [-1,1], 'image_raw' [N,r,r,3] (neural resolution), 'image_depth'
    [N,r,r,1] (and 'planes' [N,H,W,3DC] with ``return_raw``). A single
    pivot ws renders a batch of camera labels (the multi-view PTI case):
    its planes are computed once. The views render one after another."""
    planes = synthesis_backbone(p, cfg, ws)                    # [B0,H,W,3DC]
    n = c.shape[0]
    if ws.shape[0] == 1 and n > 1:
        ws = ws.expand(n, -1, -1)
        planes = planes.expand(n, -1, -1, -1)
    cam2world = c[:, :16].reshape(n, 4, 4)
    intr = c[:, 16:25].reshape(n, 3, 3)
    res = cfg.neural_resolution
    feats, depths = [], []
    for i in range(n):
        o, d = camera_rays(cam2world[i], intr[i], res)
        feat, depth, _ = render_rays(p, cfg, planes[i], o, d, generator)
        feats.append(feat.reshape(res, res, cfg.decoder_out))
        depths.append(depth.reshape(res, res, 1))
    feats = torch.stack(feats).permute(0, 3, 1, 2)              # [N,F,r,r]
    rgb_raw = feats[:, :3]
    image = superresolution(p, cfg, rgb_raw, feats, ws[:, -1])
    out = {"image": image.permute(0, 2, 3, 1), "image_raw": rgb_raw.permute(0, 2, 3, 1),
           "image_depth": torch.stack(depths)}
    if return_raw:
        out["planes"] = planes
    return out


def render_full(p: Params, cfg: EG3DConfig, z: torch.Tensor, c: torch.Tensor,
                truncation_psi: float = 1.0, generator: Optional[torch.Generator] = None):
    """G(z, c) -> image dict (mapping + synthesis)."""
    ws = mapping_network(p, cfg, z, c, truncation_psi)
    return synthesis(p, cfg, ws, c, generator=generator)


# ---------------------------------------------------------------------------
# EG3D camera label (tools/crop_utils/affine_util.py:5-28 eg3dcamparams)
# ---------------------------------------------------------------------------

def eg3d_camera_label(cam2world: np.ndarray, focal: float = 4.2647) -> np.ndarray:
    """25-d label: flattened cam2world + normalized intrinsics."""
    k = np.array([[focal, 0, 0.5], [0, focal, 0.5], [0, 0, 1]], np.float32)
    return np.concatenate([np.asarray(cam2world, np.float32).reshape(16), k.reshape(9)])
