"""Pivotal Tuning Inversion (PTI) for the EG3D generator.

Port of ``fateavatar_tpu/completion/eg3d/pti.py`` (tools/eg3d_utils/pti.py
of the reference):

* :func:`compute_w_stats`: the W midpoint and spread over z samples at the
  frontal camera;
* :func:`project_w`: stage 1, one pivot w (broadcast to num_ws) fitted to
  the target views with MSE + perceptual + w-norm losses and a ramped
  learning rate;
* :func:`pti_finetune`: stage 2, w frozen, the generator's synthesis,
  super-resolution and decoder tensors tuned on the same targets.

As in the JAX package: noise is the generator's constant noise (no noise
regularization), the perceptual term is VGG16 feature L2 when weights are
given and a four-level L1 pyramid otherwise, and both stages use Adam with
optax's defaults (eps 1e-8) in optax's arithmetic order; in the W stage
Adam's direction (at learning rate 1) is scaled by the ramped rate. Each
step is eager: the views render one after another inside one autograd
graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fateavatar_tpu_torch.completion.eg3d.networks import (
    EG3DConfig,
    Params,
    mapping_network,
    synthesis,
)
from fateavatar_tpu_torch.train.losses import vgg16_features

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class PTIConfig:
    w_steps: int = 200                  # train/completion.py:70 (200 W-steps)
    pti_steps: int = 200                # train/completion.py:71
    w_avg_samples: int = 1024
    w_lr: float = 0.01                  # pti.py:37 initial_learning_rate
    pti_lr: float = 3e-4                # pti.py:262
    lr_rampdown: float = 0.25           # pti.py:39
    lr_rampup: float = 0.05             # pti.py:40
    lambda_mse: float = 0.1             # pti.py:43
    lambda_perc: float = 1.0            # pti.py:44
    lambda_w_norm: float = 1.0          # pti.py:45
    truncation_psi: float = 1.0


def compute_w_stats(p: Params, cfg: EG3DConfig, frontal_label: torch.Tensor,
                    n_samples: int = 1024, generator: Optional[torch.Generator] = None,
                    z: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """W midpoint and spread over z ~ N(0, 1) at the frontal camera
    (pti.py:67-79). ``z`` [n, z_dim] may be given (a test feeds the JAX
    package's draw); else it is drawn from ``generator``. Returns (w_avg
    [w_dim], w_std scalar)."""
    dev = frontal_label.device
    if z is None:
        z = torch.randn((n_samples, cfg.z_dim), generator=generator, device=dev)
    n = z.shape[0]
    with torch.no_grad():
        ws = mapping_network(p, cfg, z, frontal_label.expand(n, cfg.c_dim))
        w0 = ws[:, 0, :]
        w_avg = torch.mean(w0, dim=0)
        w_std = torch.sqrt(torch.sum(torch.square(w0 - w_avg)) / n)
    return w_avg, w_std


def _half(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> half the size, bilinear with the antialiasing
    ``jax.image.resize`` applies when it shrinks."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(x.shape[1] // 2, x.shape[2] // 2),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def _perceptual(vgg_params, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """VGG16 feature L2 on images in [0, 255] NHWC (pti.py:159-169), or the
    weight-free fallback: the mean L1 over a four-level pyramid."""
    if vgg_params is not None:
        fp = vgg16_features(vgg_params, (pred / 255.0).permute(0, 3, 1, 2))
        fg = vgg16_features(vgg_params, (gt / 255.0).permute(0, 3, 1, 2))
        return sum(torch.mean(torch.square(a - b)) for a, b in zip(fp, fg))
    loss, a, b = 0.0, pred, gt
    for _ in range(4):
        loss = loss + torch.mean(torch.abs(a - b))
        a, b = _half(a), _half(b)
    return loss / 4.0


def _inversion_loss(p: Params, cfg: EG3DConfig, pti_cfg: PTIConfig, w_broadcast,
                    targets, labels, w_ref, vgg_params):
    """The loss shared by both stages over all target views. targets
    [V,H,W,3] in [-1,1]. Returns (loss, {"mse", "perc"})."""
    pred = synthesis(p, cfg, w_broadcast, labels)["image"]
    mse = torch.mean(torch.square(pred - targets))
    perc = _perceptual(vgg_params, (pred * 0.5 + 0.5) * 255.0, (targets * 0.5 + 0.5) * 255.0)
    w_norm = torch.mean(torch.square(w_broadcast[:, 0] - w_ref))
    return (pti_cfg.lambda_mse * mse + pti_cfg.lambda_perc * perc
            + pti_cfg.lambda_w_norm * w_norm), {"mse": mse, "perc": perc}


def _w_lr_schedule(pti_cfg: PTIConfig, step: int) -> float:
    """pti.py:178-183 ramped cosine schedule."""
    t = step / max(pti_cfg.w_steps, 1)
    lr_ramp = min(1.0, (1.0 - t) / pti_cfg.lr_rampdown)
    lr_ramp = 0.5 - 0.5 * np.cos(lr_ramp * np.pi)
    lr_ramp = lr_ramp * min(1.0, t / pti_cfg.lr_rampup)
    return pti_cfg.w_lr * lr_ramp


class _Adam:
    """optax.adam's update, in its arithmetic order, over a list of
    tensors; ``direction(grads)`` returns the updates at learning rate 1."""

    def __init__(self, tensors: List[torch.Tensor]):
        self.mu = [torch.zeros_like(t) for t in tensors]
        self.nu = [torch.zeros_like(t) for t in tensors]
        self.count = 0

    @torch.no_grad()
    def direction(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        self.count += 1
        c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        out = []
        for g, m, v in zip(grads, self.mu, self.nu):
            m.copy_((1 - B1) * g + B1 * m)
            v.copy_((1 - B2) * g * g + B2 * v)
            out.append(-(m / c1 / (torch.sqrt(v / c2) + EPS)))
        return out


def project_w(p: Params, cfg: EG3DConfig, pti_cfg: PTIConfig, targets: torch.Tensor,
              labels: torch.Tensor, generator: Optional[torch.Generator] = None,
              vgg_params=None, log_fn: Optional[Callable] = None,
              z: Optional[torch.Tensor] = None,
              loss_log: Optional[list] = None) -> torch.Tensor:
    """Stage 1: fit a single pivot w to V target views. targets [V,H,W,3] in
    [-1,1] at cfg.sr_resolution; labels [V,25]. The W statistics' z is
    ``z`` or drawn from ``generator``. Each step's loss (a device scalar)
    is appended to ``loss_log`` where given. Returns ws [1,num_ws,w_dim]."""
    p = {k: v.detach() for k, v in p.items()}
    w_avg, _ = compute_w_stats(p, cfg, labels[0], pti_cfg.w_avg_samples, generator, z)
    w = w_avg[None, :].clone()
    opt = _Adam([w])
    for i in range(pti_cfg.w_steps):
        lr = _w_lr_schedule(pti_cfg, i)
        wl = w.requires_grad_()
        loss, aux = _inversion_loss(p, cfg, pti_cfg, wl[:, None, :].expand(-1, cfg.num_ws, -1),
                                    targets, labels, w_avg, vgg_params)
        (g,) = torch.autograd.grad(loss, [wl])
        (upd,) = opt.direction([g])
        w = (w.detach() + lr * upd)
        if loss_log is not None:
            loss_log.append(loss.detach())
        if log_fn and (i % 50 == 0 or i == pti_cfg.w_steps - 1):
            log_fn(f"[pti:W] step {i} loss {float(loss.detach()):.4f} "
                   f"mse {float(aux['mse'].detach()):.3e}")
    return w.detach()[:, None, :].expand(-1, cfg.num_ws, -1).contiguous()


PTI_TRAINABLE = ("backbone.synthesis", "superresolution", "decoder")


def pti_finetune(p: Params, cfg: EG3DConfig, pti_cfg: PTIConfig, ws: torch.Tensor,
                 targets: torch.Tensor, labels: torch.Tensor, vgg_params=None,
                 log_fn: Optional[Callable] = None,
                 loss_log: Optional[list] = None) -> Params:
    """Stage 2: generator fine-tune at the fixed pivot ws (pti.py:249-362).
    The trainable tensors are the synthesis (its const and noise strengths
    included), super-resolution and decoder ones, without ``noise_const``.
    Returns the tuned dict (new tensors; ``p`` is left as it was)."""
    trainable = {k: v.detach().clone() for k, v in p.items()
                 if k.startswith(PTI_TRAINABLE) and "noise_const" not in k}
    frozen = {k: v.detach() for k, v in p.items() if k not in trainable}
    names = list(trainable)
    opt = _Adam([trainable[k] for k in names])
    ws = ws.detach()
    for i in range(pti_cfg.pti_steps):
        leaves = [trainable[k].requires_grad_() for k in names]
        loss, aux = _inversion_loss({**frozen, **dict(zip(names, leaves))}, cfg, pti_cfg,
                                    ws, targets, labels, ws[0, 0], vgg_params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        upd = opt.direction(grads)
        with torch.no_grad():
            trainable = {k: t.detach() + pti_cfg.pti_lr * u
                         for k, t, u in zip(names, leaves, upd)}
        if loss_log is not None:
            loss_log.append(loss.detach())
        if log_fn and (i % 50 == 0 or i == pti_cfg.pti_steps - 1):
            log_fn(f"[pti:G] step {i} loss {float(loss.detach()):.4f} "
                   f"mse {float(aux['mse'].detach()):.3e}")
    return {**frozen, **trainable}

