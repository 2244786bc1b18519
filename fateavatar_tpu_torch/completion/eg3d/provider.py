"""EG3D-backed pseudo-view provider: the generative stages ⑤ and ⑥.

Port of ``fateavatar_tpu/completion/eg3d/provider.py``
(train/completion.py:564-707 of the reference): invert the avatar's frontal
crops into the generator through PTI, then render the tuned generator along
the full orbit to hallucinate the unseen back of the head.

Angles: 0 is the front, increasing counter-clockwise; EG3D's frontal camera
sits at horizontal pi/2 (tools/eg3d_utils/pti.py:71), so h = pi/2 + angle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fateavatar_tpu_torch.completion.camera_sampler import sample_orbit_pose
from fateavatar_tpu_torch.completion.eg3d.networks import (
    EG3DConfig,
    EG3DGenerator,
    Params,
    eg3d_camera_label,
    synthesis,
)
from fateavatar_tpu_torch.completion.eg3d.pti import PTIConfig, project_w, pti_finetune


@dataclass
class EG3DProviderConfig:
    front_halfwidth: float = np.pi / 3   # inversion targets: |angle| below this
    max_target_views: int = 8
    radius: float = 2.7                  # EG3D canonical orbit (pti.py:71)
    focal: float = 4.2647                # EG3D intrinsics (pti.py:72)
    truncation_psi: float = 1.0
    seed: int = 0


def _resize_nhwc(x: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(..., "linear")`` of NHWC to size x size: bilinear,
    antialiased when it shrinks."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


class EG3DPseudoProvider:
    """PTI inversion + orbit re-render with the EG3D generator. The W
    statistics draw their z from a ``torch.Generator`` seeded with
    ``provider_cfg.seed``. Each stage's per-step losses are kept in
    ``losses["w"]`` / ``losses["g"]`` (device scalars), the last inversion's
    targets and labels in ``targets`` / ``target_labels``."""

    def __init__(self, generator: EG3DGenerator, pti_cfg: PTIConfig = PTIConfig(),
                 provider_cfg: EG3DProviderConfig = EG3DProviderConfig(),
                 vgg_params=None, log_fn=None):
        self.generator = generator
        self.params: Params = generator.params()
        self.cfg: EG3DConfig = generator.cfg
        self.device = next(iter(self.params.values())).device
        self.pti_cfg = pti_cfg
        self.pcfg = provider_cfg
        self.vgg_params = vgg_params
        self.log_fn = log_fn
        self.tuned_params: Optional[Params] = None
        self.ws: Optional[torch.Tensor] = None
        self.targets: Optional[torch.Tensor] = None
        self.target_labels: Optional[torch.Tensor] = None
        self.losses = {"w": [], "g": []}

    # ------------------------------------------------------------------
    def _label(self, angle: float) -> np.ndarray:
        c2w = sample_orbit_pose(np.pi / 2 + angle, np.pi / 2, np.zeros(3), self.pcfg.radius)
        return eg3d_camera_label(c2w, self.pcfg.focal)

    def _resize(self, imgs: np.ndarray, size: int) -> torch.Tensor:
        """[0,1] NHWC images -> [-1,1] at size x size, on the device."""
        x = torch.as_tensor(np.asarray(imgs, np.float32), device=self.device)
        return _resize_nhwc(x, size) * 2.0 - 1.0

    def target_views(self, angles: np.ndarray):
        """The inversion targets (provider.py:58-93): the views within
        ``front_halfwidth`` of the front, nearest first, at most
        ``max_target_views`` (the nearest view alone when none is). Returns
        (indices, wrapped angles)."""
        wrapped = (np.asarray(angles) + np.pi) % (2 * np.pi) - np.pi
        order = np.argsort(np.abs(wrapped))
        keep = [i for i in order if abs(wrapped[i]) <= self.pcfg.front_halfwidth]
        return keep[: self.pcfg.max_target_views] or [int(order[0])], wrapped

    # ------------------------------------------------------------------
    def invert(self, crops: np.ndarray, angles: np.ndarray,
               labels: Optional[np.ndarray] = None) -> None:
        """Both PTI stages on the frontal subset of the crops. ``labels``:
        the crops' 25-d EG3D camera labels from stage ③; without them the
        provider's own orbit labels."""
        keep, wrapped = self.target_views(angles)
        targets = self._resize(crops[keep], self.cfg.sr_resolution)
        if labels is not None:
            lab = np.stack([labels[i] for i in keep])
        else:
            lab = np.stack([self._label(wrapped[i]) for i in keep])
        lab = torch.as_tensor(lab, dtype=torch.float32, device=self.device)
        self.targets, self.target_labels = targets, lab
        gen = torch.Generator(device=self.device).manual_seed(self.pcfg.seed)
        self.losses = {"w": [], "g": []}
        self.ws = project_w(self.params, self.cfg, self.pti_cfg, targets, lab, gen,
                            self.vgg_params, self.log_fn, loss_log=self.losses["w"])
        self.tuned_params = pti_finetune(self.params, self.cfg, self.pti_cfg, self.ws,
                                         targets, lab, self.vgg_params, self.log_fn,
                                         loss_log=self.losses["g"])

    @torch.no_grad()
    def render_orbit(self, angles: np.ndarray, out_size: int) -> np.ndarray:
        """The tuned generator at each orbit angle: [V, out_size, out_size, 3]
        in [0, 1]."""
        if self.tuned_params is None:
            raise RuntimeError("render_orbit needs the tuned generator: call invert() first")
        out = []
        for a in angles:
            c = torch.as_tensor(self._label(float((a + np.pi) % (2 * np.pi) - np.pi)),
                                device=self.device)[None]
            img = synthesis(self.tuned_params, self.cfg, self.ws, c)["image"]
            img = torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)
            if img.shape[1] != out_size:
                img = _resize_nhwc(img, out_size)
            out.append(img[0].cpu().numpy())
        return np.stack(out)

    # ------------------------------------------------------------------
    def generate(self, crops: np.ndarray, angles: np.ndarray,
                 labels: Optional[np.ndarray] = None,
                 out_angles: Optional[np.ndarray] = None) -> np.ndarray:
        """The PseudoViewProvider entry (pseudo.py stages ⑤/⑥)."""
        self.invert(crops, angles, labels=labels)
        if out_angles is None:
            out_angles = angles
        return self.render_orbit(np.asarray(out_angles), crops.shape[1])
