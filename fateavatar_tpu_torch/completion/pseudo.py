"""Pseudo-view generation for 360° head completion.

Port of ``fateavatar_tpu/completion/pseudo.py`` (train/completion.py:41-1074
of the reference, PseudoGenerator). The nine stages:

  ① render_novel_view     — orbit renders of the trained avatar, through
                            ``fateavatar_forward`` (on the card: kernel 1)
  ② keypoints/pose        — the exact FLAME 68 landmarks, projected
  ③ affine crop           — FFHQ-style quad crop (``alignment.py``: numpy /
                            torch in place of OpenCV)
  ④ face restoration      — a ``restorer_fn`` hook
  ⑤ GAN inversion (PTI)   — a pluggable provider (``eg3d/provider.py``)
  ⑥ orbit re-render       — the provider
  ⑦ inverse paste-back    — the inverse affine composite (``alignment.py``)
  ⑧ mask retrieval        — a ``matting_fn`` hook, else an alpha fallback
  ⑨ heatmap check         — L1 maps GS-render vs pseudo

:class:`MirrorPseudoProvider` runs the pipeline with no weights: the
back-head views mirror the avatar's own renders and fade towards the mean
head colour, a placeholder for a generative prior, clearly marked as such.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Optional, Protocol

import numpy as np
import torch

from fateavatar_tpu_torch.completion import alignment
from fateavatar_tpu_torch.completion.camera_sampler import orbit_cameras
from fateavatar_tpu_torch.flame.flame import (
    dynamic_lmk_rows_from_rot,
    flame_forward,
    flame_landmarks,
    vertices2landmarks,
)
from fateavatar_tpu_torch.models.fateavatar import fateavatar_forward
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.utils.logging import Logger, save_image


class PseudoViewProvider(Protocol):
    """Stages ⑤/⑥: given the avatar's FFHQ-aligned crops (and their EG3D
    camera labels from stage ③), produce pseudo views along
    ``out_angles``."""

    def generate(self, crops: np.ndarray, angles: np.ndarray,
                 labels: Optional[np.ndarray] = None,
                 out_angles: Optional[np.ndarray] = None) -> np.ndarray:
        ...


class MirrorPseudoProvider:
    """Weight-free placeholder provider: mirrors the nearest source view and
    fades detail with angular distance from the front. Not a generative
    prior: it documents the interface and keeps the pipeline runnable."""

    def generate(self, crops: np.ndarray, angles: np.ndarray,
                 labels: Optional[np.ndarray] = None,
                 out_angles: Optional[np.ndarray] = None) -> np.ndarray:
        if out_angles is None:
            out_angles = angles
        src_a = (np.asarray(angles) + np.pi) % (2 * np.pi) - np.pi
        out = []
        mean_color = crops.mean(axis=(0, 1, 2), keepdims=True)[0]
        for ang in out_angles:
            # wrap the angle to [-pi, pi); 0 is the front
            a = (ang + np.pi) % (2 * np.pi) - np.pi
            i = int(np.argmin(np.abs(np.abs(src_a) - abs(a)) % (2 * np.pi)))
            src = crops[i]
            img = src[:, ::-1] if a < 0 else src
            back_ness = min(abs(a) / np.pi, 1.0)
            out.append(img * (1 - back_ness) + mean_color * back_ness)
        return np.stack(out).astype(np.float32)


@dataclass
class PseudoGeneratorConfig:
    num_views: int = 30
    orbit_radius: float = 2.7
    crop_size: int = 512
    out_dir: str = "./pseudo"
    # crop_final rejects faces smaller than this many px (affine_util.py:99
    # uses 256 at 512^2 renders); None disables it (small test renders)
    min_face_size: Optional[int] = None


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class PseudoGenerator:
    """Drives the staged pipeline over a trained avatar (the Loader role of
    train/completion.py:41-157). Renders and the alignment's image ops run
    on the avatar's device."""

    def __init__(self, model, params, state, cfg: PseudoGeneratorConfig,
                 render_cfg: RenderConfig = RenderConfig(),
                 provider: Optional[PseudoViewProvider] = None,
                 matting_fn: Optional[Callable] = None,
                 restorer_fn: Optional[Callable] = None,
                 logger: Optional[Logger] = None):
        self.model = model
        self.params = params
        self.state = state
        self.cfg = cfg
        self.render_cfg = render_cfg
        self.provider = provider or MirrorPseudoProvider()
        self.matting_fn = matting_fn
        self.restorer_fn = restorer_fn
        self.logger = logger or Logger("pseudo")
        self.device = model.bg_color.device
        os.makedirs(cfg.out_dir, exist_ok=True)

    # ------------------------------------------------------------------
    # stage ①: orbit renders of the trained avatar (completion.py:159-251)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_novel_view(self, fovx: float, fovy: float, radius: float = None):
        cfgm = self.model.cfg
        lookat = _np(torch.mean(self.model.flame.v_template, dim=0))
        cams, c2ws = orbit_cameras(
            self.cfg.num_views, lookat, radius or self.cfg.orbit_radius,
            fovx, fovy, cfgm.img_width, cfgm.img_height,
            # index 0 is the front: EG3D's frontal camera sits at horizontal
            # pi/2 (tools/eg3d_utils/pti.py:71), so h = pi/2 + angle
            h_range=(np.pi / 2, np.pi / 2 + 2 * np.pi), device=self.device,
        )
        self._last_cams = cams          # reused by stages ②/③ in run()
        self._lookat = lookat
        expr = self.model.flame.canonical_exp[0]
        pose = self.model.flame.canonical_pose[0]
        images = []
        view_dir = os.path.join(self.cfg.out_dir, "novel_views")
        os.makedirs(view_dir, exist_ok=True)
        for i, cam in enumerate(cams):
            img = _np(fateavatar_forward(self.model, self.params, self.state, expr, pose, cam,
                                         render_cfg=self.render_cfg)["rgb_image"])
            images.append(img)
            save_image(os.path.join(view_dir, f"{i:04d}.png"), img)
        np.save(os.path.join(self.cfg.out_dir, "c2w.npy"), c2ws)
        self.logger.log(f"[pseudo ①] {len(images)} orbit views -> {view_dir}")
        return np.stack(images), c2ws

    # ------------------------------------------------------------------
    # stage ②: keypoints (completion.py:253-303). The camera and the driving
    # mesh are known, so the exact FLAME landmarks are projected (None
    # without the landmark embedding).
    # ------------------------------------------------------------------
    @torch.no_grad()
    def detect_keypoints(self, cams):
        flame = self.model.flame
        if flame.lmk_faces_idx is None:
            self.logger.log("[pseudo ②] no landmark embedding — skipped")
            return None
        verts, _, _ = flame_forward(flame, flame.canonical_exp, flame.canonical_pose)
        out = []
        for cam in cams:
            if flame.dynamic_lmk_faces_idx is not None:
                # a detector on an orbit render sees the camera azimuth as
                # head yaw: the contour row from the view rotation
                dyn_f, dyn_b = dynamic_lmk_rows_from_rot(flame, cam.view[None, :3, :3])
                faces_idx = torch.cat([dyn_f[0], flame.lmk_faces_idx[-51:]])
                bary = torch.cat([dyn_b[0], flame.lmk_bary_coords[-51:]])
                lmk3d = vertices2landmarks(verts, flame.faces, faces_idx, bary)[0]
            else:
                lmk3d = flame_landmarks(flame, verts)[0]             # [68, 3]
            p = lmk3d @ cam.full_proj[:, :3].T + cam.full_proj[:, 3]
            ndc = p[:, :2] / torch.clamp_min(p[:, 3:4], 1e-6)
            # ndc2Pix pixel-centre convention
            wh = torch.tensor([cam.width, cam.height], dtype=torch.float32, device=ndc.device)
            px = ((ndc + 1.0) * wh - 1.0) * 0.5
            visible = p[:, 3] > 0
            out.append(np.concatenate([_np(px), _np(visible)[:, None]], axis=1))
        kps = np.stack(out)                                           # [V, 68, 3]
        np.save(os.path.join(self.cfg.out_dir, "keypoints.npy"), kps)
        self.logger.log(f"[pseudo ②] projected FLAME 68-kps for {len(cams)} views")
        return kps

    # ------------------------------------------------------------------
    # stage ③: FFHQ-style alignment (train/completion.py:305-498). The head
    # pose (the EG3D label and the rejection filters) and the head centre
    # (the quad refinement) come from the known camera and mesh.
    # ------------------------------------------------------------------
    def execute_affine_transform(self, renders, keypoints, cams):
        size = self.cfg.crop_size
        V = len(renders)
        angles = np.linspace(0, 2 * np.pi, V, endpoint=False)
        # world -> CV-camera frame: the head faces +z with +y up, so at the
        # frontal view the GAN-frame pose is the identity
        flip = np.diag([1.0, -1.0, -1.0])

        crop_dir = os.path.join(self.cfg.out_dir, "affine")
        os.makedirs(crop_dir, exist_ok=True)
        out = {"index": [], "angle": [], "crop": [], "label": [], "quad": []}
        labels_json = []
        for i in range(V):
            cam = cams[i]
            lm = np.asarray(keypoints[i][:, :2])
            quad, c, x_ax, y_ax = alignment.get_crop_bound(lm)

            # exact head centre -> initial-crop coordinates
            h = _np(cam.full_proj).astype(np.float64) @ np.append(self._lookat, 1.0)
            ndc = h[:2] / max(float(h[3]), 1e-6)
            ctr = ((ndc + 1.0) * np.array([cam.width, cam.height]) - 1.0) * 0.5
            bound = np.array([[0, 0], [0, size - 1], [size - 1, size - 1]], np.float32)
            mat = alignment.get_affine_transform(quad[:3].astype(np.float32), bound)
            ctr_crop = mat[:, :2] @ ctr + mat[:, 2]
            quad2, t3d = alignment.refine_quad(c, x_ax, y_ax, ctr_crop, size)
            if not np.isfinite(quad2).all():
                self.logger.log(f"[pseudo ③] view {i:04d} rejected: degenerate quad")
                continue

            R_gan = flip @ _np(cam.view)[:3, :3]
            reason = alignment.pose_reject(R_gan, t3d)
            if reason is not None:
                self.logger.log(f"[pseudo ③] view {i:04d} rejected: {reason}")
                continue
            crop = alignment.crop_final(renders[i], size, quad2,
                                        min_size=self.cfg.min_face_size, device=self.device)
            if crop is None:
                self.logger.log(f"[pseudo ③] view {i:04d} rejected: face "
                                f"< {self.cfg.min_face_size}px")
                continue
            R4 = np.eye(4, dtype=np.float32)
            R4[:3, :3] = R_gan
            label = alignment.eg3dcamparams(R4)
            save_image(os.path.join(crop_dir, f"{i:04d}.png"), crop)
            labels_json.append((f"{i:04d}.png", [format(v, ".6f") for v in label]))
            out["index"].append(i)
            out["angle"].append(angles[i])
            out["crop"].append(crop)
            out["label"].append(label)
            out["quad"].append(quad2)

        with open(os.path.join(crop_dir, "dataset.json"), "w") as f:
            json.dump({"labels": labels_json}, f, indent="\t")
        if out["index"]:
            np.save(os.path.join(self.cfg.out_dir, "quads.npy"), np.stack(out["quad"]))
            # the paste-back reference quad: the accepted view closest to the
            # front (the reference picks 0001.png, completion.py:740)
            front = int(np.argmin(np.abs(
                (np.asarray(out["angle"]) + np.pi) % (2 * np.pi) - np.pi)))
            out["front_quad"] = out["quad"][front]
        else:
            out["front_quad"] = None
        for k in ("crop", "label", "angle"):
            out[k] = np.asarray(out[k], np.float32) if out[k] else None
        self.logger.log(f"[pseudo ③] {len(out['index'])}/{V} views aligned -> {crop_dir}")
        return out

    # ------------------------------------------------------------------
    # stage ⑦: inverse paste-back (train/completion.py:709-816)
    # ------------------------------------------------------------------
    def execute_inverse_transform(self, pseudo, front_quad):
        pasted, valid = alignment.paste_back_images(
            pseudo, front_quad, out_size=self.model.cfg.img_height,
            bg_color=float(_np(self.model.bg_color).mean()), device=self.device)
        img_dir = os.path.join(self.cfg.out_dir, "image")
        os.makedirs(img_dir, exist_ok=True)
        for i, img in enumerate(pasted):
            save_image(os.path.join(img_dir, f"{i:04d}.png"), img)
        self.logger.log(f"[pseudo ⑦] {len(pasted)} views pasted -> {img_dir}")
        return pasted, valid

    # ------------------------------------------------------------------
    # single-image helpers (kept for ad-hoc use)
    # ------------------------------------------------------------------
    @staticmethod
    def crop_with_quad(image: np.ndarray, quad: np.ndarray, size: int, device="cuda"):
        src = quad.astype(np.float32)[:3]
        dst = np.array([[0, 0], [0, size - 1], [size - 1, size - 1]], np.float32)
        M = alignment.get_affine_transform(src, dst)
        out = alignment.warp_affine((image * 255).astype(np.uint8), M, (size, size),
                                    device=device)
        return out.astype(np.float32) / 255.0, M

    @staticmethod
    def paste_back(original: np.ndarray, crop: np.ndarray, M: np.ndarray,
                   mask: Optional[np.ndarray] = None, device="cuda"):
        h, w = original.shape[:2]
        inv = alignment.invert_affine_transform(M)
        warped = alignment.warp_affine((crop * 255).astype(np.uint8), inv, (w, h),
                                       device=device)
        warped = warped.astype(np.float32) / 255.0
        if mask is None:
            mask = alignment.warp_affine(np.ones(crop.shape[:2], np.float32), inv, (w, h),
                                         device=device)
        mask = mask[..., None] if mask.ndim == 2 else mask
        return warped * mask + original * (1 - mask)

    # ------------------------------------------------------------------
    # stages ⑤/⑥: provider-driven pseudo views (aligned GAN frame)
    # ------------------------------------------------------------------
    def generate_pseudo_views(self, crops: np.ndarray,
                              crop_angles: Optional[np.ndarray] = None,
                              labels: Optional[np.ndarray] = None):
        out_angles = np.linspace(0, 2 * np.pi, self.cfg.num_views, endpoint=False)
        if crop_angles is None:
            crop_angles = out_angles[: len(crops)]
        pseudo = self.provider.generate(crops, crop_angles, labels=labels,
                                        out_angles=out_angles)
        img_dir = os.path.join(self.cfg.out_dir, "image_aligned")
        os.makedirs(img_dir, exist_ok=True)
        trajectory = {}
        for i, (img, ang) in enumerate(zip(pseudo, out_angles)):
            name = f"{i:04d}"
            save_image(os.path.join(img_dir, name + ".png"), img)
            trajectory[name] = {"azimuth": float(ang)}
        with open(os.path.join(self.cfg.out_dir, "trajectory.json"), "w") as f:
            json.dump(trajectory, f, indent=2)
        self.logger.log(f"[pseudo ⑤/⑥] {len(pseudo)} pseudo views -> {img_dir}")
        return pseudo, out_angles

    # ------------------------------------------------------------------
    # stage ⑧: masks (completion.py:818-1028): the matting hook, else the
    # distance from the background colour
    # ------------------------------------------------------------------
    def retrieve_masks(self, images: np.ndarray):
        mask_dir = os.path.join(self.cfg.out_dir, "mask")
        os.makedirs(mask_dir, exist_ok=True)
        bg = _np(self.model.bg_color)
        masks = []
        for i, img in enumerate(images):
            if self.matting_fn is not None:
                m = self.matting_fn(img)
            else:
                m = (np.abs(img - bg).sum(-1) > 0.08).astype(np.float32)
            masks.append(m)
            save_image(os.path.join(mask_dir, f"{i:04d}.png"),
                       np.repeat(m[..., None], 3, axis=-1))
        return np.stack(masks)

    # ------------------------------------------------------------------
    # stage ⑨: heatmap sanity check (completion.py:1030-1066)
    # ------------------------------------------------------------------
    def heatmap_check(self, gs_renders: np.ndarray, pseudo: np.ndarray):
        heat_dir = os.path.join(self.cfg.out_dir, "heatmap")
        os.makedirs(heat_dir, exist_ok=True)
        scores = []
        for i, (a, b) in enumerate(zip(gs_renders, pseudo)):
            l1 = np.abs(a - b).mean(-1)
            scores.append(float(l1.mean()))
            heat = np.stack([l1, np.zeros_like(l1), 1 - l1], axis=-1)
            save_image(os.path.join(heat_dir, f"{i:04d}.png"), heat)
        self.logger.log(f"[pseudo ⑨] mean L1 GS-vs-pseudo: {np.mean(scores):.4f}")
        return scores

    # ------------------------------------------------------------------
    def run(self, fovx: float, fovy: float):
        """The whole pipeline: ① orbit render -> ② exact keypoints -> ③ FFHQ
        align + EG3D labels (+ pose rejection) -> ④ restore the aligned
        crops -> ⑤/⑥ provider -> ⑦ paste back into the original framing ->
        ⑧ masks -> ⑨ heatmaps. Writes ``image/`` (pasted, original framing:
        what the completion trainer reads) and ``trajectory.json``."""
        renders, c2ws = self.render_novel_view(fovx, fovy)
        keypoints = self.detect_keypoints(self._last_cams)

        aligned = None
        if keypoints is not None:
            aligned = self.execute_affine_transform(renders, keypoints, self._last_cams)
        if aligned is None or aligned["front_quad"] is None:
            # no landmark embedding, or every view rejected: feed the raw
            # renders, skip the paste-back
            self.logger.log("[pseudo ③] no aligned views; falling back to "
                            "raw renders (no paste-back)")
            crops, crop_angles, labels = renders, None, None
        else:
            crops = aligned["crop"]
            crop_angles = aligned["angle"]
            labels = aligned["label"]

        if self.restorer_fn is not None:
            # stage ④ (completion.py:500-562): restoration of the aligned
            # crops that feed the provider
            crops = self.restorer_fn(crops)
            self.logger.log("[pseudo ④] aligned crops restored")

        pseudo, angles = self.generate_pseudo_views(crops, crop_angles, labels)

        if aligned is not None and aligned["front_quad"] is not None:
            pasted, _valid = self.execute_inverse_transform(pseudo, aligned["front_quad"])
        else:
            pasted = pseudo
            img_dir = os.path.join(self.cfg.out_dir, "image")
            os.makedirs(img_dir, exist_ok=True)
            for i, img in enumerate(pasted):
                save_image(os.path.join(img_dir, f"{i:04d}.png"), img)

        masks = self.retrieve_masks(pasted)
        self.heatmap_check(renders, pasted)
        return {"renders": renders, "pseudo": pseudo, "pasted": pasted,
                "masks": masks, "angles": angles, "c2w": c2ws,
                "keypoints": keypoints, "aligned": aligned}
