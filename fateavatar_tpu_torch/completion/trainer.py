"""Completion fine-tuning: interleave real and pseudo frames.

Port of ``fateavatar_tpu/completion/trainer.py`` (train/completor.py:31-454
of the reference, CompletionTrainer). After monocular training and
pseudo-view generation the avatar is re-seeded with a fresh template splat
set (the back of the head was pruned during monocular training) and
fine-tuned with each real frame followed by one random pseudo frame (random
background, orbit camera, canonical pose). The steps are the port's eager
train step: each renders through kernel 1 and back through kernel 2 on the
card.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from fateavatar_tpu_torch.completion.camera_sampler import orbit_cameras, sample_orbit_pose
from fateavatar_tpu_torch.models import maintenance
from fateavatar_tpu_torch.models.fateavatar import fateavatar_forward
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.train.datasets import FaceDataset, FrameRecord, load_mask
from fateavatar_tpu_torch.train.optim import zero_moment_rows
from fateavatar_tpu_torch.train.trainer import Trainer
from fateavatar_tpu_torch.utils.logging import write_video


class PseudoDataset(FaceDataset):
    """The pseudo-view folder PseudoGenerator writes: image/*.png +
    trajectory.json + optional mask/*.png; by default the middle half of the
    orbit only (train/completor.py:119-131)."""

    type_name = "pseudo"

    def __init__(self, pseudo_dir: str, img_res, n_exp: int,
                 flame_canonical_exp=None, flame_canonical_pose=None,
                 orbit_radius: float = 2.7, lookat=(0.0, 0.0, 0.0),
                 fovx: float = 0.8, fovy: float = 0.8,
                 middle_half_only: bool = True, cache_images: bool = True):
        super().__init__(img_res, cache_images=cache_images)
        with open(os.path.join(pseudo_dir, "trajectory.json")) as f:
            traj = json.load(f)

        names = sorted(traj.keys())
        if middle_half_only:
            lo, hi = len(names) // 4, 3 * len(names) // 4
            names = names[lo:hi]

        self.n_exp = n_exp
        self.fovx, self.fovy = fovx, fovy
        exp = (np.zeros((1, n_exp), np.float32) if flame_canonical_exp is None
               else np.asarray(flame_canonical_exp, np.float32).reshape(1, -1))
        pose = (np.zeros((1, 15), np.float32) if flame_canonical_pose is None
                else np.asarray(flame_canonical_pose, np.float32).reshape(1, -1))

        world_mats = []
        for name in names:
            c2w = sample_orbit_pose(traj[name]["azimuth"], np.pi / 2, np.asarray(lookat),
                                    orbit_radius)
            world_mats.append(np.linalg.inv(c2w).astype(np.float32))
            self.records.append(FrameRecord(
                image_path=os.path.join(pseudo_dir, "image", name + ".png"),
                mask_path=os.path.join(pseudo_dir, "mask", name + ".png"),
                img_name=name,
            ))
        self.world_mats = np.stack(world_mats)
        self.expressions = np.repeat(exp, len(names), axis=0)
        self.flame_pose = np.repeat(pose, len(names), axis=0)
        self.shape_params = np.zeros((1, 1), np.float32)
        self.mean_expression = exp
        self.var_expression = None


class CompletionTrainer(Trainer):
    """Trainer with pseudo-frame augmentation (completor.py:88-266)."""

    def __init__(self, *args, pseudo_dataset: Optional[PseudoDataset] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.pseudo_dataset = pseudo_dataset

    def add_default_points(self, seed: int = 0):
        """Re-seed template splats into free capacity before the fine-tune
        (completor.py:153, fateavatar.py:739-812); their Adam moments start
        at zero. The autosized binning capacities are then probed again
        over every real and pseudo view and only grown
        (``Trainer.regrow_caps``): sized for the splats before the re-seed,
        they drop instances (1,056,225 over the 24 steps of
        chip_smoke.py's full-width fine-tune on an H100)."""
        params, state, touched = maintenance.add_default_points(
            self.model, self.ts.params, self.ts.state, seed=seed)
        opt_state = zero_moment_rows(self.ts.opt_state, touched, maintenance.SPLAT_FIELDS)
        self.ts = dataclasses.replace(self.ts, params=params, state=state, opt_state=opt_state)
        self.logger.log(f"[completion] re-seeded template splats, "
                        f"alive={int(torch.sum(state.alive))}")
        if self.autosized:
            ds, pd = self.train_dataset, self.pseudo_dataset
            bg = np.zeros(3, np.float32)
            probes = [self._make_frame(ds.sample(i), cache=False) for i in range(len(ds))]
            if pd is not None:
                probes += [self.pseudo_frame(pd.sample(i), bg) for i in range(len(pd))]
            self.regrow_caps(probes)

    def pseudo_frame(self, p: dict, bg: np.ndarray):
        """A pseudo sample as a Frame on background ``bg`` [3]: the ground
        truth composited onto it through the sample's mask where the mask
        file exists. Built uncached: the device frame cache is keyed by
        train-set index."""
        frame = self._make_frame(p, None, cache=False)
        gt = np.asarray(p["ground_truth"]["rgb"])
        mask_path = self.pseudo_dataset.records[p["idx"]].mask_path
        if mask_path and os.path.exists(mask_path):
            m = load_mask(mask_path, self.pseudo_dataset.img_res)[..., None]
            gt = gt * m + bg * (1 - m)
        return dataclasses.replace(
            frame, bg_color=torch.as_tensor(bg, dtype=torch.float32, device=self.device),
            rgb=torch.as_tensor(np.asarray(gt, np.float32), device=self.device))

    def augmentation(self, finetune_epochs: int = 1, seed: int = 0):
        """The interleaved fine-tune: each real frame's step, then one step
        on a random pseudo frame with a random background colour, both drawn
        from ``np.random.default_rng(seed)`` (completor.py:163-212). Keeps
        each step's aux values (device scalars: loss, psnr, overflow, ...)
        in ``augment_aux`` as ("real" | "pseudo", aux)."""
        if self.pseudo_dataset is None or len(self.pseudo_dataset) == 0:
            raise ValueError("no pseudo dataset")
        rng = np.random.default_rng(seed)
        ds, pd = self.train_dataset, self.pseudo_dataset
        self.augment_aux = []
        aux = None
        for _ in range(finetune_epochs):
            self.epoch += 1
            for i in range(len(ds)):
                real = ds.sample(i)
                frame = self._make_frame(real, self.train_tables
                                         if self.tracking_enabled else None)
                self.ts, aux = self.train_step(self.ts, frame)
                self.global_step += 1
                self.augment_aux.append(("real", aux))

                p = pd.sample(int(rng.integers(len(pd))))
                bg = rng.random(3).astype(np.float32)
                self.ts, aux = self.train_step(self.ts, self.pseudo_frame(p, bg))
                self.global_step += 1
                self.augment_aux.append(("pseudo", aux))
            self.save_checkpoint()
            self.logger.log(f"[completion epoch {self.epoch}] loss={float(aux['loss']):.5f} "
                            f"alive={int(aux['num_alive'])}")

    # ------------------------------------------------------------------
    # 360° result videos (completor.py:269-424)
    # ------------------------------------------------------------------

    def _render(self, s: dict, cam) -> np.ndarray:
        with torch.no_grad():
            out = fateavatar_forward(
                self.model, self.ts.params, self.ts.state,
                torch.as_tensor(s["expression"], dtype=torch.float32, device=self.device),
                torch.as_tensor(s["flame_pose"], dtype=torch.float32, device=self.device),
                cam, render_cfg=self.render_cfg)
        return out["rgb_image"].cpu().numpy()

    def _lookat(self) -> np.ndarray:
        return torch.mean(self.model.flame.v_template, dim=0).cpu().numpy()

    def render_dynamic_novel_view(self, out_path: str, num_frames: int = 100,
                                  radius: float = 2.7):
        """An orbiting camera over the test expression sequence."""
        ds = self.test_dataset or self.train_dataset
        cams, _ = orbit_cameras(num_frames, self._lookat(), radius, float(ds.fovx),
                                float(ds.fovy), self.model.cfg.img_width,
                                self.model.cfg.img_height, device=self.device)
        frames = [self._render(ds.sample(i % len(ds)), cam) for i, cam in enumerate(cams)]
        write_video(out_path, frames)
        return frames

    def render_dynamic_fixed_view(self, out_dir: str, num_frames: int = 50,
                                  radius: float = 2.7,
                                  azimuths=(0, 60, 120, 180, 240, 300)):
        """Six fixed-azimuth videos (completor.py:355-424)."""
        ds = self.test_dataset or self.train_dataset
        lookat = self._lookat()
        os.makedirs(out_dir, exist_ok=True)
        for az in azimuths:
            c2w = sample_orbit_pose(np.deg2rad(az), np.pi / 2, lookat, radius)
            w2c = np.linalg.inv(c2w)
            cam = make_camera(w2c[:3, :3].T, w2c[:3, 3], float(ds.fovx), float(ds.fovy),
                              self.model.cfg.img_width, self.model.cfg.img_height,
                              device=self.device)
            frames = [self._render(ds.sample(i), cam) for i in range(min(num_frames, len(ds)))]
            write_video(os.path.join(out_dir, f"azimuth_{az:03d}.mp4"), frames)
