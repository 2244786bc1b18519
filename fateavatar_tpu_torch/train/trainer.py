"""Trainer: host-side orchestration of the training step.

Port of the per-step mode of ``fateavatar_tpu/train/trainer.py``
(train/base.py:14-245 + train/trainer.py:61-632 of the reference): startup
autosizing of the binning capacities, epochs of one step per frame over a
prefetched dataset, meters, evaluation, checkpoints and resume. Host <->
device traffic per step is one frame's metadata (the ground truth is cached
on the device as uint8 after its first upload); the loss values stay on the
device and are fetched in batches of 50 steps.

Not ported yet: the scan-epoch mode (one dispatch per epoch; its CUDA
counterpart would be CUDA graphs), data parallel, tracking refinement,
family adapters, snapshots and videos, the fps test.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from fateavatar_tpu_torch.models.fateavatar import FateAvatarModel, fateavatar_forward
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.render.autosize import autosize_render_config
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train import metrics as metrics_mod
from fateavatar_tpu_torch.train.checkpoints import CheckpointManager
from fateavatar_tpu_torch.train.datasets import FaceDataset, Prefetcher
from fateavatar_tpu_torch.train.losses import as_float_rgb
from fateavatar_tpu_torch.train.optim import MultiAdam, MultiAdamState
from fateavatar_tpu_torch.train.step import (
    Frame,
    MaintenanceConfig,
    TrainState,
    init_train_state,
    make_train_step,
)

FLUSH_EVERY = 50   # steps between fetches of the device-side loss values


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


class Trainer:
    def __init__(
        self,
        name: str,
        model: FateAvatarModel,
        params,
        state,
        loss_fn,
        optimizer: MultiAdam,
        train_dataset: FaceDataset,
        test_dataset: Optional[FaceDataset] = None,
        workspace: Optional[str] = None,
        maint_cfg: MaintenanceConfig = MaintenanceConfig(),
        render_cfg: RenderConfig = RenderConfig(),
        bg_color=(1.0, 1.0, 1.0),
        seed: int = 0,
    ):
        self.name = name
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset
        self.workspace = workspace
        self.device = params.offset.device
        self.bg_color = torch.as_tensor(bg_color, dtype=torch.float32, device=self.device)
        self.epoch = 0
        self.global_step = 0
        self._log_path = None
        if workspace is not None:
            os.makedirs(os.path.join(workspace, "media", "metrics"), exist_ok=True)
            self._log_path = os.path.join(workspace, f"log_{name}.txt")
            self.ckpt = CheckpointManager(os.path.join(workspace, "checkpoints"))
        else:
            self.ckpt = None

        # ground truth cached on the device as uint8 (4x smaller) after its
        # first upload, converted inside the loss (losses.as_float_rgb),
        # when the whole dataset fits 4 GiB
        h, w = model.cfg.img_height, model.cfg.img_width
        fits = len(train_dataset) * h * w * 3 <= 4 << 30
        self._frame_cache: Optional[dict] = {} if fits else None

        if render_cfg.autosize:
            # measure the dataset's tile occupancy on its first frames and
            # size instance_budget / R / tail_k from it (render/autosize.py)
            probes = [self._make_frame(train_dataset.sample(i), cache=False)
                      for i in range(min(4, len(train_dataset)))]
            render_cfg = autosize_render_config(
                model, params, state, probes,
                dataclasses.replace(render_cfg, autosize=False), log_fn=self.log)
        self.render_cfg = render_cfg
        self.maint_cfg = maint_cfg
        self.train_step = make_train_step(model, loss_fn, optimizer, maint_cfg, render_cfg)
        self.ts: TrainState = init_train_state(params, state, optimizer, seed)
        self.last_epoch_stats: Optional[dict] = None

    def log(self, msg: str):
        print(msg, flush=True)
        if self._log_path is not None:
            with open(self._log_path, "a") as f:
                f.write(msg + "\n")

    # ------------------------------------------------------------------
    # frames
    # ------------------------------------------------------------------

    def _make_frame(self, sample: dict, cache: bool = True) -> Frame:
        """A dataset sample as a Frame on the device. ``cache`` keys the
        uint8 ground truth by TRAIN-set index; samples of another dataset
        (evaluation on the test set) pass cache=False."""
        dev = self.device
        h, w = self.model.cfg.img_height, self.model.cfg.img_width
        cam_pose = np.asarray(sample["cam_pose"], np.float32)
        camera = make_camera(cam_pose[:3, :3].T, cam_pose[:3, 3], sample["fovx"],
                             sample["fovy"], w, h, device=dev)
        rgb = np.asarray(sample["ground_truth"]["rgb"], np.float32)
        if cache and self._frame_cache is not None:
            gt = self._frame_cache.get(sample["idx"])
            if gt is None:
                gt = torch.from_numpy(np.clip(np.round(rgb * 255.0), 0, 255)
                                      .astype(np.uint8)).to(dev)
                self._frame_cache[sample["idx"]] = gt
        else:
            gt = torch.from_numpy(rgb).to(dev)
        return Frame(
            expression=torch.as_tensor(sample["expression"], dtype=torch.float32, device=dev),
            flame_pose=torch.as_tensor(sample["flame_pose"], dtype=torch.float32, device=dev),
            camera=camera, rgb=gt, bg_color=self.bg_color)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def train(self, max_epochs: int):
        for _ in range(self.epoch + 1, max_epochs + 1):
            self.epoch += 1
            self.train_epoch()
            self.save_checkpoint()

    def train_epoch(self):
        ds = self.train_dataset
        meters = {"loss": metrics_mod.LossMeter(), "psnr": metrics_mod.Meter("PSNR")}
        pending: list = []
        ovf_total = 0
        self.epoch_losses: list = []

        def flush():
            # one device->host copy for up to FLUSH_EVERY steps
            nonlocal ovf_total
            if not pending:
                return
            rows = torch.stack([torch.stack([a["loss"], a["psnr"],
                                             a["overflow"].to(torch.float32)])
                                for a in pending]).cpu().numpy()
            for loss, p, ovf in rows:
                meters["loss"].update(loss)
                meters["psnr"].update(p)
                self.epoch_losses.append(float(loss))
                if ovf > 0:
                    ovf_total += int(ovf)
                    self.log(f"[WARN] {int(ovf)} tile instances dropped by the "
                             "binning caps")
            pending.clear()

        t0 = time.perf_counter()
        for sample in Prefetcher(ds, np.arange(len(ds))):
            frame = self._make_frame(sample)
            self.ts, aux = self.train_step(self.ts, frame)
            self.global_step += 1
            pending.append(aux)
            if len(pending) >= FLUSH_EVERY:
                flush()
        flush()
        dt = time.perf_counter() - t0
        n = len(ds)
        alive = int(torch.sum(self.ts.state.alive))
        self.last_epoch_stats = {
            "epoch": self.epoch, "mode": "per-step", "its": n / max(dt, 1e-9),
            "loss": meters["loss"].measure(), "psnr": meters["psnr"].measure(),
            "overflow": ovf_total, "alive": alive,
        }
        self.log(f"[epoch {self.epoch}] {n} frames in {dt:.1f}s "
                 f"({n / max(dt, 1e-9):.2f} it/s) | loss={meters['loss'].measure():.5f} "
                 f"PSNR={meters['psnr'].measure():.2f} alive={alive}")

    # ------------------------------------------------------------------
    # evaluation (train/trainer.py:271-381)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, mode: str = "test"):
        """PSNR, SSIM, L1 and L2 over the test (or train) set, computed on
        the device and fetched once; per-frame values go to
        ``<workspace>/media/metrics/<mode>_epoch<n>.json``."""
        ds = self.test_dataset if mode == "test" else self.train_dataset
        if ds is None:
            raise ValueError("no test dataset")
        names, rows = [], []
        for i in range(len(ds)):
            sample = ds.sample(i)
            frame = self._make_frame(sample, cache=ds is self.train_dataset)
            img = fateavatar_forward(
                self.model, self.ts.params, self.ts.state, frame.expression,
                frame.flame_pose, frame.camera, bg_color=self.bg_color,
                render_cfg=self.render_cfg)["rgb_image"]
            rows.append(metrics_mod.image_metrics(img, as_float_rgb(frame.rgb)))
            names.append(sample["img_name"])
        meters = metrics_mod.default_meters()
        per_frame = []
        for name, vals in zip(names, torch.stack(rows).cpu().numpy()):
            row = {"frame": name}
            for k, v in zip(metrics_mod.IMAGE_METRICS, vals):
                meters[k].update(v)
                row[k] = float(v)
            per_frame.append(row)
        summary = {k: m.measure() for k, m in meters.items()}
        self.log(f"[eval {mode}] " + " ".join(f"{k}={v:.4f}" for k, v in summary.items()))
        if self.workspace is not None:
            path = os.path.join(self.workspace, "media", "metrics",
                                f"{mode}_epoch{self.epoch}.json")
            with open(path, "w") as f:
                json.dump({"summary": summary, "per_frame": per_frame}, f, indent=2)
        return summary

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def checkpoint_tree(self) -> dict:
        ts = self.ts
        return {
            "params": _fields(ts.params),
            "state": _fields(ts.state),
            "opt_state": {"mu": _fields(ts.opt_state.mu), "nu": _fields(ts.opt_state.nu),
                          "count": ts.opt_state.count},
            "step": ts.step,
            "generator": ts.generator.get_state(),
            "epoch": self.epoch,
            "global_step": self.global_step,
        }

    def save_checkpoint(self):
        if self.ckpt is None:
            return
        self.ckpt.save(self.global_step, self.checkpoint_tree())
        self.log(f"[ckpt] saved step {self.global_step}")

    def load_checkpoint(self, step: Optional[int] = None):
        tree = self.ckpt.restore(step, map_location=self.device)
        ts = self.ts
        # replace() rejects a field the containers do not have
        gen = torch.Generator(device=self.device)
        gen.set_state(tree["generator"].cpu())
        self.ts = TrainState(
            params=dataclasses.replace(ts.params, **tree["params"]),
            state=dataclasses.replace(ts.state, **tree["state"]),
            opt_state=MultiAdamState(
                mu=dataclasses.replace(ts.opt_state.mu, **tree["opt_state"]["mu"]),
                nu=dataclasses.replace(ts.opt_state.nu, **tree["opt_state"]["nu"]),
                count=tree["opt_state"]["count"]),
            step=int(tree["step"]),
            generator=gen,
        )
        self.epoch = int(tree["epoch"])
        self.global_step = int(tree["global_step"])
        self.log(f"[ckpt] restored step {self.global_step}")
