"""Trainer: host-side orchestration of the training step.

Port of ``fateavatar_tpu/train/trainer.py`` (train/base.py:14-245 +
train/trainer.py:61-632 of the reference): startup autosizing of the
binning capacities, epochs of one step per frame, per-frame tracking
refinement for datasets that ask for it (IMAvatar), meters, evaluation with
its metrics file, video and image, media snapshots, checkpoints and resume,
and the fps test.

Two stepping modes, as in the JAX package. Per-step: one eager step per
frame over a prefetched dataset; host <-> device traffic per step is one
frame's metadata (the ground truth is cached on the device as uint8 after
its first upload) and the loss values are fetched in batches of 50 steps.
Scan epoch: once every frame is on the device, the JAX package runs an
epoch as one compiled ``lax.scan``; here one step (with tracking: and its
row refinement) is captured as a CUDA graph (``utils/graphs.py``) and
replayed once per frame, the steps that densify, prune or reset opacity run
eagerly between replays, and the per-step scalars come back in one fetch.
The faster mode is kept once both have been measured.

Family adapters (``train/adapters.py``): with ``adapter=``, any registry
family trains through this Trainer. Its step, forward, snapshot and epoch
hook come from the adapter; evaluation, tracking, the fps test and
snapshots run through its forward, and checkpoints hold its train state.
Without tracking, its epochs become scan epochs as FateAvatar's do (the JAX
package scans a step that has ``.raw``): the family's step with
``maintain=False`` is captured, and the steps its ``step.due`` names
(densify, opacity reset, walk) run eagerly between the replays. With
tracking, or a step whose ``due`` is None, its epochs run per step, as in
the JAX package. The
binning capacities are not autosized for a family, as in the JAX package.

Data parallel (``data_parallel=N`` > 1, train/trainer.py:202-236 and
:715-790 of the JAX package): every rank of an N-process group builds its
own Trainer on its own device (``parallel/data_parallel.py``). Each step
takes B = N frames, one a rank, from the same frame order (wrapped to fill
the last batch), so ``global_step`` grows by B a step; the step is
``make_dp_train_step`` (or, with an adapter, its step with ``mesh=``), and
with tracking every rank refines the B frames' rows in one update, the
padded tail's repeats masked. DP epochs run per step and eagerly, as in the
JAX package. Only rank 0 writes logs, snapshots, checkpoints, videos and
metrics; a checkpoint written under DP resumes in a single-process Trainer
and the other way round. ``data_parallel`` 0 or 1 trains on one device.

Tracing (``utils/profiling.py``): the counters ``trainer.steps_replayed``,
``trainer.steps_eager_maintenance`` and ``trainer.steps_eager_per_step``
count every step by how it ran, each added once an epoch (0 included), so
their histories line up epoch by epoch.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from fateavatar_tpu_torch.models.fateavatar import (
    FateAvatarModel,
    fateavatar_forward,
    fateavatar_visualization,
)
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.render.autosize import autosize_render_config
from fateavatar_tpu_torch.render.mesh_render import overlay_mesh
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train import metrics as metrics_mod
from fateavatar_tpu_torch.train.checkpoints import CheckpointManager
from fateavatar_tpu_torch.train.datasets import FaceDataset, Prefetcher
from fateavatar_tpu_torch.train.losses import as_float_rgb
from fateavatar_tpu_torch.train.optim import MultiAdam, MultiAdamState, params_device
from fateavatar_tpu_torch.train.step import (
    EPOCH_AUX,
    Frame,
    MaintenanceConfig,
    TrainState,
    clone_train_state,
    copy_train_state_,
    init_train_state,
    make_inplace_step,
    make_train_step,
    train_state_tensors,
)
from fateavatar_tpu_torch.train.tracking import (
    RowAdam,
    RowAdamState,
    TrackingTables,
    clone_tracking,
    make_batched_tracking_step,
    make_tracking_step,
    row_gradients,
    tables_from_dataset,
    tracking_tensors,
)
from fateavatar_tpu_torch.utils import profiling
from fateavatar_tpu_torch.utils.graphs import Graph
from fateavatar_tpu_torch.utils.logging import Logger, save_image, save_image_grid, write_video

FLUSH_EVERY = 50   # steps between fetches of the device-side loss values


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _count_steps(replayed: int = 0, maintenance: int = 0, per_step: int = 0) -> None:
    """An epoch's steps by how they ran, one add to each counter."""
    profiling.count("trainer.steps_replayed", replayed)
    profiling.count("trainer.steps_eager_maintenance", maintenance)
    profiling.count("trainer.steps_eager_per_step", per_step)


@dataclasses.dataclass
class _ScanEpoch:
    """A built scan epoch: ``body(step=None)`` is one step on the static
    buffers below (with tracking: then its frame's row refinement) and
    ``graph`` its capture. The Trainer's state moves into the buffers at the
    start of a scan epoch and stays there after it."""

    graph: Graph
    body: Callable
    ts: TrainState
    aux: dict                  # EPOCH_AUX name -> [n]
    cursor: torch.Tensor       # [1] int64: the frame the next step reads
    tables: Optional[TrackingTables] = None
    track_state: Optional[RowAdamState] = None

    @property
    def tracking(self) -> bool:
        return self.tables is not None


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
        tracking_lr: float = 5e-4,
        bg_color=(1.0, 1.0, 1.0),
        snapshot_interval: int = 1000,
        max_keep_ckpt: int = 2,
        seed: int = 0,
        adapter=None,
        data_parallel: int = 0,
        device_frame_cache: str = "auto",
        lpips_weights_path=None,
        scan_unroll: int = 1,
    ):
        if device_frame_cache not in ("on", "off", "auto"):
            raise ValueError(f"device_frame_cache {device_frame_cache!r}: on, off or auto")
        self.name = name
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset
        self.workspace = workspace
        self.device = params_device(params)
        # data parallel over N ranks (train/trainer.py:202-236); 0 or 1 is
        # the single-device path, as in the JAX package
        self.dp_mesh = None
        if data_parallel and data_parallel > 1:
            from fateavatar_tpu_torch.parallel.data_parallel import make_device_mesh

            self.dp_mesh = make_device_mesh(data_parallel, device=self.device.type)
            if self.dp_mesh.device != self.device:
                raise ValueError(f"rank {self.dp_mesh.rank} trains on {self.dp_mesh.device}, "
                                 f"its params are on {self.device}")
        main = self.dp_mesh is None or self.dp_mesh.is_main
        # only rank 0 writes files
        self._files = workspace is not None and main
        # the LPIPS network's weights, loaded once for every evaluation (an
        # unavailable meter, without weights, is dropped from them)
        self._lpips = metrics_mod.LPIPSMeter(weights_path=lpips_weights_path,
                                             device=self.device)
        self.bg_color = torch.as_tensor(bg_color, dtype=torch.float32, device=self.device)
        self.snapshot_interval = snapshot_interval
        # the JAX trainer's scan-epoch unroll; a CUDA graph replays one step
        # per frame whatever it is, so it is only recorded here
        self.scan_unroll = max(1, int(scan_unroll))
        self.epoch = 0
        self.global_step = 0
        self.logger = Logger(name, workspace if main else None, quiet=not main)

        # media dirs (train/trainer.py:107-134)
        self.media_dirs = {}
        if workspace is not None:
            for sub in ("snapshots", "eval_images", "eval_videos", "metrics"):
                d = os.path.join(workspace, "media", sub)
                if main:
                    os.makedirs(d, exist_ok=True)
                self.media_dirs[sub] = d
            self.ckpt = CheckpointManager(os.path.join(workspace, "checkpoints"),
                                          max_keep=max_keep_ckpt)
        else:
            self.ckpt = None

        # ground truth cached on the device as uint8 (4x smaller) after its
        # first upload, converted inside the loss (losses.as_float_rgb);
        # "auto" caches when the whole dataset fits 4 GiB
        h, w = model.cfg.img_height, model.cfg.img_width
        est_bytes = len(train_dataset) * h * w * 3
        self._frame_cache: Optional[dict] = None
        if device_frame_cache == "on" or (device_frame_cache == "auto"
                                          and est_bytes <= 4 << 30):
            self._frame_cache = {}
        elif device_frame_cache == "auto":
            self.log(f"[cache] dataset ~{est_bytes >> 20} MiB exceeds the 4 GiB "
                     "device-frame budget; streaming uploads per step")

        # the JAX package autosizes the built-in FateAvatar path only
        self.autosized = render_cfg.autosize and adapter is None
        if self.autosized:
            # measure the dataset's tile occupancy on its first frames and
            # size instance_budget / R / tail_k from it (render/autosize.py)
            render_cfg = autosize_render_config(
                model, params, state, self._probe_frames(),
                dataclasses.replace(render_cfg, autosize=False), log_fn=self.log)
        self.render_cfg = render_cfg
        self.maint_cfg = maint_cfg
        # family adapter (train/adapters.py): None -> the built-in FateAvatar
        # wiring (train/trainer.py:147-174)
        self.adapter = adapter
        if adapter is None:
            self.train_step = make_train_step(model, loss_fn, optimizer, maint_cfg,
                                              render_cfg)
            self.ts: TrainState = init_train_state(params, state, optimizer, seed)
            self._visualize = self._fateavatar_visualization
        else:
            self.train_step = adapter.step
            self.ts = adapter.init_ts(seed)
            self._visualize = adapter.visualize
            if getattr(adapter.step, "due", None) is None:
                self.log(f"[{adapter.name}] epochs run per step: the step reads the host "
                         "step count (no maintain=False form to capture)")
        self.last_epoch_stats: Optional[dict] = None

        # tracking refinement (train/base.py:113-151)
        self.tracking_enabled = getattr(train_dataset, "optimize_tracking", False)
        self.train_tables: Optional[TrackingTables] = None
        if self.tracking_enabled:
            self.track_opt = RowAdam(lr=tracking_lr)
            self.train_tables = tables_from_dataset(train_dataset, self.device)
            self.train_track_state = self.track_opt.init(self.train_tables)
            if test_dataset is not None:
                self.test_tables = tables_from_dataset(test_dataset, self.device)
                self.test_track_state = self.track_opt.init(self.test_tables)
            self._tracking_step = self._build_tracking_step()
            self._batched_tracking_step = self._build_tracking_step(batched=True)

        if self.dp_mesh is not None:
            self._setup_dp(model, loss_fn, optimizer, maint_cfg, render_cfg)

        # the scan-epoch mode (train/trainer.py:359-419, 466-541, 551-577)
        self.last_epoch_aux: Optional[dict] = None
        self._scan_frames: Optional[dict] = None
        self._scan_epoch: Optional[_ScanEpoch] = None
        self._scan_disabled = False
        self._scan_checked = False
        self._per_step_its: Optional[float] = None
        self._scan_its: Optional[float] = None

    def log(self, msg: str):
        self.logger.log(msg)

    def _setup_dp(self, model, loss_fn, optimizer, maint_cfg, render_cfg):
        """The data-parallel step and the replicas' start (rank 0's state
        and tables copied to every rank)."""
        from fateavatar_tpu_torch.parallel.data_parallel import make_dp_train_step, replicate

        mesh = self.dp_mesh
        if self.adapter is None:
            self.dp_step = make_dp_train_step(model, loss_fn, optimizer, mesh, maint_cfg,
                                              render_cfg)
        else:
            # the families' steps take the mesh themselves (baseline_steps)
            self.dp_step = functools.partial(self.adapter.step, mesh=mesh)
        replicate(self.ts, mesh)
        if self.tracking_enabled:
            replicate((self.train_tables, self.train_track_state), mesh)
            self._dp_tracking_step = self._build_tracking_step(batched=True,
                                                               gather=mesh.all_gather)
        self.log(f"[dp] training over {mesh.size} ranks ({mesh.backend}, {self.device})"
                 + (" with tracking refinement" if self.tracking_enabled else "")
                 + (f" [{self.adapter.name}]" if self.adapter is not None else ""))

    def _forward(self, params, state, expr, pose, camera, world_transform=None) -> dict:
        """The model's forward on the Trainer's background and render
        settings: the adapter's, or ``fateavatar_forward`` (with the frame's
        model-to-world transform, where it has one)."""
        if self.adapter is not None:
            return self.adapter.forward(params, state, expr, pose, camera, self.bg_color)
        return fateavatar_forward(self.model, params, state, expr, pose, camera,
                                  bg_color=self.bg_color, render_cfg=self.render_cfg,
                                  world_transform=world_transform)

    def _fateavatar_visualization(self, params, state, expr, pose, camera) -> dict:
        return fateavatar_visualization(self.model, params, state, expr, pose, camera,
                                        render_cfg=self.render_cfg)

    def _alive(self) -> Optional[int]:
        """Alive splats of the model state (None for a family without an
        alive mask)."""
        alive = getattr(self.ts.state, "alive", None)
        return None if alive is None else int(torch.sum(alive))

    # ------------------------------------------------------------------
    # frames
    # ------------------------------------------------------------------

    def _make_frame(self, sample: dict, tables: Optional[TrackingTables] = None,
                    cache: bool = True) -> Frame:
        """A dataset sample as a Frame on the device. With ``tables``, the
        frame's expression, pose and camera translation are its tracked rows
        (the camera is then built from the row, so it stays differentiable).
        A sample's ``intrinsics_K`` gives the principal-point-shift camera and
        its ``world_transform`` the frame's (the NeRSemble benchmark).
        ``cache`` keys the uint8 ground truth by TRAIN-set index; samples of
        another dataset (evaluation on the test set) pass cache=False."""
        dev = self.device
        h, w = self.model.cfg.img_height, self.model.cfg.img_width
        idx = sample["idx"]
        cam_pose = np.asarray(sample["cam_pose"], np.float32)
        if tables is not None:
            expr, pose, cam_t = (tables.expression[idx], tables.flame_pose[idx],
                                 tables.cam_t[idx])
        else:
            expr = torch.as_tensor(sample["expression"], dtype=torch.float32, device=dev)
            pose = torch.as_tensor(sample["flame_pose"], dtype=torch.float32, device=dev)
            cam_t = cam_pose[:3, 3]
        camera = make_camera(cam_pose[:3, :3].T, cam_t, sample["fovx"], sample["fovy"],
                             w, h, intrinsics=sample.get("intrinsics_K"), device=dev)
        wt = sample.get("world_transform")
        if wt is not None:
            wt = torch.as_tensor(wt, dtype=torch.float32, device=dev)
        rgb = np.asarray(sample["ground_truth"]["rgb"], np.float32)
        if cache and self._frame_cache is not None:
            gt = self._frame_cache.get(idx)
            if gt is None:
                gt = torch.from_numpy(np.clip(np.round(rgb * 255.0), 0, 255)
                                      .astype(np.uint8)).to(dev)
                self._frame_cache[idx] = gt
        else:
            gt = torch.from_numpy(rgb).to(dev)
        return Frame(expression=expr, flame_pose=pose, camera=camera, rgb=gt,
                     bg_color=self.bg_color, world_transform=wt)

    @staticmethod
    def _rgb_f32(rgb: torch.Tensor) -> np.ndarray:
        """Host float view of a frame's ground truth (undoes the device
        cache's uint8 encoding)."""
        arr = rgb.cpu().numpy()
        if arr.dtype == np.uint8:
            return arr.astype(np.float32) / 255.0
        return arr

    def _tracking_loss(self, expr, pose, cam_t, const):
        """The frame's full training loss as a function of its tracked rows;
        ``const`` = (R, fovx, fovy, gt rgb, model state, model params[, K,
        world transform]): the last two, the frame's intrinsics and
        model-to-world transform, may be left out or None."""
        R, fovx, fovy, rgb, mstate, params, K, wt = (*const, None, None)[:8]
        cfg = self.model.cfg
        camera = make_camera(R, cam_t, fovx, fovy, cfg.img_width, cfg.img_height,
                             intrinsics=K, device=self.device)
        out = self._forward(params, mstate, expr, pose, camera, wt)
        profiling.mark("loss", self.device)
        return self.loss_fn(out, {"rgb": rgb})["loss"]

    def _build_tracking_step(self, batched: bool = False, gather=None):
        if batched:
            def loss_of_frame_b(expr, pose, cam_t, frame_const, shared):
                # frame_const = (R, fovx, fovy, gt rgb[, K, world transform])
                params, mstate = shared
                return self._tracking_loss(
                    expr, pose, cam_t, (*frame_const[:4], mstate, params, *frame_const[4:]))

            return make_batched_tracking_step(loss_of_frame_b, self.track_opt, gather)
        return make_tracking_step(self._tracking_loss, self.track_opt)

    def set_render_cfg(self, render_cfg: RenderConfig):
        """Swap the binning capacities mid-run (train/trainer.py:421-465):
        the train step is rebuilt on the new settings (and on the current
        ``maint_cfg``), and the scan epoch's graph, which closes over the old
        ones, is dropped; its stacked frames stay, and the next scan epoch
        captures anew. The tracking steps need no rebuild: their loss reads
        ``self.render_cfg`` at each call, where the JAX package's jitted
        steps close over the old value. A family adapter's step closes over
        its render settings: this raises for one, as the JAX package does."""
        if self.adapter is not None or self.dp_mesh is not None:
            raise NotImplementedError(
                "set_render_cfg supports the built-in single-device FateAvatar path only")
        self.render_cfg = render_cfg
        self.train_step = make_train_step(self.model, self.loss_fn, self.optimizer,
                                          self.maint_cfg, render_cfg)
        # the next scan epoch pays a capture again: it is not measured
        self._scan_epoch = None
        self._scan_checked = False

    def _probe_frames(self) -> list:
        """The views autosize probes: the first 4 training frames."""
        return [self._make_frame(self.train_dataset.sample(i), cache=False)
                for i in range(min(4, len(self.train_dataset)))]

    def regrow_caps(self, frames: Optional[list] = None):
        """Probe the autosized binning capacities again on the current
        splats over ``frames`` (default: the probe views of construction)
        and grow each one that falls short; none shrinks. The probe at
        construction saw the avatar before a checkpoint was restored or
        splats were re-seeded. Nothing to do unless the capacities were
        autosized."""
        if not self.autosized:
            return
        frames = self._probe_frames() if frames is None else frames
        cfg = self.render_cfg
        new = autosize_render_config(self.model, self.ts.params, self.ts.state, frames, cfg,
                                     probe_views=len(frames), log_fn=self.log)
        grown = {k: max(getattr(cfg, k), getattr(new, k))
                 for k in ("instance_budget", "max_tiles_per_gaussian", "tail_k")}
        if any(v != getattr(cfg, k) for k, v in grown.items()):
            self.set_render_cfg(dataclasses.replace(cfg, **grown))

    def _sync(self):
        """Wait for the work queued on the device (nothing to wait for on
        the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def train(self, max_epochs: int):
        for _ in range(self.epoch + 1, max_epochs + 1):
            self.epoch += 1
            self.train_epoch()
            if self.adapter is not None and self.adapter.epoch_hook is not None:
                self.adapter.epoch_hook(self, self.epoch)
            self.save_checkpoint()

    def train_epoch(self):
        """One epoch in scan mode where it is built and not switched off,
        else per step (train/trainer.py:551-663). The first scan epoch pays
        the capture; from the second on, scan mode is kept only while it
        runs at least 0.9x the per-step mode's steady rate, as the JAX
        package decides."""
        # only the scan epoch fills this: no stale values after a switch
        self.last_epoch_aux = None
        if self.dp_mesh is not None:
            return self._train_epoch_dp()
        scan = None if self._scan_disabled else self._maybe_scan_epoch()
        if scan is not None:
            self._train_epoch_scan(scan)
            per_step, scan_its = self._per_step_its, self._scan_its
            if per_step and scan_its and scan_its < 0.9 * per_step:
                self._scan_disabled = True
                self.log(f"[scan] per-step mode is faster on this device ({per_step:.1f} "
                         f"vs {scan_its:.1f} it/s): switching back to per-step epochs")
            self._scan_checked = True
            return
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
        steps_done, t_steady = 0, None
        for sample in Prefetcher(ds, np.arange(len(ds))):
            frame = self._make_frame(sample, self.train_tables)
            self.ts, aux = self.train_step(self.ts, frame)
            self.global_step += 1
            steps_done += 1
            if steps_done == 3:
                # the steady rate's start: the first steps pay one-time
                # uploads and the kernels' first calls
                self._sync()
                t_steady = time.perf_counter()
            pending.append(aux)
            # tracking refinement on the SAME frame with the updated model
            # (train/trainer.py:173-176)
            if self.tracking_enabled:
                cam_pose = np.asarray(sample["cam_pose"], np.float32)
                const = (cam_pose[:3, :3].T, sample["fovx"], sample["fovy"], frame.rgb,
                         self.ts.state, self.ts.params, sample.get("intrinsics_K"),
                         frame.world_transform)
                self.train_tables, self.train_track_state = self._tracking_step(
                    self.train_tables, self.train_track_state, sample["idx"], const)
            if len(pending) >= FLUSH_EVERY:
                flush()
            if self._files and self.global_step % self.snapshot_interval == 0:
                self.save_snapshot(sample)
        flush()
        dt = time.perf_counter() - t0
        n = len(ds)
        _count_steps(per_step=n)
        if t_steady is not None and n > 3:
            self._per_step_its = (n - 3) / max(time.perf_counter() - t_steady, 1e-9)
        alive = self._alive()
        self.last_epoch_stats = {
            "epoch": self.epoch, "mode": "per-step", "its": n / max(dt, 1e-9),
            "loss": meters["loss"].measure(), "psnr": meters["psnr"].measure(),
            "overflow": ovf_total, "alive": alive,
        }
        self.log(f"[epoch {self.epoch}] {n} frames in {dt:.1f}s "
                 f"({n / max(dt, 1e-9):.2f} it/s) | loss={meters['loss'].measure():.5f} "
                 f"PSNR={meters['psnr'].measure():.2f} alive={alive}")

    def _train_epoch_dp(self):
        """One data-parallel epoch (train/trainer.py:715-790): every rank
        walks the same frame order, wrapped to fill the last batch of B, and
        steps on its own frame of each batch; ``global_step`` grows by B a
        step. With tracking, each rank takes its frame's row gradients under
        the updated model and every rank applies the same update of the B
        rows, the wrapped tail's repeats masked (each row is updated once
        an epoch)."""
        mesh = self.dp_mesh
        ds = self.train_dataset
        B, rank = mesh.size, mesh.rank
        order = np.arange(len(ds))
        pad = (-len(order)) % B
        if pad:
            order = np.concatenate([order, order[:pad]])
        # a frame seen earlier in the epoch (the wrapped tail) takes no
        # second tracking update
        first = np.zeros(len(order), bool)
        first[np.unique(order, return_index=True)[1]] = True
        meters = {"loss": metrics_mod.LossMeter(), "psnr": metrics_mod.Meter("PSNR")}
        pending: list = []
        ovf_total = 0
        self.epoch_losses = []

        def flush():
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
                ovf_total += int(ovf)
            pending.clear()

        t0 = time.perf_counter()
        mine = order[rank::B]
        for i, sample in enumerate(Prefetcher(ds, mine)):
            frame = self._make_frame(sample, self.train_tables)
            self.ts, aux = self.dp_step(self.ts, frame)
            self.global_step += B
            pending.append(aux)
            if self.tracking_enabled:
                cam_pose = np.asarray(sample["cam_pose"], np.float32)
                const = (cam_pose[:3, :3].T, sample["fovx"], sample["fovy"], frame.rgb,
                         sample.get("intrinsics_K"), frame.world_transform)
                idx = torch.as_tensor([sample["idx"]], dtype=torch.int64, device=self.device)
                live = torch.as_tensor([bool(first[i * B + rank])], device=self.device)
                self.train_tables, self.train_track_state = self._dp_tracking_step(
                    self.train_tables, self.train_track_state, idx, live, [const],
                    (self.ts.params, self.ts.state))
            if len(pending) >= FLUSH_EVERY:
                flush()
            if self._files and self.global_step % self.snapshot_interval < B:
                self.save_snapshot(sample)
        _count_steps(per_step=len(mine))
        flush()
        if ovf_total > 0:
            self.log(f"[WARN] {ovf_total} tile instances dropped by the binning caps in "
                     "the epoch")
        dt = time.perf_counter() - t0
        n = len(order)
        alive = self._alive()
        self.last_epoch_stats = {
            "epoch": self.epoch, "mode": f"dp={B}", "its": n / max(dt, 1e-9),
            "loss": meters["loss"].measure(), "psnr": meters["psnr"].measure(),
            "overflow": ovf_total, "alive": alive,
        }
        self.log(f"[epoch {self.epoch}] {n} frames in {dt:.1f}s "
                 f"({n / max(dt, 1e-9):.2f} it/s, dp={B}) | "
                 f"loss={meters['loss'].measure():.5f} alive={alive}")

    # ------------------------------------------------------------------
    # the scan epoch (train/trainer.py:359-419, 466-541, 665-713)
    # ------------------------------------------------------------------

    def _due(self) -> Optional[Callable[[int], bool]]:
        """Whether the step that brings the count to n runs maintenance:
        ``MaintenanceConfig.due`` on the built-in path, the adapter step's
        own ``due`` (None: it has no maintain=False form) with an adapter."""
        if self.adapter is None:
            return self.maint_cfg.due
        return getattr(self.adapter.step, "due", None)

    def _maybe_scan_epoch(self) -> Optional[_ScanEpoch]:
        """Build (once) the scan epoch: an epoch of one captured step (with
        tracking: and its row refinement) replayed over device-resident
        frames, the counterpart of the JAX package's one ``lax.scan`` program
        per epoch. Eligible once the device frame cache holds every training
        frame, without data parallel, on the built-in FateAvatar path or
        with a family adapter whose step has a ``due``, without tracking
        (train/trainer.py:359-397 of the JAX package). The frames are
        stacked on the device once and the cache cleared, so one copy of the
        dataset is held. Returns None while not eligible."""
        if self.dp_mesh is not None:
            return None
        if self.adapter is not None and (self._due() is None or self.tracking_enabled):
            return None
        scan = self._scan_epoch
        if scan is not None and scan.tracking == self.tracking_enabled:
            return scan
        n = len(self.train_dataset)
        if self._scan_frames is None:
            if self._frame_cache is None or len(self._frame_cache) < n:
                return None
            self._scan_frames = self._stack_frames(n)
            # evaluation on the train set and snapshots re-upload the frames
            # they touch
            self._frame_cache.clear()
            what = "step and its row refinement" if self.tracking_enabled else "step"
            how = ("one CUDA graph" if self.device.type == "cuda"
                   else "one function (the CPU's plain version of the graph)")
            self.log(f"[scan] epoch as {how} of one {what}, replayed over {n} "
                     "device-resident frames")
        self._scan_epoch = (self._build_scan_epoch_tracking() if self.tracking_enabled
                            else self._build_scan_epoch_fn())
        # the next scan epoch pays the capture: it is not measured
        self._scan_checked = False
        return self._scan_epoch

    def _stack_frames(self, n: int) -> dict:
        """The training frames stacked on the device in epoch order: the
        cached uint8 ground truth ``rgb`` [n, H, W, 3], ``expression``,
        ``flame_pose``, the camera's ``R`` and ``T``, ``fovx``, ``fovy``, the
        frame index ``idx``, and where the samples carry them
        ``intrinsics_K`` [n, 3, 3] and ``world_transform`` [n, 7]."""
        first = self.train_dataset.sample(0)
        extra = [k for k in ("intrinsics_K", "world_transform") if k in first]
        cols = {k: [] for k in ("expression", "flame_pose", "R", "T", "fovx", "fovy",
                                *extra)}
        idxs, rgb = [], []
        for i in range(n):
            s = self.train_dataset.sample(i)
            cam_pose = np.asarray(s["cam_pose"], np.float32)
            for k, v in (("expression", s["expression"]), ("flame_pose", s["flame_pose"]),
                         ("R", cam_pose[:3, :3].T), ("T", cam_pose[:3, 3]),
                         ("fovx", s["fovx"]), ("fovy", s["fovy"]),
                         *((k, s[k]) for k in extra)):
                cols[k].append(np.asarray(v, np.float32))
            idxs.append(s["idx"])
            rgb.append(self._frame_cache[s["idx"]])
        xs = {k: torch.from_numpy(np.stack(v)).to(self.device) for k, v in cols.items()}
        xs["idx"] = torch.as_tensor(idxs, dtype=torch.int64).to(self.device)
        xs["rgb"] = torch.stack(rgb)
        return xs

    def _frame_at(self, xs: dict, i: torch.Tensor,
                  tables: Optional[TrackingTables] = None) -> Frame:
        """The Frame at device index ``i`` ([1] int64) of the stacked frames
        ``xs``, built on the device; with ``tables``, its expression, pose
        and camera translation are the frame's tracked rows, as in
        :meth:`_make_frame`."""
        def at(x, j=i):
            return x.index_select(0, j)[0]

        if tables is None:
            expr, pose, cam_t = at(xs["expression"]), at(xs["flame_pose"]), at(xs["T"])
        else:
            idx = xs["idx"].index_select(0, i)
            expr, pose, cam_t = (at(t, idx) for t in
                                 (tables.expression, tables.flame_pose, tables.cam_t))
        cfg = self.model.cfg
        K = at(xs["intrinsics_K"]) if "intrinsics_K" in xs else None
        wt = at(xs["world_transform"]) if "world_transform" in xs else None
        camera = make_camera(at(xs["R"]), cam_t, at(xs["fovx"]), at(xs["fovy"]),
                             cfg.img_width, cfg.img_height, intrinsics=K, device=self.device)
        return Frame(expression=expr, flame_pose=pose, camera=camera, rgb=at(xs["rgb"]),
                     bg_color=self.bg_color, world_transform=wt)

    def _scan_buffers(self):
        """The static TrainState (a copy of ``self.ts``), the per-step aux
        buffers and the cursor of a scan epoch over the stacked frames."""
        n = self._scan_frames["idx"].shape[0]
        aux = {k: torch.zeros((n,), dtype=dt, device=self.device) for k, dt in EPOCH_AUX.items()}
        return (clone_train_state(self.ts), aux,
                torch.zeros((1,), dtype=torch.int64, device=self.device))

    def _build_scan_epoch_fn(self) -> _ScanEpoch:
        """One graph of one plain step (train/trainer.py:399-419): FateAvatar's,
        or the adapter's; the camera is built inside it from the stacked
        frames."""
        xs = self._scan_frames
        ts, aux, cursor = self._scan_buffers()
        step = (self.adapter.step if self.adapter is not None else
                make_train_step(self.model, self.loss_fn, self.optimizer, self.maint_cfg,
                                self.render_cfg))
        body = make_inplace_step(step, ts, lambda i: self._frame_at(xs, i), aux, cursor)
        graph = Graph(body, [*train_state_tensors(ts), *aux.values(), cursor],
                      "the scan epoch's step")
        return _ScanEpoch(graph=graph, body=body, ts=ts, aux=aux, cursor=cursor)

    def _build_scan_epoch_tracking(self) -> _ScanEpoch:
        """One graph of the main step and then its frame's row refinement
        (train/trainer.py:466-541). Each frame is visited once per epoch, so
        carrying the tables through the replays reproduces the per-step
        loop: the step reads the rows ``tables.*[idx[cursor]]`` (its camera
        from ``tables.cam_t``), then the rows' gradients of the frame's loss
        under the updated model (``torch.autograd.grad`` with the rows as
        its only inputs) and ``RowAdam.update_row`` at the device index."""
        xs = self._scan_frames
        ts, aux, cursor = self._scan_buffers()
        tables, tstate = clone_tracking(self.train_tables, self.train_track_state)
        step = make_inplace_step(
            make_train_step(self.model, self.loss_fn, self.optimizer, self.maint_cfg,
                            self.render_cfg),
            ts, lambda i: self._frame_at(xs, i, tables), aux, cursor)

        def body(host_step: Optional[int] = None):
            i = cursor.clone()             # the step advances the cursor
            frame = step(host_step)
            idx = xs["idx"].index_select(0, i)
            rows = [t.index_select(0, idx)[0]
                    for t in (tables.expression, tables.flame_pose, tables.cam_t)]
            K = xs["intrinsics_K"].index_select(0, i)[0] if "intrinsics_K" in xs else None
            const = (*(xs[k].index_select(0, i)[0] for k in ("R", "fovx", "fovy")),
                     frame.rgb, ts.state, ts.params, K, frame.world_transform)
            g = row_gradients(self._tracking_loss, *rows, const)
            new_tables, new_state = self.track_opt.update_row(tables, tstate, g, idx)
            for d, src in zip(tracking_tensors(tables, tstate),
                              tracking_tensors(new_tables, new_state)):
                d.copy_(src)

        graph = Graph(body, [*train_state_tensors(ts), *aux.values(), cursor,
                             *tracking_tensors(tables, tstate)],
                      "the scan epoch's step and row refinement")
        return _ScanEpoch(graph=graph, body=body, ts=ts, aux=aux, cursor=cursor,
                          tables=tables, track_state=tstate)

    def _load_scan_state(self, scan: _ScanEpoch):
        """Move the Trainer's state (and its tracking tables) into the scan
        epoch's static buffers, a no-op for tensors that already are them,
        make them the Trainer's state, and rewind the cursor."""
        copy_train_state_(scan.ts, self.ts)
        scan.ts.step, scan.ts.generator = self.ts.step, self.ts.generator
        self.ts = scan.ts
        if scan.tracking:
            for d, src in zip(tracking_tensors(scan.tables, scan.track_state),
                              tracking_tensors(self.train_tables, self.train_track_state)):
                d.copy_(src)
            self.train_tables, self.train_track_state = scan.tables, scan.track_state
        scan.cursor.zero_()

    def _train_epoch_scan(self, scan: _ScanEpoch):
        """One epoch as replays of ``scan.graph``, one per frame; a step
        whose count hits a maintenance interval (``MaintenanceConfig.due``,
        or the adapter step's ``due``) runs ``scan.body`` eagerly on the same
        buffers instead (train/trainer.py:665-713). The per-step
        loss, PSNR and overflow come to the host in one fetch at the end, as
        ``last_epoch_aux``; snapshots are taken at epoch granularity."""
        ds = self.train_dataset
        n = len(ds)
        t0 = time.perf_counter()
        step_before = self.global_step
        self._load_scan_state(scan)
        first = self.ts.step
        due = self._due()
        eager = 0
        for j in range(n):
            if due(first + j + 1):
                scan.body(first + j)
                eager += 1
            else:
                scan.graph()
        _count_steps(replayed=n - eager, maintenance=eager)
        self.ts.step = first + n
        self.global_step += n
        # one fetch: float64 holds the float32 values and the counts exactly
        loss, psnr, ovf = torch.stack([scan.aux[k].to(torch.float64) for k in
                                       ("loss", "psnr", "overflow")]).cpu().numpy()
        aux = {"loss": loss.astype(np.float32), "psnr": psnr.astype(np.float32),
               "overflow": ovf.astype(np.int32)}
        # a snapshot after the epoch that crosses a multiple of the interval
        # (per-step mode takes it mid-epoch)
        if (self._files and step_before // self.snapshot_interval
                != self.global_step // self.snapshot_interval):
            self.save_snapshot(ds.sample(n - 1))
        dt = time.perf_counter() - t0
        # the first scan epoch pays the capture: only later ones are measured
        if self._scan_checked:
            self._scan_its = n / max(dt, 1e-9)
        overflow = int(np.sum(aux["overflow"]))
        if overflow > 0:
            self.log(f"[WARN] {overflow} tile instances dropped by the binning caps "
                     "in the epoch")
        self.last_epoch_aux = aux
        self.epoch_losses = [float(x) for x in aux["loss"]]
        alive = self._alive()
        mean_loss, mean_psnr = float(np.mean(loss)), float(np.mean(psnr))
        self.last_epoch_stats = {
            "epoch": self.epoch, "mode": "scan", "its": n / max(dt, 1e-9),
            "loss": mean_loss, "psnr": mean_psnr, "overflow": overflow, "alive": alive,
        }
        self.log(f"[epoch {self.epoch}] {n} frames in {dt:.1f}s "
                 f"({n / max(dt, 1e-9):.2f} it/s, scan) | loss={mean_loss:.5f} "
                 f"PSNR={mean_psnr:.2f} alive={alive}")

    def fps_performance_test(self, n: int = 100) -> float:
        """Forward-only render throughput (train/trainer.py:1053-1071 of the
        JAX package): training frame 0's forward captured once as a CUDA
        graph (on the CPU: the forward itself), then ``n`` replays, timed to
        the end of the last. Returns frames per second."""
        frame = self._make_frame(self.train_dataset.sample(0), None, cache=False)
        cfg = self.model.cfg
        img = torch.empty((cfg.img_height, cfg.img_width, 3), dtype=torch.float32,
                          device=self.device)

        def forward():
            with torch.no_grad():
                img.copy_(self._forward(self.ts.params, self.ts.state, frame.expression,
                                        frame.flame_pose, frame.camera,
                                        frame.world_transform)["rgb_image"])

        graph = Graph(forward, [img], "the fps forward")
        graph()                  # the capture, outside the timing
        self._sync()
        t0 = time.perf_counter()
        for _ in range(n):
            graph()
        self._sync()
        dt = time.perf_counter() - t0
        fps = n / max(dt, 1e-9)
        self.log(f"[fps] {fps:.1f} frames/s ({1000 * dt / n:.2f} ms/frame)")
        return fps

    # ------------------------------------------------------------------
    # evaluation (train/trainer.py:271-381)
    # ------------------------------------------------------------------

    def evaluate(self, mode: str = "test", optim_epoch: Optional[int] = None,
                 save_media: bool = True):
        """PSNR, SSIM, L1 and L2 (and LPIPS, given its weights) over the test
        (or train) set, computed on the device and fetched once. On a
        tracking dataset the test rows are fitted first
        (:meth:`optimize_tracking`, ``optim_epoch`` steps). With
        a workspace: per-frame values to ``media/metrics/<mode>_epoch<n>.json``
        (and a plot where matplotlib is installed), and with ``save_media``
        the prediction | ground truth frames as a video and frame 0 as a
        PNG."""
        ds = self.test_dataset if mode == "test" else self.train_dataset
        if ds is None:
            raise ValueError("no test dataset")
        if mode == "test" and self.tracking_enabled:
            self.optimize_tracking(optim_epoch or 50)

        meters = metrics_mod.default_meters()
        keys = list(metrics_mod.IMAGE_METRICS)
        if self._lpips.available:
            meters["lpips"] = metrics_mod.LPIPSMeter(params=self._lpips.params)
            keys.append("lpips")
        tables = None
        if self.tracking_enabled:
            tables = self.test_tables if mode == "test" else self.train_tables
        names, rows, frames_out = [], [], []
        with torch.no_grad():
            for i in range(len(ds)):
                sample = ds.sample(i)
                frame = self._make_frame(sample, tables, cache=ds is self.train_dataset)
                img = self._forward(self.ts.params, self.ts.state, frame.expression,
                                    frame.flame_pose, frame.camera,
                                    frame.world_transform)["rgb_image"]
                gt = as_float_rgb(frame.rgb)
                row = metrics_mod.image_metrics(img, gt)
                if "lpips" in meters:
                    row = torch.cat([row, meters["lpips"].distance(img, gt)[None]])
                rows.append(row)
                names.append(sample["img_name"])
                if save_media:
                    # the prediction comes to the host as uint8
                    img_u8 = torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8)
                    gt_u8 = (np.clip(self._rgb_f32(frame.rgb), 0, 1) * 255).astype(np.uint8)
                    frames_out.append((img_u8, gt_u8))
        per_frame = []
        for name, vals in zip(names, torch.stack(rows).cpu().numpy()):
            row = {"frame": name}
            for k, v in zip(keys, vals):
                meters[k].update_value(v)
                row[k] = meters[k].V_cur
            per_frame.append(row)
        summary = {k: m.measure() for k, m in meters.items()}
        self.log(f"[eval {mode}] " + " ".join(f"{k}={v:.4f}" for k, v in summary.items()))

        if self._files:
            mpath = os.path.join(self.media_dirs["metrics"], f"{mode}_epoch{self.epoch}.json")
            with open(mpath, "w") as f:
                json.dump({"summary": summary, "per_frame": per_frame}, f, indent=2)
            self._plot_metrics(mode, per_frame)
            if save_media and frames_out:
                frames_out = [np.concatenate([p.cpu().numpy(), g], axis=1)
                              for p, g in frames_out]
                write_video(os.path.join(self.media_dirs["eval_videos"],
                                         f"{mode}_epoch{self.epoch}.mp4"), frames_out, fps=25)
                save_image(os.path.join(self.media_dirs["eval_images"],
                                        f"{mode}_epoch{self.epoch}_frame0.png"), frames_out[0])
        return summary

    def _plot_metrics(self, mode: str, per_frame: list):
        """Per-frame metric curves (train/trainer.py:576-602 equivalent);
        skipped, with a log line, where matplotlib is not installed."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            self.log("[eval] matplotlib is not installed: no metric plot")
            return
        keys = [k for k in per_frame[0] if k != "frame"] if per_frame else []
        if not keys:
            return
        fig, axes = plt.subplots(1, len(keys), figsize=(4 * len(keys), 3))
        if len(keys) == 1:
            axes = [axes]
        for ax, key in zip(axes, keys):
            ax.plot([row[key] for row in per_frame])
            ax.set_title(key)
            ax.set_xlabel("frame")
        fig.tight_layout()
        fig.savefig(os.path.join(self.media_dirs["metrics"], f"{mode}_epoch{self.epoch}.png"))
        plt.close(fig)

    def optimize_tracking(self, optim_epoch: int = 50, batch: int = 8):
        """Fit test-set tracking rows (train/base.py:198-235): ``optim_epoch``
        gradient steps per frame on (expression, pose, camera translation),
        ``batch`` frames' rows per update (the last batch holds the rest; no
        padding is needed here, so no row is masked)."""
        ds = self.test_dataset
        dev = self.device
        self.log("==> optimizing test tracking...")
        n = len(ds)
        for start in range(0, n, batch):
            idxs = list(range(start, min(start + batch, n)))
            consts = []
            for i in idxs:
                s = ds.sample(i)
                wt = s.get("world_transform")
                consts.append((np.asarray(s["cam_pose"], np.float32)[:3, :3].T,
                               s["fovx"], s["fovy"],
                               torch.from_numpy(np.asarray(s["ground_truth"]["rgb"],
                                                           np.float32)).to(dev),
                               s.get("intrinsics_K"),
                               None if wt is None else torch.as_tensor(
                                   wt, dtype=torch.float32, device=dev)))
            idx_t = torch.as_tensor(idxs, dtype=torch.int64, device=dev)
            mask = torch.ones(len(idxs), dtype=torch.bool, device=dev)
            shared = (self.ts.params, self.ts.state)
            for _ in range(optim_epoch):
                self.test_tables, self.test_track_state = self._batched_tracking_step(
                    self.test_tables, self.test_track_state, idx_t, mask, consts, shared)

    # ------------------------------------------------------------------
    # media / checkpoints
    # ------------------------------------------------------------------

    def save_snapshot(self, sample: dict):
        """Seven-panel snapshot (train/trainer.py:474-538): pred / gt /
        FLAME-mesh overlay / L1 heat / canonical / gradient heat / sampled
        points (the mesh overlay replaces the nvdiffrast panel). A family
        without a visualization (an adapter's ``visualize`` None), and a
        frame with a model-to-world transform, get the pred / gt / L1 heat
        panel of the forward."""
        frame = self._make_frame(sample, self.train_tables)
        gt = self._rgb_f32(frame.rgb)
        # the diagnostic renders take no model-to-world transform: such a
        # frame gets the pred / gt / L1 heat panel, as in the JAX package
        simple = self._visualize is None or frame.world_transform is not None
        with torch.no_grad():
            if simple:
                vis = self._forward(self.ts.params, self.ts.state, frame.expression,
                                    frame.flame_pose, frame.camera, frame.world_transform)
            else:
                vis = self._visualize(self.ts.params, self.ts.state, frame.expression,
                                      frame.flame_pose, frame.camera)
                mesh_panel = overlay_mesh(gt, vis["verts"][0], self.model.faces,
                                          frame.camera).cpu().numpy()
        pred = vis["rgb_image"].cpu().numpy()
        l1 = np.abs(pred - gt).mean(-1, keepdims=True)
        heat = np.concatenate([l1, np.zeros_like(l1), 1.0 - l1], axis=-1)
        path = os.path.join(self.media_dirs["snapshots"], f"step{self.global_step:08d}.png")
        if simple:
            save_image_grid(path, [pred, gt, heat], cols=3)
            return
        save_image_grid(path, [pred, gt, mesh_panel, heat, vis["cano_image"].cpu().numpy(),
                               vis["grad_image"].cpu().numpy(),
                               vis["point_image"].cpu().numpy()], cols=4)

    def checkpoint_tree(self) -> dict:
        """The train state (FateAvatar's ``TrainState`` or a family's
        ``BaselineTrainState``: params, model state, Adam moments and count,
        step, the draws' generator), epoch and step counters and the tracking
        tables with their RowAdam state."""
        ts = self.ts
        tree = {
            "params": _fields(ts.params),
            "state": None if ts.state is None else _fields(ts.state),
            "opt_state": {"mu": _fields(ts.opt_state.mu), "nu": _fields(ts.opt_state.nu),
                          "count": ts.opt_state.count},
            "step": ts.step,
            "generator": ts.generator.get_state(),
            "epoch": self.epoch,
            "global_step": self.global_step,
        }
        if self.tracking_enabled:
            tree["train_tables"] = _fields(self.train_tables)
            tree["train_track_state"] = _track_state_tree(self.train_track_state)
            if self.test_dataset is not None:
                tree["test_tables"] = _fields(self.test_tables)
                tree["test_track_state"] = _track_state_tree(self.test_track_state)
        return tree

    def save_checkpoint(self):
        if self.ckpt is None or not self._files:
            return
        self.ckpt.save(self.global_step, self.checkpoint_tree())
        self.log(f"[ckpt] saved step {self.global_step}")

    def load_checkpoint(self, step: Optional[int] = None):
        tree = self.ckpt.restore(step, map_location=self.device)
        ts = self.ts
        # replace() rejects a field the containers do not have
        gen = torch.Generator(device=self.device)
        gen.set_state(tree["generator"].cpu())
        self.ts = type(ts)(
            params=dataclasses.replace(ts.params, **tree["params"]),
            state=None if ts.state is None else dataclasses.replace(ts.state, **tree["state"]),
            opt_state=MultiAdamState(
                mu=dataclasses.replace(ts.opt_state.mu, **tree["opt_state"]["mu"]),
                nu=dataclasses.replace(ts.opt_state.nu, **tree["opt_state"]["nu"]),
                count=tree["opt_state"]["count"]),
            step=int(tree["step"]),
            generator=gen,
        )
        self.epoch = int(tree["epoch"])
        self.global_step = int(tree["global_step"])
        if self.tracking_enabled:
            self.train_tables = TrackingTables(**tree["train_tables"])
            self.train_track_state = _track_state(tree["train_track_state"])
            if self.test_dataset is not None:
                self.test_tables = TrackingTables(**tree["test_tables"])
                self.test_track_state = _track_state(tree["test_track_state"])
        self.log(f"[ckpt] restored step {self.global_step}")
        self.regrow_caps()


def _track_state_tree(s: RowAdamState) -> dict:
    return {"mu": _fields(s.mu), "nu": _fields(s.nu), "count": s.count}


def _track_state(d: dict) -> RowAdamState:
    return RowAdamState(mu=TrackingTables(**d["mu"]), nu=TrackingTables(**d["nu"]),
                        count=d["count"])
