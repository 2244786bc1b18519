"""Inference-side loading + cross-identity reenactment.

Port of ``fateavatar_tpu/train/loader.py`` (train/loader.py:30-227 of the
reference): rebuild a trained avatar from its workspace (checkpoint +
identity_info.json) without the training dataset, and drive it with another
subject's FLAME sequences.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from fateavatar_tpu_torch.models.fateavatar import (
    FateAvatarModel,
    fateavatar_forward,
)
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train.checkpoints import CheckpointManager
from fateavatar_tpu_torch.train.tracking import TrackingTables
from fateavatar_tpu_torch.utils.logging import write_video


def checkpoint_tree(params, state, epoch: int = 0, global_step: int = 0) -> dict:
    """The saved tree of an avatar: params and state as field-name dicts."""
    def fields(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}

    return {"params": fields(params), "state": fields(state),
            "epoch": epoch, "global_step": global_step}


class Loader:
    """Restore (params, state) of a trained avatar from a workspace's
    ``checkpoints/`` onto the device of ``params_template``, and ``tables``
    (the train set's TrackingTables, or None) where the run refined
    tracking."""

    def __init__(self, model: FateAvatarModel, params_template, state_template,
                 workspace: str, render_cfg: RenderConfig = RenderConfig()):
        self.model = model
        self.workspace = workspace
        self.render_cfg = render_cfg
        ckpt = CheckpointManager(os.path.join(workspace, "checkpoints"))
        tree = ckpt.restore(map_location=params_template.offset.device)
        # replace() rejects a field the containers do not have
        self.params = dataclasses.replace(params_template, **tree["params"])
        self.state = dataclasses.replace(state_template, **tree["state"])
        self.epoch = int(tree["epoch"])
        # the train set's tracked rows, when the run refined tracking
        self.tables = (TrackingTables(**tree["train_tables"])
                       if "train_tables" in tree else None)

    def render_frame(self, expression, flame_pose, camera):
        dev = self.params.offset.device
        return fateavatar_forward(
            self.model, self.params, self.state,
            torch.as_tensor(expression, dtype=torch.float32, device=dev),
            torch.as_tensor(flame_pose, dtype=torch.float32, device=dev),
            camera, render_cfg=self.render_cfg,
        )["rgb_image"]


class Reenactor(Loader):
    """Cross-identity reenactment (train/loader.py:140-227 +
    avatar_reenact.py:85-88): drive the destination avatar with the source
    sequence's expressions, shifted by the canonical-expression delta."""

    def reenact(
        self,
        src_expressions: np.ndarray,   # [F, n_exp] source sequence
        src_poses: np.ndarray,         # [F, 15]
        delta_exp: Optional[np.ndarray],  # src_canonical - dst_mean (or None)
        camera,
        out_path: Optional[str] = None,
        fps: int = 25,
    ):
        """Render every frame; returns the uint8 [H, W, 3] frames. Raises
        if a frame has a non-finite pixel."""
        n_exp = self.model.flame.n_exp
        frames: list = []
        pending: list = []
        finite = torch.ones((), dtype=torch.bool, device=self.params.offset.device)

        def drain():
            # one device->host copy per batch; frames queue on the device
            # meanwhile
            if not pending:
                return
            if not bool(finite):
                raise FloatingPointError("a rendered frame has non-finite pixels")
            batch = torch.stack(pending).cpu().numpy()
            frames.extend(batch[i] for i in range(batch.shape[0]))
            pending.clear()

        for expr, pose in zip(src_expressions, src_poses):
            e = np.zeros(n_exp, np.float32)
            m = min(n_exp, len(expr))
            e[:m] = expr[:m]
            if delta_exp is not None:
                e[: len(delta_exp)] -= np.asarray(delta_exp, np.float32)[: len(e)]
            img = self.render_frame(e, np.asarray(pose, np.float32), camera)
            finite &= torch.isfinite(img).all()
            pending.append(torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8))
            if len(pending) >= 8:
                drain()
        drain()
        if out_path is not None:
            write_video(out_path, frames, fps=fps)
        return frames
