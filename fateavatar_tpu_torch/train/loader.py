"""Inference-side loading + cross-identity reenactment.

Port of ``fateavatar_tpu/train/loader.py`` (train/loader.py:30-227 of the
reference): rebuild a trained avatar from its workspace (checkpoint +
identity_info.json) without the training dataset, and drive it with another
subject's FLAME sequences. ``Reenactor.reenact`` serves a sequence through
one CUDA graph of the frame (``utils/graphs.py``), as the JAX package jits
it; ``Loader.render_frame`` stays eager for one-off calls.

Tracing (``utils/profiling.py``): a call is the span ``reenact.call`` (its
number and frames), with ``reenact.upload`` (the sequence to the device)
and one ``reenact.drain`` a ring copy inside it; the counters
``reenact.calls``, ``reenact.frames``, ``reenact.drains``,
``reenact.drain_s`` (host seconds of the ring copies, from the frames done
on the card to their arrival on the host) and ``reenact.overflow`` (the
instances the binning caps dropped). With tracing on, the served frame
marks ``forward``, ``raster_front``, ``blend`` (the render's), ``output``
(the uint8 rounding and the ring write) and ``end``.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
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
from fateavatar_tpu_torch.utils import profiling
from fateavatar_tpu_torch.utils.graphs import Graph
from fateavatar_tpu_torch.utils.logging import write_video

DRAIN = 8   # frames per device -> host copy of a served sequence


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
    sequence's expressions, shifted by the canonical-expression delta.
    ``last_graph`` is the Graph of the latest :meth:`reenact` call (its
    replays and launches per replay), ``last_overflow`` the instances its
    frames' binning dropped (0 on healthy caps)."""

    last_graph: Optional[Graph] = None
    last_overflow: int = 0

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
        if a frame has a non-finite pixel; warns when the binning caps
        dropped instances (``last_overflow``).

        The sequence's expressions (delta applied) and poses go to the
        device once; one CUDA graph per call (JAX: one jitted program,
        train/loader.py:98-101) renders the frame at a device cursor,
        rounds and clips it to uint8 into a ring of DRAIN frames, counts
        its finite frames and dropped instances on the device and advances
        the cursor. Every DRAIN frames one fetch of the two counts (the
        non-finite check), then one copy brings the ring to the host."""
        profiling.count("reenact.calls")
        call = int(profiling.COUNTERS["reenact.calls"])
        with profiling.span("reenact.call", call=call, frames=len(src_expressions)):
            frames = self._reenact(src_expressions, src_poses, delta_exp, camera)
        if out_path is not None:
            write_video(out_path, frames, fps=fps)
        return frames

    def _reenact(self, src_expressions, src_poses, delta_exp, camera) -> list:
        dev = self.params.offset.device
        n_exp = self.model.flame.n_exp
        n = len(src_expressions)
        exprs = np.zeros((n, n_exp), np.float32)
        for f, expr in enumerate(src_expressions):
            m = min(n_exp, len(expr))
            exprs[f, :m] = expr[:m]
        if delta_exp is not None:
            d = min(n_exp, len(delta_exp))
            exprs[:, :d] -= np.asarray(delta_exp, np.float32)[:d]
        frames: list = []
        self.last_overflow = 0
        if n == 0:
            return frames
        with profiling.span("reenact.upload"):
            expr_t = torch.from_numpy(exprs).to(dev)
            pose_t = torch.from_numpy(np.stack([np.asarray(p, np.float32)
                                                for p in src_poses])).to(dev)
        cursor = torch.zeros((1,), dtype=torch.int64, device=dev)
        ring = torch.empty((DRAIN, camera.height, camera.width, 3), dtype=torch.uint8,
                           device=dev)
        # finite frames, instances dropped: fetched together at each drain
        counts = torch.zeros((2,), dtype=torch.int64, device=dev)

        @torch.no_grad()
        def frame():
            profiling.mark("forward", dev)
            out = fateavatar_forward(
                self.model, self.params, self.state, expr_t.index_select(0, cursor)[0],
                pose_t.index_select(0, cursor)[0], camera, render_cfg=self.render_cfg)
            img, dropped = out["rgb_image"], out["overflow"]
            del out   # the frame's other outputs are freed before the rounding
            profiling.mark("output", dev)
            counts[0].add_(torch.isfinite(img).all())
            counts[1].add_(dropped)
            ring.index_copy_(0, torch.remainder(cursor, DRAIN),
                             torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8)[None])
            cursor.add_(1)
            profiling.mark("end", dev)

        graph = self.last_graph = Graph(frame, [cursor, ring, counts], "the served frame")
        drains, drain_s = 0, 0.0
        for f in range(n):
            graph()
            k = f + 1 - len(frames)
            if k == DRAIN or f + 1 == n:
                with profiling.span("reenact.drain", frames=k):
                    finite, self.last_overflow = counts.tolist()
                    if finite != f + 1:
                        raise FloatingPointError("a rendered frame has non-finite pixels")
                    # the frames are done on the card: the copy alone from here
                    t0 = time.perf_counter()
                    batch = ring[:k].to("cpu", copy=True).numpy()
                    frames.extend(batch[i] for i in range(k))
                    drain_s += time.perf_counter() - t0
                drains += 1
        profiling.count("reenact.frames", n)
        profiling.count("reenact.drains", drains)
        profiling.count("reenact.drain_s", drain_s)
        profiling.count("reenact.overflow", self.last_overflow)
        if self.last_overflow > 0:
            print(f"[WARN] {self.last_overflow} tile instances dropped by the binning caps "
                  f"in the {n} served frames", file=sys.stderr)
        return frames
