"""NeRSemble mono-FLAME-avatar benchmark harness.

Port of ``fateavatar_tpu/benchmark/nersemble.py`` (benchmark/ of the
reference): train FateAvatar on one camera serial of a NeRSemble
participant and render the hold-out serials of every test sequence to
CRF-14 videos for submission (benchmark/run_nersemble_benchmark.py:101-137,
train_nersemble_benchmark_mono.py:74-121).

It reads the neutral exported layout the JAX package reads
(``scripts/prepare_nersemble.py`` writes it from the proprietary
``nersemble_benchmark`` package):

  <root>/<participant>/
    calibration.json              # {serial: {"K": 3x3, "world2cam": 4x4}}
    sequences/<seq>/flame_params.json
    sequences/<seq>/images/<serial>/<frame>.png   (train serial only)

``flame_params.json`` carries the FLAME2023 tracking as the benchmark
publishes it (benchmark/nersemble/dataset.py:60-93): per frame
``expression``, ``jaw`` / ``neck`` (3), ``eyes`` (6), and the model-to-world
pose as ``rotation`` (euler XYZ) and ``translation``; plus the
participant's ``shape_params`` and a constant ``scale``. The global-rotation
slot of the composed [15] pose stays zero: the head pose is applied as a
world transform after posing (benchmark/nersemble/fateavatar.py:174-230),
which ``Frame.world_transform`` threads through training and rendering. A
single-sequence legacy layout (``<participant>/flame_params.json`` with a
pre-composed per-frame ``pose`` [15]) is still accepted.

Benchmark cameras have non-centred principal points, so the cameras take
the intrinsics-shift projection (``ops/camera.make_camera(intrinsics=K)``,
benchmark/nersemble/fateavatar.py:182-186).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from fateavatar_tpu_torch.models.fateavatar import fateavatar_forward
from fateavatar_tpu_torch.ops.camera import focal2fov, make_camera
from fateavatar_tpu_torch.train.datasets import FaceDataset, FrameRecord
from fateavatar_tpu_torch.utils.graphs import Graph
from fateavatar_tpu_torch.utils.logging import write_video

# the benchmark's standard serials (nersemble_benchmark.constants:
# BENCHMARK_MONO_FLAME_AVATAR_{TRAIN_SERIAL,HOLD_OUT_SERIALS})
DEFAULT_TRAIN_SERIAL = "222200037"
DEFAULT_HOLD_OUT_SERIALS = ("222200040", "222200042", "222200046", "222200049")

DRAIN = 8   # hold-out frames per device -> host copy


def _compose_pose15(jaw, neck, eyes):
    """[global=0, neck, jaw, eyes]: the benchmark variant zeroes the
    global-rotation slot (benchmark/nersemble/fateavatar.py:190-194)."""
    return np.concatenate([np.zeros(3, np.float32), neck, jaw, eyes])


class NersembleBenchmarkDataset(FaceDataset):
    """Per-serial dataset with intrinsics-shift cameras and the FLAME2023
    tracking split (benchmark/nersemble/dataset.py:12-93 contract)."""

    type_name = "nersemble"
    optimize_tracking = False

    def __init__(self, root: str, participant: str, serial: str, img_res,
                 sequence_list: Optional[Sequence[str]] = None,
                 mode: str = "train", cache_images: bool = True,
                 background_color: str = "white"):
        super().__init__(img_res, background_color, cache_images)
        pdir = os.path.join(root, participant)
        with open(os.path.join(pdir, "calibration.json")) as f:
            calib = json.load(f)[serial]

        self.K = np.asarray(calib["K"], np.float32)
        w2c = np.asarray(calib["world2cam"], np.float32)
        self.participant = participant
        self.serial = serial

        seq_dir = os.path.join(pdir, "sequences")
        if sequence_list is None:
            if os.path.isdir(seq_dir):
                sequence_list = sorted(os.listdir(seq_dir))
            else:
                sequence_list = [None]   # legacy single-sequence layout
        self.sequence_list = list(sequence_list)

        exprs, poses, wts = [], [], []
        self.shape_params = None
        h, w = img_res
        native_w = native_h = None
        for seq in self.sequence_list:
            if seq is None:
                fp_path = os.path.join(pdir, "flame_params.json")
                img_dir = os.path.join(pdir, "images", serial)
            else:
                fp_path = os.path.join(seq_dir, seq, "flame_params.json")
                img_dir = os.path.join(seq_dir, seq, "images", serial)
            with open(fp_path) as f:
                flame = json.load(f)
            self.n_shape = int(flame.get("n_shape", 300))
            self.n_exp = int(flame.get("n_exp", 100))
            if self.shape_params is None:
                self.shape_params = np.asarray(flame["shape_params"], np.float32).reshape(1, -1)
            if "native_width" not in flame:
                print(f"[nersemble] WARNING: {fp_path} lacks native_width/"
                      "height — assuming the calibration K already matches "
                      f"the working resolution {w}x{h}; if it is native-"
                      "resolution the FOV will be wrong "
                      "(re-export with scripts/prepare_nersemble.py)")
            native_w = float(flame.get("native_width", w))
            native_h = float(flame.get("native_height", h))
            scale = float(flame.get("scale", 1.0))
            for i, fr in enumerate(flame["frames"]):
                exprs.append(np.asarray(fr["expression"], np.float32)[: self.n_exp])
                if "pose" in fr:          # legacy: pre-composed [15]
                    poses.append(np.asarray(fr["pose"], np.float32))
                    wts.append(None)
                else:                     # FLAME2023 tracking split
                    poses.append(_compose_pose15(
                        np.asarray(fr["jaw"], np.float32),
                        np.asarray(fr.get("neck", [0, 0, 0]), np.float32),
                        np.asarray(fr.get("eyes", [0] * 6), np.float32)))
                    wts.append(np.concatenate([
                        np.asarray(fr["rotation"], np.float32),
                        np.asarray(fr["translation"], np.float32),
                        np.asarray([scale], np.float32)]))
                name = fr.get("name", f"{i:05d}")
                self.records.append(FrameRecord(
                    image_path=os.path.join(img_dir, name + ".png"), mask_path=None,
                    img_name=name if seq is None else f"{seq}/{name}"))

        # K for the working resolution, per axis (native NeRSemble: 2200x3208)
        self.K = self.K.copy()
        self.K[0] *= w / native_w
        self.K[1] *= h / native_h
        self.fovx = focal2fov(float(self.K[0, 0]), w)
        self.fovy = focal2fov(float(self.K[1, 1]), h)

        self.expressions = np.stack(exprs)
        self.flame_pose = np.stack(poses)
        if all(w_ is None for w_ in wts):
            self.world_transforms = None         # pure legacy layout
        else:
            # mixed layouts: legacy frames carry their head pose inside
            # pose15, so their world transform is the identity (dropping the
            # transforms wholesale would zero the split frames' head pose)
            ident = np.asarray([0, 0, 0, 0, 0, 0, 1], np.float32)
            self.world_transforms = np.stack([ident if w_ is None else w_ for w_ in wts])
        self.world_mats = np.tile(w2c[None], (len(self.records), 1, 1))
        self.mean_expression = self.expressions.mean(0, keepdims=True)
        self.var_expression = self.expressions.var(0, keepdims=True)

    def camera(self, idx: int, width: int, height: int, device="cuda"):
        w2v = self.world_mats[idx]
        return make_camera(w2v[:3, :3].T, w2v[:3, 3], self.fovx, self.fovy, width, height,
                           intrinsics=self.K, device=device)

    def sample(self, idx: int) -> dict:
        s = super().sample(idx)
        s["intrinsics_K"] = self.K  # the principal-point-shift camera
        if self.world_transforms is not None:
            s["world_transform"] = self.world_transforms[idx]
        return s


@dataclass
class BenchmarkRunConfig:
    root: str
    participants: List[str]
    train_serial: str = DEFAULT_TRAIN_SERIAL
    hold_out_serials: tuple = DEFAULT_HOLD_OUT_SERIALS
    test_sequences: tuple = ()
    out_dir: str = "./nersemble_submission"
    img_res: tuple = (512, 512)
    fps: int = 25
    crf: int = 14        # submission encoding (run_nersemble_benchmark.py:133)
    preset: str = "slow"


def _render_sequence(model, params, state, ds, img_res, render_cfg) -> list:
    """Every frame of ``ds`` rendered under ``no_grad``, clipped to [0, 1]:
    a list of float32 [H, W, 3] arrays. One CUDA graph of the frame
    (``utils/graphs.Graph``; JAX: one jitted function) reads the frame's
    expression, pose and world transform at a device cursor from the
    sequence's stacked static buffers and writes the clipped frame into a
    ring of DRAIN frames, which one copy brings to the host every DRAIN
    frames. Every frame of a serial shares its camera."""
    dev = params.offset.device
    n = len(ds)
    if n == 0:
        return []
    h, w = img_res
    cam = ds.camera(0, w, h, device=dev)
    expr_t = torch.as_tensor(ds.expressions, dtype=torch.float32, device=dev)
    pose_t = torch.as_tensor(ds.flame_pose, dtype=torch.float32, device=dev)
    wt_t = (None if ds.world_transforms is None else
            torch.as_tensor(ds.world_transforms, dtype=torch.float32, device=dev))
    cursor = torch.zeros((1,), dtype=torch.int64, device=dev)
    ring = torch.empty((DRAIN, h, w, 3), dtype=torch.float32, device=dev)

    @torch.no_grad()
    def frame():
        wt = None if wt_t is None else wt_t.index_select(0, cursor)[0]
        img = fateavatar_forward(model, params, state, expr_t.index_select(0, cursor)[0],
                                 pose_t.index_select(0, cursor)[0], cam,
                                 render_cfg=render_cfg, world_transform=wt)["rgb_image"]
        ring.index_copy_(0, torch.remainder(cursor, DRAIN), torch.clamp(img, 0.0, 1.0)[None])
        cursor.add_(1)

    graph = Graph(frame, [cursor, ring], f"the hold-out frame of serial {ds.serial}")
    frames: list = []
    for f in range(n):
        graph()
        k = f + 1 - len(frames)
        if k == DRAIN or f + 1 == n:
            batch = ring[:k].to("cpu", copy=True).numpy()
            frames.extend(batch[i] for i in range(k))
    return frames


def render_submission(
    model, params, state, dataset_root: str, participant: str,
    sequences, serials, img_res, submit_dir: str, render_cfg,
    fps: int = 25, crf: int = 14, preset: str = "slow", log_fn=print,
):
    """The reference's pack loop (run_nersemble_benchmark.py:101-137): for
    every test sequence x serial, render the tracked frames and encode
    ``<submit_dir>/<participant>/<sequence>/cam_<serial>.mp4`` at CRF 14 (a
    GIF beside it where ffmpeg is missing). Returns the mp4 paths."""
    written = []
    for seq in sequences:
        video_folder = os.path.join(submit_dir, str(participant), seq)
        os.makedirs(video_folder, exist_ok=True)
        for serial in serials:
            ds = NersembleBenchmarkDataset(dataset_root, participant, serial, img_res,
                                           sequence_list=[seq], mode="test")
            frames = _render_sequence(model, params, state, ds, img_res, render_cfg)
            path = os.path.join(video_folder, f"cam_{serial}.mp4")
            ok = write_video(path, frames, fps=fps, crf=crf, preset=preset)
            log_fn(f"[nersemble] {seq}/cam_{serial}: {len(frames)} frames "
                   f"-> {path}" + ("" if ok else " (gif fallback)"))
            written.append(path)
    return written


def render_hold_out_serials(
    model, params, state, dataset_root: str, participant: str,
    hold_out_serials, img_res, out_dir: str, render_cfg, fps: int = 25,
):
    """Single-sequence legacy harness: each hold-out serial to one video
    named ``<participant>_cam_<serial>.mp4``."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for serial in hold_out_serials:
        ds = NersembleBenchmarkDataset(dataset_root, participant, serial, img_res, mode="test")
        frames = _render_sequence(model, params, state, ds, img_res, render_cfg)
        path = os.path.join(out_dir, f"{participant}_cam_{serial}.mp4")
        write_video(path, frames, fps=fps)
        written.append(path)
    return written
