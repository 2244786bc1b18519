"""Dataset containers: the ``FaceDataset`` base, the synthetic self-test
set and the prefetching iterator.

Port of part of ``fateavatar_tpu/train/datasets.py`` (train/dataset.py:81-595
of the reference). Metadata lives in dense numpy arrays and ``sample(idx)``
returns one frame as numpy (the ``__getitem__`` contract of
dataset.py:283-319). The INSTA and IMAvatar readers, which decode PNG/JPEG
images, are not ported yet; ``SyntheticDataset`` lets the whole trainer run
with no external assets.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from queue import Queue
from typing import Iterator, Optional

import numpy as np


@dataclass
class FrameRecord:
    image_path: str
    mask_path: Optional[str]
    img_name: str


class FaceDataset:
    """Common container. Subclasses fill world_mats [N,4,4] (world->view),
    expressions [N,n_exp], flame_pose [N,15], records, fovx/fovy,
    shape_params [1,n_shape], mean/var expression, and provide
    ``load_image(idx) -> (rgb [H,W,3], alpha [H,W,1])``."""

    type_name: str = "base"
    optimize_tracking: bool = False

    def __init__(self, img_res, background_color="black", cache_images=True):
        self.img_res = list(img_res)
        self.background_color = background_color
        self.cache_images = cache_images
        self.records: list[FrameRecord] = []

    def __len__(self):
        return len(self.records)

    def load_image(self, idx: int):
        raise NotImplementedError(
            f"{type(self).__name__} has no image reader (the PNG/JPEG "
            "readers are not ported)")

    def sample(self, idx: int) -> dict:
        """One frame's metadata and ground truth, as numpy."""
        rgb, alpha = self.load_image(idx)
        return {
            "idx": idx,
            "img_name": self.records[idx].img_name,
            "fovx": self.fovx,
            "fovy": self.fovy,
            "expression": self.expressions[idx],
            "flame_pose": self.flame_pose[idx],
            "cam_pose": self.world_mats[idx],
            "ground_truth": {"rgb": rgb, "object_mask": alpha},
        }


class SyntheticDataset(FaceDataset):
    """Procedural frames around a synthetic head — lets the full trainer run
    with zero external assets. The numpy draws are the JAX package's, so both
    packages see the same frames from the same seed."""

    type_name = "synthetic"
    optimize_tracking = False

    def __init__(self, num_frames=8, img_res=(64, 64), n_shape=6, n_exp=4,
                 seed=0, camera_distance=0.4, fov=0.8):
        super().__init__(img_res, cache_images=False)
        rng = np.random.default_rng(seed)
        self.n_shape = n_shape
        self.n_exp = n_exp
        self.num_frames = num_frames
        self.expressions = rng.normal(size=(num_frames, n_exp)).astype(np.float32) * 0.3
        self.flame_pose = rng.normal(size=(num_frames, 15)).astype(np.float32) * 0.05
        self.fovx = self.fovy = fov
        self.shape_params = np.zeros((1, n_shape), np.float32)
        self.mean_expression = np.zeros((1, n_exp), np.float32)
        self.var_expression = None
        wm = np.tile(np.eye(4, dtype=np.float32), (num_frames, 1, 1))
        for i in range(num_frames):
            ang = (i / max(num_frames, 1) - 0.5) * 0.6
            c, s = np.cos(ang), np.sin(ang)
            wm[i, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            wm[i, :3, 3] = [0, 0, camera_distance]
        self.world_mats = wm
        self._images = rng.random(
            (num_frames, img_res[0], img_res[1], 3)).astype(np.float32)
        self.records = [FrameRecord(image_path=f"synthetic://{i}", mask_path=None,
                                    img_name=str(i)) for i in range(num_frames)]

    def load_image(self, idx):
        return self._images[idx], np.ones(tuple(self.img_res) + (1,), np.float32)


class Prefetcher:
    """Background-thread double buffering: prepare frame i+1 while the card
    trains on frame i (the reference's DataLoader workers,
    train/base.py:54-68). An error in the worker is raised to the
    consumer."""

    def __init__(self, dataset: FaceDataset, order: np.ndarray, depth: int = 2):
        self.dataset = dataset
        self.order = order
        self.queue: Queue = Queue(maxsize=depth)
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            for idx in self.order:
                self.queue.put(self.dataset.sample(int(idx)))
        except Exception as e:   # handed to the consumer, which raises it
            self.queue.put(e)
            return
        self.queue.put(None)

    def __iter__(self) -> Iterator[dict]:
        while True:
            item = self.queue.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
