"""Dataset readers: INSTA, IMAvatar, and a synthetic self-test set.

Port of ``fateavatar_tpu/train/datasets.py`` (train/dataset.py:81-595 of
the reference). Metadata is parsed once into dense numpy arrays, images
decode lazily with an optional in-RAM cache, and ``sample(idx)`` returns one
frame as numpy (the ``__getitem__`` contract of dataset.py:283-319); a
prefetching thread overlaps decoding with the card's work. Images decode
through the port's PNG and JPEG codecs (``utils/png.py``, ``utils/jpeg.py``),
the counterparts of the JAX package's native loader.

Camera-convention notes are preserved from the reference loaders:
IMAvatar world_mat sign flips (dataset.py:264-272), INSTA
camera-rotation-as-head-rotation (dataset.py:437-446, rot_camera=True), 6d
rotations -> axis-angle for jaw/eyes (dataset.py:510-525).
"""

from __future__ import annotations

import json
import math
import os
import threading
from dataclasses import dataclass
from queue import Queue
from typing import Iterator, Optional

import numpy as np

from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.utils import png

# ---------------------------------------------------------------------------
# small math helpers (host side)
# ---------------------------------------------------------------------------

def rotation_6d_to_matrix(d6: np.ndarray) -> np.ndarray:
    """6D rotation representation (Zhou et al.) -> 3x3 matrices. [..., 6]."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / np.linalg.norm(a1, axis=-1, keepdims=True).clip(1e-8)
    b2 = a2 - np.sum(b1 * a2, axis=-1, keepdims=True) * b1
    b2 = b2 / np.linalg.norm(b2, axis=-1, keepdims=True).clip(1e-8)
    b3 = np.cross(b1, b2)
    return np.stack([b1, b2, b3], axis=-2)


def matrix_to_axis_angle(m: np.ndarray) -> np.ndarray:
    """3x3 rotation matrices -> axis-angle. [..., 3, 3] -> [..., 3]."""
    tr = np.trace(m, axis1=-2, axis2=-1)
    cos = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    angle = np.arccos(cos)
    axis = np.stack(
        [m[..., 2, 1] - m[..., 1, 2],
         m[..., 0, 2] - m[..., 2, 0],
         m[..., 1, 0] - m[..., 0, 1]], axis=-1
    )
    norm = np.linalg.norm(axis, axis=-1, keepdims=True)
    small = norm[..., 0] < 1e-8
    axis = np.where(small[..., None], np.array([1.0, 0, 0]), axis / np.where(norm < 1e-8, 1.0, norm))
    return axis * angle[..., None]


def load_rgb(path: str, img_res, bg_color: str = "black",
             return_alpha: bool = False):
    """Decode + resize + alpha-composite (train/dataset.py:14-54). Returns
    HWC float32 in [0,1]. PNG or JPEG, by the file's magic bytes; another
    format raises ``ValueError``."""
    rgba, src_c = png.decode_image(path, img_res[0], img_res[1])
    arr = rgba if src_c == 4 else rgba[:, :, :3]
    alpha = None
    if arr.shape[2] == 4:
        alpha = arr[:, :, 3:4]
        if bg_color == "white":
            arr = arr[:, :, :3] * alpha + (1 - alpha)
        elif bg_color == "black":
            arr = arr[:, :, :3] * alpha
        else:
            raise ValueError(f"invalid bg_color {bg_color!r}")
    if return_alpha:
        if alpha is None:
            alpha = np.ones(arr.shape[:2] + (1,), np.float32)
        return arr, alpha
    return arr


def load_mask(path: str, img_res) -> np.ndarray:
    """A mask as float32 [H, W] in [0, 1], as the JAX package's PIL reader
    gives it: grey by PIL's "L" luma (R 19595, G 38470, B 7471 of 65536,
    rounded; alpha ignored, grey kept exact), resized to ``img_res`` (read as
    (width, height), as PIL takes it) by PIL's default bicubic filter.
    Exact at the native size and resized. PNG or JPEG (decoded as libjpeg
    decodes it for PIL); a 16-bit PNG keeps its high byte here, where PIL
    clips the 16-bit value."""
    rgb = png.read_image(path)[..., :3].astype(np.uint32)
    grey = ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)
    grey = png.resize_bicubic_u8(grey, img_res[0], img_res[1])
    return grey.astype(np.float32) / 255.0


def _intrinsics_and_fov(focal_cxcy):
    """Normalized (fx, fy, cx, cy) -> 4x4 intrinsics, matching
    dataset.py:244-262/535-548 including the IMAvatar fx<0 quirk."""
    intr = np.zeros((4, 4), np.float32)
    intr[0, 0] = focal_cxcy[0] * 2
    intr[1, 1] = focal_cxcy[1] * 2
    intr[0, 2] = (focal_cxcy[2] * 2 - 1.0) * -1
    intr[1, 2] = (focal_cxcy[3] * 2 - 1.0) * -1
    intr[3, 2] = 1.0
    intr[2, 3] = 1.0
    return intr


# ---------------------------------------------------------------------------
# dataset base
# ---------------------------------------------------------------------------

@dataclass
class FrameRecord:
    image_path: str
    mask_path: Optional[str]
    img_name: str


class FaceDataset:
    """Common container. Subclasses fill world_mats [N,4,4] (world->view),
    expressions [N,n_exp], flame_pose [N,15], records, fovx/fovy,
    shape_params [1,n_shape], mean/var expression."""

    type_name: str = "base"
    optimize_tracking: bool = False

    def __init__(self, img_res, background_color="black", cache_images=True,
                 is_flashavatar: bool = False):
        self.img_res = list(img_res)
        self.background_color = background_color
        self.cache_images = cache_images
        # FlashAvatar's inputs: each frame's mouth mask (its _mouth.png)
        self.is_flashavatar = is_flashavatar
        self._cache: dict = {}
        self.records: list[FrameRecord] = []

    def __len__(self):
        return len(self.records)

    def load_image(self, idx: int):
        if self.cache_images and idx in self._cache:
            return self._cache[idx]
        out = load_rgb(self.records[idx].image_path, self.img_res,
                       bg_color=self.background_color, return_alpha=True)
        if self.is_flashavatar:
            out = (*out, load_mask(self._mouth_mask_path(idx), self.img_res))
        if self.cache_images:
            self._cache[idx] = out
        return out

    def _mouth_mask_path(self, idx: int) -> str:
        raise NotImplementedError(f"{type(self).__name__} has no mouth masks")

    def sample(self, idx: int) -> dict:
        """One frame's metadata and ground truth, as numpy (the __getitem__
        contract, dataset.py:283-319, 559-595); with ``is_flashavatar`` the
        ground truth holds the mouth mask [H, W, 1] too."""
        loaded = self.load_image(idx)
        gt = {"rgb": loaded[0], "object_mask": loaded[1]}
        if self.is_flashavatar:
            gt["mouth_mask"] = loaded[2][..., None]
        return {
            "idx": idx,
            "img_name": self.records[idx].img_name,
            "fovx": self.fovx,
            "fovy": self.fovy,
            "expression": self.expressions[idx],
            "flame_pose": self.flame_pose[idx],
            "cam_pose": self.world_mats[idx],
            "ground_truth": gt,
        }

    def camera(self, idx: int, width: int, height: int, device="cuda"):
        w2v = self.world_mats[idx]
        R = w2v[:3, :3].T  # make_camera expects the 3DGS (R=c2w-rot) form
        T = w2v[:3, 3]
        return make_camera(R, T, self.fovx, self.fovy, width, height, device=device)


# ---------------------------------------------------------------------------
# IMAvatar
# ---------------------------------------------------------------------------

class IMAvatarDataset(FaceDataset):
    """flame_params.json layout (train/dataset.py:114-319)."""

    type_name = "imavatar"
    optimize_tracking = True
    n_shape = 100
    n_exp = 50

    def __init__(self, root_path, mode, img_res, use_mean_expression=False,
                 use_var_expression=False, background_color="black",
                 cache_images=True, is_flashavatar=False, subsample=1):
        super().__init__(img_res, background_color, cache_images, is_flashavatar)
        instance_dir = os.path.join(
            root_path, f"{os.path.basename(root_path)}_{mode}"
        )
        with open(os.path.join(instance_dir, "flame_params.json")) as f:
            meta = json.load(f)

        world_mats, exprs, poses = [], [], []
        for frame in meta["frames"][::subsample]:
            wm = np.array(frame["world_mat"], np.float32)
            wm[:, 3] /= 4  # FLAME scaled by 4 in the DECA pipeline
            world_mats.append(wm)
            exprs.append(np.array(frame["expression"], np.float32))
            poses.append(np.array(frame["pose"], np.float32))
            img = os.path.join(instance_dir, frame["file_path"] + ".png")
            self.records.append(FrameRecord(
                image_path=img.replace("image", "matted"),
                mask_path=None,
                img_name=frame["file_path"].split("/")[-1],
            ))

        self.gt_dir = instance_dir
        self.shape_params = np.array(meta["shape_params"], np.float32)[None]
        wm = np.stack(world_mats)                        # [N, 3, 4]
        wm4 = np.tile(np.eye(4, dtype=np.float32), (len(wm), 1, 1))
        wm4[:, :3, :] = wm

        intr_raw = meta["intrinsics"]                    # fx fy cx cy normalized
        intr = _intrinsics_and_fov(intr_raw)
        self.intrinsics = intr
        fx, fy, cx, cy = intr_raw[:4]
        self.fovx = 2 * math.atan2(cx, -fx)
        self.fovy = 2 * math.atan2(cy, fy)

        # camera-convention fixups (dataset.py:264-272)
        if intr[0, 0] < 0:
            wm4[:, 0, :] *= -1
        wm4[:, :3, 2] *= -1
        wm4[:, 2, 3] *= -1
        wm4[:, 0, :] *= -1
        wm4[:, 1, :] *= -1

        self.world_mats = wm4
        self.expressions = np.stack(exprs)
        self.flame_pose = np.stack(poses)

        self.mean_expression = (
            self.expressions.mean(0, keepdims=True)
            if use_mean_expression else np.zeros((1, self.n_exp), np.float32)
        )
        self.var_expression = (
            self.expressions.var(0, keepdims=True) if use_var_expression else None
        )

    def _mouth_mask_path(self, idx):
        return self.records[idx].image_path.replace("matted", "parsing").replace(
            ".png", "_mouth.png")


# ---------------------------------------------------------------------------
# INSTA
# ---------------------------------------------------------------------------

class InstaDataset(FaceDataset):
    """transforms_{train,test}.json + per-frame flame txt coefficients
    (train/dataset.py:323-595). Head rotation realized as camera rotation
    (rot_camera=True path, dataset.py:437-446, 478-480)."""

    type_name = "insta"
    optimize_tracking = False
    n_shape = 300
    n_exp = 100

    def __init__(self, root_path, mode, img_res, use_mean_expression=False,
                 use_var_expression=False, background_color="black",
                 cache_images=True, is_flashavatar=False, subsample=1):
        super().__init__(img_res, background_color, cache_images, is_flashavatar)
        tf = "transforms_train.json" if mode == "train" else "transforms_test.json"
        with open(os.path.join(root_path, tf)) as f:
            meta = json.load(f)
        frames = sorted(
            meta["frames"],
            key=lambda x: int(x["file_path"].split("/")[-1].split(".")[0]),
        )[::subsample]

        world_mats, exprs, jaws, eyes = [], [], [], []
        shape = None
        for frame in frames:
            c2w = np.array(frame["transform_matrix"], np.float32)
            w2c = np.linalg.inv(c2w)
            # rot_camera: transpose the rotation block (head motion becomes
            # camera orbit; dataset.py:478-480)
            w2c[:3, :3] = w2c[:3, :3].T
            world_mats.append(w2c)
            if shape is None:
                shape = np.loadtxt(
                    os.path.join(root_path, frame["exp_path"].replace("exp", "shape"))
                )
            exprs.append(np.loadtxt(os.path.join(root_path, frame["exp_path"])))
            eyes.append(np.loadtxt(
                os.path.join(root_path, frame["exp_path"].replace("exp", "eyes"))
            ))
            jaws.append(np.loadtxt(
                os.path.join(root_path, frame["exp_path"].replace("exp", "jaw"))
            ))
            self.records.append(FrameRecord(
                image_path=os.path.join(root_path, frame["file_path"]),
                mask_path=os.path.join(
                    root_path, frame["file_path"].replace("images", "alpha")
                ),
                img_name=frame["file_path"].split("/")[-1],
            ))

        n = len(frames)
        self.shape_params = np.asarray(shape, np.float32)[None]
        self.expressions = np.stack(exprs).astype(np.float32)
        eyes = np.stack(eyes).astype(np.float32)
        jaws = np.stack(jaws).astype(np.float32)

        l_eye = matrix_to_axis_angle(rotation_6d_to_matrix(eyes[:, 6:]))
        r_eye = matrix_to_axis_angle(rotation_6d_to_matrix(eyes[:, :6]))
        jaw = matrix_to_axis_angle(rotation_6d_to_matrix(jaws))
        zero = np.zeros((n, 3), np.float32)
        # [rot | neck | jaw | l_eye | r_eye] (dataset.py:525)
        self.flame_pose = np.concatenate([zero, zero, jaw, l_eye, r_eye], axis=1)
        self.world_mats = np.stack(world_mats)

        focal_cxcy = [
            0.5 * meta["fl_x"] / meta["cx"],
            0.5 * meta["fl_y"] / meta["cy"],
            meta["cx"] / meta["w"],
            meta["cy"] / meta["h"],
        ]
        self.intrinsics = _intrinsics_and_fov(focal_cxcy)
        self.fovx = 2 * math.atan2(focal_cxcy[2], focal_cxcy[0])
        self.fovy = 2 * math.atan2(focal_cxcy[3], focal_cxcy[1])

        self.mean_expression = (
            self.expressions.mean(0, keepdims=True)
            if use_mean_expression else np.zeros((1, self.n_exp), np.float32)
        )
        self.var_expression = (
            self.expressions.var(0, keepdims=True) if use_var_expression else None
        )

    def _mouth_mask_path(self, idx):
        return self.records[idx].image_path.replace("images", "parsing").replace(
            ".png", "_mouth.png")


# ---------------------------------------------------------------------------
# synthetic dataset (tests / self-contained runs)
# ---------------------------------------------------------------------------

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


def construct_dataset(root_path: str, mode: str, img_res, **kwargs) -> FaceDataset:
    """Dataset-type inference from the root path, like common.py:34-44."""
    rp = root_path.lower()
    if "insta" in rp:
        return InstaDataset(root_path, mode, img_res, **kwargs)
    if "imavatar" in rp or "im_avatar" in rp:
        return IMAvatarDataset(root_path, mode, img_res, **kwargs)
    raise ValueError(
        f"cannot infer dataset type from {root_path!r}; "
        "expected an 'insta' or 'imavatar' path component"
    )
