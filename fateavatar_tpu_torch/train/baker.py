"""Neural baking trainer + texture editor.

Port of ``fateavatar_tpu/train/baker.py`` (train/baker.py:32-777 of the
reference, UVBaker / UVEditor): optimize the UV decoder against the trained
avatar's renders, dump textures, export a baked avatar, and edit the baked
color texture (sticker compositing and style transfer) with re-rendering.

The JAX package jit-compiles one bake step. Here one step (forward, loss,
backward, Adam) runs on static buffers and is captured as a CUDA graph
(``utils/graphs.py``): each frame is copied into the step's input buffers
and the graph replays; on the CPU the step runs as it is. The losses stay
on the device until one fetch per epoch.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from fateavatar_tpu_torch.models import uv_decoder as uvd
from fateavatar_tpu_torch.models.uv_decoder import UVDecoderModel
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.ops.sh import rgb_to_sh, sh_to_rgb
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train.checkpoints import save_pytree
from fateavatar_tpu_torch.train.datasets import FaceDataset, Prefetcher
from fateavatar_tpu_torch.train.optim import B1, B2, EPS
from fateavatar_tpu_torch.utils.graphs import Graph
from fateavatar_tpu_torch.utils.logging import Logger, save_image_grid, write_video

# the device frame cache's budget (float32 gt + camera per frame)
FRAME_CACHE_BYTES = 2 << 30
# the per-step values a bake step records, in its aux buffer's order
STEP_AUX = ("loss", "reg_loss", "overflow")


class UVBaker:
    """Decoder-only optimization (train/baker.py:97-191): Adam (lr 1e-3,
    optax's defaults) over the network's parameters and the const input,
    avatar priors frozen; the BatchNorm statistics are state, not trained.

    ``const`` is copied into a leaf tensor the baker owns (``self.const``);
    the network's parameters and statistics are updated in place.
    ``eager=True`` runs the step without its graph (for measurements; on
    the CPU both are the same call)."""

    def __init__(
        self,
        model: UVDecoderModel,
        net: torch.nn.Module,
        const: torch.Tensor,
        loss_fn,                      # FateAvatarLoss-compatible callable
        train_dataset: FaceDataset,
        workspace: Optional[str] = None,
        reg_weight: float = 0.0,
        reg_attribute=("color",),
        lr: float = 1e-3,
        render_cfg: RenderConfig = RenderConfig(),
        bg_color=None,
    ):
        self.model = model
        self.net = net
        self.loss_fn = loss_fn
        self.dataset = train_dataset
        self.workspace = workspace
        self.reg_weight = reg_weight
        self.reg_attribute = tuple(reg_attribute)
        self.lr = lr
        self.render_cfg = render_cfg
        self.device = const.device
        dev = self.device
        self.bg_color = (torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
                         if bg_color is not None else model.avatar.bg_color)
        self.logger = Logger("baker", workspace)
        self.epoch = 0
        self.global_step = 0
        self.eager = False
        self.epoch_losses: list = []
        self.last_epoch_stats: Optional[dict] = None

        self.const = const.detach().clone().requires_grad_()
        self.trainables = [*net.parameters(), self.const]
        self.stats = list(net.buffers())
        self.mu = [torch.zeros_like(p) for p in self.trainables]
        self.nu = [torch.zeros_like(p) for p in self.trainables]
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

        # the step's inputs, one frame at a time
        h, w = model.avatar.cfg.img_height, model.avatar.cfg.img_width
        self._in = {
            "expression": torch.zeros(model.avatar.flame.n_exp, device=dev),
            "flame_pose": torch.zeros(15, device=dev),
            "R": torch.zeros((3, 3), device=dev),
            "T": torch.zeros(3, device=dev),
            "fovx": torch.zeros((), device=dev),
            "fovy": torch.zeros((), device=dev),
            "rgb": torch.zeros((h, w, 3), device=dev),
            "bg": torch.zeros(3, device=dev),
        }
        self._aux = torch.zeros(len(STEP_AUX), device=dev)
        self.graph = Graph(self._step, [*self.state_tensors(), self._aux], "the bake step")

        # device frame cache (float32 gt + camera per index), gated on a
        # conservative memory budget like the Trainer's uint8 cache
        est_bytes = len(train_dataset) * h * w * 12
        self._frame_cache: Optional[dict] = {} if est_bytes <= FRAME_CACHE_BYTES else None

        if workspace is not None:
            for sub in ("textures", "checkpoints_baked", "bake_snapshots"):
                os.makedirs(os.path.join(workspace, sub), exist_ok=True)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def state_tensors(self) -> list:
        """Every tensor a step updates: the trainables (network parameters,
        then the const), the BatchNorm statistics, the Adam moments and the
        Adam step count."""
        return [*self.trainables, *self.stats, *self.mu, *self.nu, self.count]

    @torch.no_grad()
    def snapshot(self) -> list:
        return [t.clone() for t in self.state_tensors()]

    @torch.no_grad()
    def restore(self, snap: list):
        for t, v in zip(self.state_tensors(), snap):
            t.copy_(v)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def loss_of(self, frame: Dict[str, torch.Tensor]):
        """The bake loss of one frame (a dict shaped like the step's input
        buffers): (total loss, loss dict, forward output). The loss dict's
        ``loss`` is the image loss alone, as in the JAX package; ``reg_loss``
        is the per-attribute masked L2 against the trained priors
        (train/loss.py:651-676) over the alive prior splats. Runs the
        network in training mode: its BatchNorm statistics update."""
        model = self.model
        cfg = model.avatar.cfg
        camera = make_camera(frame["R"], frame["T"], frame["fovx"], frame["fovy"],
                             cfg.img_width, cfg.img_height, device=self.device)
        out = uvd.uv_decoder_forward(
            model, self.net, self.const, frame["expression"], frame["flame_pose"], camera,
            bg_color=frame["bg"], render_cfg=self.render_cfg, train=True)
        losses = self.loss_fn(out, {"rgb": frame["rgb"]})
        loss = losses["loss"]
        if self.reg_weight > 0:
            w = model.alive[: model.prior_opacity.shape[0]].to(torch.float32)
            denom = torch.clamp_min(torch.sum(w), 1.0)

            def masked_l2(a, b):
                d = torch.sum((a - b) ** 2, dim=tuple(range(1, a.dim())))
                return torch.sum(d * w) / denom

            pairs = {
                "color": (out["decode_color"], out["prior_features_dc"]),
                "opacity": (out["decode_opacity"], out["prior_opacity"]),
                "scaling": (out["decode_scaling"], out["prior_scaling"]),
                "rotation": (out["decode_rotation"], out["prior_rotation"]),
                "offset": (out["decode_offset"], out["prior_offset"]),
            }
            reg = 0.0
            for att in self.reg_attribute:
                reg = reg + masked_l2(*pairs[att])
            losses["reg_loss"] = reg
            loss = loss + reg * self.reg_weight
        return loss, losses, out

    def grads(self, frame: Optional[Dict[str, torch.Tensor]] = None):
        """The step's gradient phase on ``frame`` (default: the input
        buffers): (gradients of the trainables, loss dict, forward output).
        A trainable the loss does not reach gets zeros."""
        loss, losses, out = self.loss_of(self._in if frame is None else frame)
        g = torch.autograd.grad(loss, self.trainables, allow_unused=True)
        return [torch.zeros_like(p) if gi is None else gi
                for p, gi in zip(self.trainables, g)], losses, out

    @torch.no_grad()
    def adam_(self, grads):
        """optax.adam in place, in its arithmetic order, with the step count
        on the device."""
        self.count.add_(1)
        t = self.count.to(torch.float32)
        c1 = 1.0 - B1 ** t
        c2 = 1.0 - B2 ** t
        for p, g, m, v in zip(self.trainables, grads, self.mu, self.nu):
            m.copy_((1 - B1) * g + B1 * m)
            v.copy_((1 - B2) * g * g + B2 * v)
            p.add_(m / c1 / (torch.sqrt(v / c2) + EPS) * -self.lr)

    def _step(self):
        """One bake step on the input buffers: gradients, Adam, and the
        step's loss, reg loss and overflow into the aux buffer. Reads no
        host value, so one capture replays as every step."""
        grads, losses, out = self.grads()
        self.adam_(grads)
        loss = losses["loss"].detach()
        reg = losses["reg_loss"].detach() if "reg_loss" in losses else torch.zeros_like(loss)
        self._aux.copy_(torch.stack([loss, reg, out["overflow"].to(torch.float32)]))

    def step(self, frame: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Copy ``frame`` into the input buffers and run one step (a replay
        of the graph, captured at the first call; eagerly with
        ``self.eager``). Returns a device copy of the step's aux values
        (:data:`STEP_AUX`)."""
        with torch.no_grad():
            for k, buf in self._in.items():
                buf.copy_(frame[k])
        if self.eager:
            self._step()
        else:
            self.graph()
        self.global_step += 1
        return self._aux.clone()

    # ------------------------------------------------------------------
    # epochs
    # ------------------------------------------------------------------

    def bake(self, max_epochs: int = 5, pseudo_dataset: Optional[FaceDataset] = None):
        # the __init__ budget gate saw only the real dataset; pseudo frames
        # are cached too (keyed ('pseudo', idx)), so re-check the combined
        # footprint and drop caching entirely if it would blow the budget
        if pseudo_dataset is not None and self._frame_cache is not None:
            cfg = self.model.avatar.cfg
            est = (len(self.dataset) + len(pseudo_dataset)) * cfg.img_height * cfg.img_width * 12
            if est > FRAME_CACHE_BYTES:
                self.logger.log(
                    f"[bake] real+pseudo frames ~{est >> 20} MiB exceed the "
                    "2 GiB device-cache budget; streaming uploads per step")
                self._frame_cache = None
        for _ in range(max_epochs):
            self.epoch += 1
            self.bake_epoch(pseudo_dataset)
            if self.workspace is not None:
                self.texture_dump()

    def bake_epoch(self, pseudo_dataset: Optional[FaceDataset] = None):
        """One pass over the dataset (train/baker.py:120-191). When a
        ``pseudo_dataset`` is given, each real frame is followed by a random
        pseudo frame drawn with ``np.random.default_rng(epoch)``
        (bake_full_head_epoch, train/baker.py:193-361). The per-step values
        come to the host in one fetch at the end; returns the epoch's
        stats (``last_epoch_stats``)."""
        t0 = time.perf_counter()
        rng = np.random.default_rng(self.epoch)
        pending = []
        for sample in Prefetcher(self.dataset, np.arange(len(self.dataset))):
            samples = [sample]
            if pseudo_dataset is not None and len(pseudo_dataset):
                samples.append(pseudo_dataset.sample(int(rng.integers(len(pseudo_dataset)))))
            for tag, s in zip(("real", "pseudo"), samples):
                pending.append(self.step(self._prep(s, tag)))
        vals = torch.stack(pending).cpu().numpy() if pending else np.zeros((0, 3), np.float32)
        dt = time.perf_counter() - t0
        loss, reg, ovf = vals.T
        self.epoch_losses = [float(x) for x in loss]
        n = len(vals)
        mean = float(np.mean(loss)) if n else 0.0
        overflow = int(np.sum(ovf))
        self.last_epoch_stats = {"epoch": self.epoch, "steps": n, "its": n / max(dt, 1e-9),
                                 "loss": mean, "reg_loss": float(np.mean(reg)) if n else 0.0,
                                 "overflow": overflow}
        if overflow > 0:
            self.logger.log(f"[WARN] {overflow} tile instances dropped by the binning caps "
                            "in the epoch")
        self.logger.log(f"[bake epoch {self.epoch}] loss={mean:.5f} "
                        f"({n / max(dt, 1e-9):.2f} it/s)")
        return self.last_epoch_stats

    def _prep(self, sample, tag: str = "real") -> Dict[str, torch.Tensor]:
        """A dataset sample as the step's inputs on the device; cached by
        (source, index) while the budget allows: the ground truth otherwise
        re-ships every epoch."""
        idx = sample.get("idx") if self._frame_cache is not None else None
        key = (tag, idx)
        if idx is not None and key in self._frame_cache:
            return self._frame_cache[key]
        cam_pose = np.asarray(sample["cam_pose"], np.float32)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        frame = {
            "expression": t(sample["expression"]),
            "flame_pose": t(sample["flame_pose"]),
            "R": t(cam_pose[:3, :3].T),
            "T": t(cam_pose[:3, 3]),
            "fovx": t(sample["fovx"]),
            "fovy": t(sample["fovy"]),
            "rgb": t(sample["ground_truth"]["rgb"]),
            "bg": self.bg_color,
        }
        if idx is not None:
            self._frame_cache[key] = frame
        return frame

    # ------------------------------------------------------------------
    # artifacts
    # ------------------------------------------------------------------

    @torch.no_grad()
    def textures(self):
        """(raw, activated) texture dicts [H, W, C], decoded in eval mode
        (detached: a feature map's raw texture is its parameter)."""
        raw, act = uvd.decode_textures(self.model, self.net, self.const, train=False)
        return ({k: v.detach() for k, v in raw.items()},
                {k: v.detach() for k, v in act.items()})

    def texture_dump(self):
        """Persist raw textures + a visualization grid
        (train/baker.py:406-442): ``textures/texture_epoch{n}.npz`` holds the
        raw [H, W, C] textures, ``bake_snapshots/texture_epoch{n}.png`` the
        colour, opacity and offset panels."""
        raw, act = self.textures()
        path = os.path.join(self.workspace, "textures", f"texture_epoch{self.epoch}.npz")
        np.savez(path, **{k: v.cpu().numpy() for k, v in raw.items()})
        vis = [
            sh_to_rgb(act["color"]).cpu().numpy(),
            torch.sigmoid(act["opacity"]).cpu().numpy().repeat(3, axis=-1),
            ((act["offset"] + 1) / 2).cpu().numpy().repeat(3, axis=-1),
        ]
        save_image_grid(os.path.join(self.workspace, "bake_snapshots",
                                     f"texture_epoch{self.epoch}.png"), vis)
        return path

    def export_avatar(self):
        """Write the baked avatar checkpoint (train/baker.py:444-477):
        decoded attributes in FateAvatar param/state form, to
        ``checkpoints_baked/baked.npz`` in the JAX package's layout."""
        params, state = uvd.export_avatar_params(self.model, self.net, self.const)
        if self.workspace is not None:
            save_pytree(os.path.join(self.workspace, "checkpoints_baked", "baked.npz"),
                        {"params": params, "state": state})
        return params, state


class UVEditor:
    """Texture-space editing of a baked avatar (train/baker.py:487-777).
    Works on ACTIVATED textures, like the reference editor; renders eagerly,
    one frame per call."""

    def __init__(self, model: UVDecoderModel, raw_textures: Dict[str, torch.Tensor],
                 render_cfg: RenderConfig = RenderConfig()):
        self.model = model
        self.render_cfg = render_cfg
        dev = model.uv_sample.device
        with torch.no_grad():
            self.act_textures = {
                name: uvd.activate_texture(name, torch.as_tensor(t, device=dev),
                                           model.mean_scaling, model.max_scaling)
                for name, t in raw_textures.items()
            }

    def sticker_editing(self, sticker_rgb: np.ndarray, sticker_mask: np.ndarray,
                        position=(0, 0), scale: float = 1.0):
        """Alpha-composite a sticker onto the color texture in activated SH
        space (train/baker.py:649-682). sticker_rgb [h,w,3] in [0,1],
        sticker_mask [h,w] in [0,1]; resized with PIL, as the JAX package
        does."""
        from PIL import Image

        color = self.act_textures["color"]
        tex = color.cpu().numpy()
        H, W = tex.shape[:2]
        h = max(1, int(sticker_rgb.shape[0] * scale))
        w = max(1, int(sticker_rgb.shape[1] * scale))
        rgb = np.asarray(Image.fromarray(
            (np.clip(sticker_rgb, 0, 1) * 255).astype("uint8")).resize((w, h))
        ).astype(np.float32) / 255.0
        mask = np.asarray(Image.fromarray(
            (np.clip(sticker_mask, 0, 1) * 255).astype("uint8")).resize((w, h))
        ).astype(np.float32) / 255.0

        y0, x0 = position
        y1, x1 = min(y0 + h, H), min(x0 + w, W)
        rgb = rgb[: y1 - y0, : x1 - x0]
        mask = mask[: y1 - y0, : x1 - x0, None]

        sticker_sh = rgb_to_sh(torch.from_numpy(np.ascontiguousarray(rgb))).numpy()
        region = tex[y0:y1, x0:x1]
        tex = tex.copy()
        tex[y0:y1, x0:x1] = sticker_sh * mask + region * (1 - mask)
        self.act_textures["color"] = torch.from_numpy(tex).to(color.device)
        return self.act_textures["color"]

    def style_transfer(self, style_model_path: str):
        """Run an OpenCV-dnn .t7 fast-style-transfer model on the color
        texture (train/baker.py:710-746). Requires OpenCV and the
        user-supplied model file (edit_assets/style_transfer/*.t7 in the
        reference)."""
        import cv2

        color_t = self.act_textures["color"]
        color = sh_to_rgb(color_t).cpu().numpy()
        img = (np.clip(color, 0, 1) * 255).astype(np.uint8)[:, :, ::-1]  # BGR
        net = cv2.dnn.readNetFromTorch(style_model_path)
        h, w = img.shape[:2]
        blob = cv2.dnn.blobFromImage(
            img, 1.0, (w, h), (103.939, 116.779, 123.680), swapRB=False,
            crop=False,
        )
        net.setInput(blob)
        out = net.forward()[0].transpose(1, 2, 0)
        out += (103.939, 116.779, 123.680)
        out = np.clip(out / 255.0, 0, 1)[:, :, ::-1]
        self.act_textures["color"] = rgb_to_sh(
            torch.from_numpy(np.ascontiguousarray(out.astype(np.float32)))).to(color_t.device)
        return self.act_textures["color"]

    @torch.no_grad()
    def render(self, expression, flame_pose, camera, bg_color=None):
        """The edited avatar's [H, W, 3] frame."""
        dev = self.model.uv_sample.device
        bg = self.model.avatar.bg_color if bg_color is None else bg_color
        return uvd.render_from_texture_dict(
            self.model, self.act_textures,
            torch.as_tensor(expression, dtype=torch.float32, device=dev),
            torch.as_tensor(flame_pose, dtype=torch.float32, device=dev), camera,
            bg_color=torch.as_tensor(bg, dtype=torch.float32, device=dev),
            render_cfg=self.render_cfg, activated=True)["rgb_image"]

    def run_animation(self, dataset: FaceDataset, out_path: str, fps: int = 25,
                      max_frames: Optional[int] = None):
        """Animate the edited avatar over a dataset sequence
        (train/baker.py:551-596); returns the frames as float arrays."""
        dev = self.model.uv_sample.device
        cfg = self.model.avatar.cfg
        frames = []
        n = len(dataset) if max_frames is None else min(len(dataset), max_frames)
        for i in range(n):
            s = dataset.sample(i)
            cam_pose = np.asarray(s["cam_pose"], np.float32)
            camera = make_camera(cam_pose[:3, :3].T, cam_pose[:3, 3], s["fovx"], s["fovy"],
                                 cfg.img_width, cfg.img_height, device=dev)
            frames.append(self.render(s["expression"], s["flame_pose"], camera).cpu().numpy())
        write_video(out_path, frames, fps=fps)
        return frames
