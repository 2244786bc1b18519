"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and makes the mix's inputs from the seed.

Two kinds of mix:

* ``"subject"``: a monocular training subject (INSTA-like or IMAvatar-like
  by its code widths). ``frames`` frames of ``img_res``: a head-like
  silhouette on the white background, filled with band-limited texture
  (a sum of ``texture_waves`` random plane waves per colour channel),
  jittered per frame; its FLAME codes (``expr_std``, ``pose_std``) and a
  camera on a yaw arc of ``yaw_range`` radians at ``camera_distance``.
  The frames are made on the device in plain torch, as uint8, in batches.
* ``"clips"``: driving clips for reenactment, served back to back by one
  client. Their lengths are a fixed set, log-spaced over
  [``clip_frames_min``, ``clip_frames_max``] (``n_lengths`` of them; all
  equal where the two bounds are), in an order drawn from the seed, so
  every seed serves the same work; the
  expressions (``expr_std``), pose jitter (``pose_std``) and the canonical
  delta (``delta_std``) are drawn from the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def subject(mix: dict, seed: int, device) -> dict:
    """The subject's frames and codes: ``rgb`` uint8 [n, H, W, 3] and
    ``mask`` uint8 [n, H, W] on ``device``; host ``expression`` [n, n_exp],
    ``flame_pose`` [n, 15], ``world_mats`` [n, 4, 4] (world -> view), ``fov``."""
    n = int(mix["frames"])
    h, w = mix["img_res"]
    rng = np.random.default_rng(seed)
    expression = (rng.normal(size=(n, mix["n_exp"])) * mix["expr_std"]).astype(np.float32)
    pose = (rng.normal(size=(n, 15)) * mix["pose_std"]).astype(np.float32)
    d = float(mix["camera_distance"])
    wm = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    ang = (np.arange(n) / max(n, 1) - 0.5) * float(mix["yaw_range"])
    wm[:, 0, 0] = wm[:, 2, 2] = np.cos(ang)
    wm[:, 0, 2] = np.sin(ang)
    wm[:, 2, 0] = -np.sin(ang)
    wm[:, 2, 3] = d
    rgb, mask = head_frames(mix, seed, n, h, w, device)
    return {"rgb": rgb, "mask": mask, "expression": expression, "flame_pose": pose,
            "world_mats": wm, "fov": float(mix["fov"])}


def head_frames(mix: dict, seed: int, n: int, h: int, w: int, device, batch: int = 16):
    """``n`` uint8 frames [n, H, W, 3] and masks [n, H, W]: an ellipse of the
    projected head's size, shifted per frame by up to ``jitter_px``, filled
    with ``texture_waves`` plane waves per channel (wavelengths down to
    ``min_wavelength_px``), on white."""
    gen = torch.Generator(device=device).manual_seed(seed)
    k = int(mix["texture_waves"])
    focal = w / (2.0 * math.tan(mix["fov"] / 2.0))
    radius = focal * mix["head_radius_m"] / mix["camera_distance"]
    freq = torch.rand((3, k), generator=gen, device=device) * (2 * math.pi / mix["min_wavelength_px"])
    theta = torch.rand((3, k), generator=gen, device=device) * (2 * math.pi)
    amp = torch.rand((3, k), generator=gen, device=device) / k
    base = 0.25 + 0.5 * torch.rand((3,), generator=gen, device=device)
    shift = (torch.rand((n, 2), generator=gen, device=device) * 2 - 1) * mix["jitter_px"]
    phase = torch.rand((n, 3, k), generator=gen, device=device) * mix["phase_jitter"]
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    kx, ky = freq * torch.cos(theta), freq * torch.sin(theta)               # [3, k]
    rgb = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    mask = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    for s in range(0, n, batch):
        e = min(n, s + batch)
        cx = (w - 1) / 2 + shift[s:e, 0, None, None]
        cy = (h - 1) / 2 + shift[s:e, 1, None, None]
        inside = ((xs - cx) / radius) ** 2 + ((ys - cy) / (1.15 * radius)) ** 2 <= 1.0
        arg = (kx[None, :, :, None, None] * xs + ky[None, :, :, None, None] * ys
               + phase[s:e, :, :, None, None])                               # [b, 3, k, H, W]
        tex = base[None, :, None, None] + (amp[None, :, :, None, None] * torch.sin(arg)).sum(2)
        img = torch.where(inside[:, None], tex.clamp(0, 1), 1.0)
        rgb[s:e] = torch.round(img * 255).to(torch.uint8).permute(0, 2, 3, 1)
        mask[s:e] = inside.to(torch.uint8)
    return rgb, mask


def clip_lengths(mix: dict, seed: int) -> list:
    """The fixed set of clip lengths, log-spaced, in the seed's order."""
    lo, hi, k = int(mix["clip_frames_min"]), int(mix["clip_frames_max"]), int(mix["n_lengths"])
    lengths = [int(round(lo * (hi / lo) ** ((i + 0.5) / k))) for i in range(k)]
    order = np.random.default_rng(seed).permutation(k)
    return [lengths[i] for i in order]


def clips(mix: dict, seed: int) -> dict:
    """The clips of one run as host arrays: ``lengths`` (served in this
    order, cycled), ``expression`` [sum, n_exp], ``flame_pose`` [sum, 15]
    (each clip a slice of them), ``delta`` [n_exp], the front camera's
    ``camera_distance`` and ``fov``."""
    lengths = clip_lengths(mix, seed)
    total = sum(lengths)
    rng = np.random.default_rng(seed)
    return {
        "lengths": lengths,
        "starts": np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64),
        "expression": (rng.normal(size=(total, mix["n_exp"])) * mix["expr_std"]).astype(np.float32),
        "flame_pose": (rng.normal(size=(total, 15)) * mix["pose_std"]).astype(np.float32),
        "delta": (rng.normal(size=(mix["n_exp"],)) * mix["delta_std"]).astype(np.float32),
        "camera_distance": float(mix["camera_distance"]),
        "fov": float(mix["fov"]),
    }
