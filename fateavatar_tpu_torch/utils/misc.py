"""Misc utilities (tools/util.py equivalents).

Port of ``fateavatar_tpu/utils/misc.py``."""

from __future__ import annotations

import functools
import os
import random
import shutil
import time

import numpy as np
import torch


def seed_everything(seed: int):
    """tools/util.py:55 — python, numpy and torch seeding."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def file_backup(workspace: str, source_dirs=("fateavatar_tpu_torch", "configs"),
                repo_root: str = "."):
    """Snapshot source files into <workspace>/archive for reproducibility
    (tools/util.py:86-100). The kernels' build directory is skipped."""
    archive = os.path.join(workspace, "archive")
    for d in source_dirs:
        src = os.path.join(repo_root, d)
        if not os.path.isdir(src):
            continue
        for root, dirs, files in os.walk(src):
            dirs[:] = [x for x in dirs if x not in ("__pycache__", "_build")]
            rel = os.path.relpath(root, repo_root)
            dst = os.path.join(archive, rel)
            os.makedirs(dst, exist_ok=True)
            for f in files:
                if f.endswith((".py", ".yaml", ".md")):
                    shutil.copy2(os.path.join(root, f), os.path.join(dst, f))


def colorize_weights_map(weights: np.ndarray) -> np.ndarray:
    """Scalar map [H, W] in [0,1] -> blue->red heat RGB (tools/util.py:151)."""
    w = np.clip(np.asarray(weights, np.float32), 0, 1)
    r = np.clip(1.5 - np.abs(4 * w - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * w - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * w - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)


def get_bg_color(name, device="cuda"):
    """'white' | 'black' | 'random' -> RGB (tools/util.py:138)."""
    if name == "white":
        return torch.ones(3, device=device)
    if name == "black":
        return torch.zeros(3, device=device)
    if name == "random":
        return torch.as_tensor(np.random.random(3), dtype=torch.float32, device=device)
    raise ValueError(name)


def measure_fps(fn):
    """Decorator printing wall-clock FPS (tools/util.py:235). Work queued on
    the card is not waited for: synchronize inside ``fn`` to time it."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        print(f"[fps] {fn.__name__}: {1.0 / max(dt, 1e-9):.2f} fps ({dt*1e3:.2f} ms)")
        return out

    return wrapper
