"""Checkpoint save / restore with ``torch.save``.

Counterpart of ``fateavatar_tpu/train/checkpoints.py`` (Orbax there). A
checkpoint is one file ``ckpt_<step>.pt`` holding a tree of dicts, tensors
and numbers — for an avatar ``{params, state, epoch, global_step}`` with
params and state as field-name dicts; the Trainer's adds the Adam moments
and count, the step counter and the densify generator's state, so a resumed
run continues where training stopped. Splat arrays have static capacity, so
no per-model surgery is needed. The last ``max_keep`` files are kept, like
the reference (max_keep_ckpt=2).
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.max_keep = max_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:09d}.pt")

    def steps(self) -> list:
        found = (_NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, tree: Any):
        tmp = self._path(step) + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, self._path(step))   # a crash never leaves half a file
        for old in self.steps()[:-self.max_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        # weights_only: tensors, numbers and containers — no pickled code
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)
