"""Checkpoint save / restore with ``torch.save``.

Counterpart of ``fateavatar_tpu/train/checkpoints.py`` (Orbax there). A
checkpoint is one file ``ckpt_<step>.pt`` holding a tree of dicts, tensors
and numbers — for an avatar ``{params, state, epoch, global_step}`` with
params and state as field-name dicts; the Trainer's adds the Adam moments
and count, the step counter and the densify generator's state, so a resumed
run continues where training stopped. Splat arrays have static capacity, so
no per-model surgery is needed. The last ``max_keep`` files are kept, like
the reference (max_keep_ckpt=2).

:func:`save_pytree` / :func:`load_pytree` write and read the JAX package's
single-file ``.npz`` snapshots (texture dumps, the baked avatar), so each
package reads the other's files.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Optional

import numpy as np
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


def _leaves(tree: Any) -> list:
    """The leaves of ``tree`` in the JAX package's flatten order: a dict's
    values by sorted key, a dataclass's fields in declaration order; None
    holds no leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree) for leaf in _leaves(getattr(tree, f.name))]
    if tree is None:
        return []
    return [tree]


def _rebuild(template: Any, leaves) -> Any:
    """``template`` with its leaves taken in order from the iterator
    ``leaves``."""
    if isinstance(template, dict):
        built = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: built[k] for k in template}
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    if template is None:
        return None
    value = next(leaves)
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(value, dtype=template.dtype, device=template.device)
    return value


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any):
    """One ``.npz`` of a tree of dicts, dataclasses and arrays: the
    leaves as ``leaf_{i}`` in the JAX package's flatten order and a
    ``__treedef__`` entry describing the structure (read by neither
    package's :func:`load_pytree`)."""
    leaves = _leaves(tree)
    desc = f"{len(leaves)} leaves: " + ", ".join(str(tuple(_numpy(x).shape)) for x in leaves)
    np.savez(path, __treedef__=np.frombuffer(desc.encode(), dtype=np.uint8),
             **{f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(leaves)})


def load_pytree(path: str, template: Any) -> Any:
    """The tree saved at ``path`` in the shape of ``template``: a tensor
    leaf of the template comes back as a tensor of its dtype on its device,
    any other leaf as the stored numpy array."""
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(_leaves(template)))]
    return _rebuild(template, iter(leaves))
