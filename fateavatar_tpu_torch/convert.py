"""Carry an avatar across from the JAX package.

Each function takes a dict of numpy arrays keyed by the field names of the
JAX package's dataclass (``FlameModel``, ``FateAvatarModel``,
``FateAvatarParams``, ``FateAvatarState``, ``MultiAdamState``,
``TrainState``) and returns the port's object on ``device``. Index fields
become int64, masks bool, the Adam step count int32, the rest float32. Fields
the port does not carry yet (FLAME's landmark embedding) are ignored.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fateavatar_tpu_torch.flame.flame import FlameModel
from fateavatar_tpu_torch.models.fateavatar import (
    FateAvatarConfig,
    FateAvatarModel,
    FateAvatarParams,
    FateAvatarState,
)
from fateavatar_tpu_torch.train.optim import MultiAdamState
from fateavatar_tpu_torch.train.step import TrainState

_INDEX_FIELDS = {"faces", "uvfaces", "face_index"}
_MASK_FIELDS = {"alive"}


def _tensor(name, value, device):
    if name in _INDEX_FIELDS:
        dtype = torch.int64
    elif name in _MASK_FIELDS:
        dtype = torch.bool
    else:
        dtype = torch.float32
    return torch.as_tensor(np.asarray(value), dtype=dtype, device=device)


def _build(cls, d: dict, device, **special):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in special:
            kwargs[f.name] = special[f.name]
        elif d.get(f.name) is not None:
            kwargs[f.name] = _tensor(f.name, d[f.name], device)
    return cls(**kwargs)


def flame_model(d: dict, device="cuda") -> FlameModel:
    return _build(FlameModel, d, device,
                  parents=tuple(int(p) for p in np.asarray(d["parents"])),
                  n_shape=int(d["n_shape"]), n_exp=int(d["n_exp"]))


def fateavatar_model(d: dict, device="cuda") -> FateAvatarModel:
    """``d["flame"]`` is a FlameModel dict, ``d["cfg"]`` a dict of
    FateAvatarConfig fields."""
    return _build(FateAvatarModel, d, device,
                  flame=flame_model(d["flame"], device),
                  cfg=FateAvatarConfig(**d["cfg"]))


def fateavatar_params(d: dict, device="cuda") -> FateAvatarParams:
    return _build(FateAvatarParams, d, device)


def fateavatar_state(d: dict, device="cuda") -> FateAvatarState:
    return _build(FateAvatarState, d, device)


def multi_adam_state(d: dict, device="cuda") -> MultiAdamState:
    """``d["mu"]`` / ``d["nu"]`` are FateAvatarParams dicts."""
    return MultiAdamState(
        mu=fateavatar_params(d["mu"], device),
        nu=fateavatar_params(d["nu"], device),
        count=torch.as_tensor(np.asarray(d["count"]), dtype=torch.int32, device=device))


def vgg_params(layers, device="cuda") -> list:
    """The JAX package's VGG16 weights, a list of (w [O,I,3,3], b [O])."""
    return [(torch.as_tensor(np.asarray(w), dtype=torch.float32, device=device),
             torch.as_tensor(np.asarray(b), dtype=torch.float32, device=device))
            for w, b in layers]


def train_state(d: dict, device="cuda", seed: int = 0) -> TrainState:
    """A whole TrainState: params, state, opt_state and step. JAX's PRNG key
    has no torch counterpart; the densify generator is seeded with
    ``seed``."""
    return TrainState(
        params=fateavatar_params(d["params"], device),
        state=fateavatar_state(d["state"], device),
        opt_state=multi_adam_state(d["opt_state"], device),
        step=int(np.asarray(d["step"])),
        generator=torch.Generator(device=device).manual_seed(seed))
