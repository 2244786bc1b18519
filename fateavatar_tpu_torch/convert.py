"""Carry an avatar across from the JAX package.

Each function takes a dict of numpy arrays keyed by the field names of the
JAX package's dataclass (``FlameModel``, ``FateAvatarModel``,
``FateAvatarParams``, ``FateAvatarState``, ``MultiAdamState``,
``TrainState``, ``UVDecoderModel``) and returns the port's object on
``device``. Index fields become int64, masks bool, the Adam step count
int32, the rest float32. Fields the port does not carry yet (FLAME's
landmark embedding) are ignored. The baking networks' flax variables
(``{"params", "batch_stats"}``, nested dicts keyed by flax's auto-names)
load into the port's ``nn.Module``s through :func:`load_flax_net`.
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
from fateavatar_tpu_torch.models.uv_decoder import UVDecoderModel
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


def uv_decoder_model(d: dict, avatar: FateAvatarModel, device="cuda") -> UVDecoderModel:
    """``d`` a UVDecoderModel dict (its ``avatar`` field not read: the
    port's ``avatar`` is given), ``bake_attribute`` and ``decode_type``
    kept."""
    return _build(UVDecoderModel, d, device, avatar=avatar,
                  decode_type=d["decode_type"], bake_attribute=tuple(d["bake_attribute"]))


# flax's auto-names inside a DoubleConv -> the port's
_DOUBLE_CONV = {"Conv_0": "conv1", "BatchNorm_0": "bn1", "Conv_1": "conv2",
                "BatchNorm_1": "bn2"}
# flax leaf names -> the port's, by collection
_LEAVES = {("params", "kernel"): "weight", ("params", "bias"): "bias",
           ("params", "scale"): "weight", ("batch_stats", "mean"): "running_mean",
           ("batch_stats", "var"): "running_var", ("params", "optim_texture"): "texture"}


def _flax_module_path(path: tuple) -> list:
    """A flax module path (``("Down_0", "DoubleConv_0", "Conv_1")``) -> the
    port's attribute names (``["down1", "conv", "conv2"]``)."""
    out = []
    for i, seg in enumerate(path):
        kind, _, k = seg.rpartition("_")
        if i > 0 and path[i - 1].startswith("DoubleConv_"):
            out.append(_DOUBLE_CONV[seg])
        elif kind == "DoubleConv":
            out.append("inc" if i == 0 else "conv")
        elif kind in ("Down", "Up", "UpNoSkip"):
            out.append(f"{'down' if kind == 'Down' else 'up'}{int(k) + 1}")
        elif seg == "Conv_0" and i == 0:
            out.append("outc")
        else:
            raise KeyError(f"unknown flax module {'/'.join(path)}")
    return out


def flax_net_state(variables: dict) -> dict:
    """flax ``{"params": ..., "batch_stats": ...}`` of ``UNet``,
    ``UNetDecoder`` or ``FeatureMap`` (nested dicts of arrays) -> the port
    module's ``state_dict`` (numpy): HWIO kernels become OIHW weights."""
    state = {}

    def walk(tree, collection, path):
        for name, v in tree.items():
            if isinstance(v, dict):
                walk(v, collection, path + (name,))
                continue
            arr = np.asarray(v, np.float32)
            if (collection, name) == ("params", "kernel"):
                arr = arr.transpose(3, 2, 0, 1)
            key = _flax_module_path(path) + [_LEAVES[(collection, name)]]
            state[".".join(key)] = arr

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection) or {}, collection, ())
    return state


def load_flax_net(net, variables: dict):
    """Load flax variables (:func:`flax_net_state`) into the port's
    network ``net`` in place; every parameter and statistic must be
    given."""
    dev = next(net.parameters()).device
    sd = {k: torch.tensor(v, device=dev) for k, v in flax_net_state(variables).items()}
    net.load_state_dict(sd, strict=True)
    return net
