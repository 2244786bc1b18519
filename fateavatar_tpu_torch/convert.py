"""Carry an avatar across from the JAX package.

Each function takes a dict of numpy arrays keyed by the field names of the
JAX package's dataclass (``FlameModel``, ``FateAvatarModel``,
``FateAvatarParams``, ``FateAvatarState``, ``MultiAdamState``,
``TrainState``, ``UVDecoderModel``, the baselines' models, params and
states, ``BaselineTrainState``; ``LpipsParams`` by its attributes) and
returns the port's object on
``device``. Index fields become int64, masks bool, the Adam step count
int32, the rest float32. Fields the port does not carry yet (FLAME's
landmark embedding) are ignored. Flax variables (``{"params",
"batch_stats"}``, nested dicts keyed by flax's auto-names) load into the
port's ``nn.Module``s through :func:`load_flax_net`: the baking networks'
and the baselines' MLPs (``Dense_k`` -> ``dense.k``); a baseline's params
hold its networks' weights as the dict :func:`flax_net_state` gives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fateavatar_tpu_torch.flame.flame import FlameModel
from fateavatar_tpu_torch.models.baselines import flashavatar as FA
from fateavatar_tpu_torch.models.baselines import gaussianavatars as GA
from fateavatar_tpu_torch.models.baselines import monogaussianavatar as MA
from fateavatar_tpu_torch.models.baselines import splattingavatar as SA
from fateavatar_tpu_torch.models.fateavatar import (
    FateAvatarConfig,
    FateAvatarModel,
    FateAvatarParams,
    FateAvatarState,
)
from fateavatar_tpu_torch.models.uv_decoder import UVDecoderModel
from fateavatar_tpu_torch.train.lpips import LpipsParams, lpips_params_from_arrays
from fateavatar_tpu_torch.train.optim import MultiAdamState
from fateavatar_tpu_torch.train.baseline_steps import BaselineTrainState
from fateavatar_tpu_torch.train.step import TrainState

_INDEX_FIELDS = {"faces", "uvfaces", "face_index", "binding", "sample_fidxs",
                 "face_adjacency"}
_MASK_FIELDS = {"alive", "visible"}


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


def lpips_params_from_jax(params, device="cuda") -> LpipsParams:
    """The JAX package's ``LpipsParams`` (``backbone``, ``convs`` [(w, b)],
    ``lins``; arrays of any kind numpy reads) as the port's."""
    return lpips_params_from_arrays(
        str(params.backbone), [(np.asarray(w), np.asarray(b)) for w, b in params.convs],
        [np.asarray(lin) for lin in params.lins], device)


def verbatim_state_dict(params: dict) -> dict:
    """A JAX param dict (name -> array) as float32 tensors under the same
    names and layouts: the state_dict of the port's GFPGAN
    (``completion.restoration``) and MODNet (``completion.matting``), whose
    JAX params are already in their checkpoints' layout."""
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in params.items()}


gfpgan_state_dict = modnet_state_dict = verbatim_state_dict


def bisenet_state_dict(params: dict) -> dict:
    """The JAX package's BiSeNet param dict as the state_dict of the port's
    ``completion.segmentation.BiSeNet``: conv kernels HWIO -> OIHW, the
    rest verbatim."""
    return verbatim_state_dict({k: np.asarray(v).transpose(3, 2, 0, 1) if np.ndim(v) == 4 else v
                           for k, v in params.items()})


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


# ---------------------------------------------------------------------------
# the baselines: models, params, states and their train state
# ---------------------------------------------------------------------------

def _net_dict(tree, device) -> dict:
    """A flax param tree (``Dense_k`` -> kernel / bias) as the port module's
    weights by name."""
    return {k: torch.tensor(v, device=device)
            for k, v in flax_net_state({"params": tree}).items()}


_BASELINES = {
    # family -> (model class, its config class, params class, state class)
    "gaussianavatars": (GA.GAModel, GA.GAConfig, GA.GAParams, GA.GAState),
    "flashavatar": (FA.FlashModel, FA.FlashConfig, FA.FlashParams, None),
    "splattingavatar": (SA.SplatModel, SA.SplatConfig, SA.SplatParams, SA.SplatState),
    "monogaussianavatar": (MA.MonoModel, MA.MonoConfig, MA.MonoParams, MA.MonoState),
}


def baseline_model(family: str, d: dict, device="cuda"):
    """``d["flame"]`` a FlameModel dict, ``d["cfg"]`` a dict of the family's
    config fields."""
    model_cls, cfg_cls, _, _ = _BASELINES[family]
    return _build(model_cls, d, device, flame=flame_model(d["flame"], device),
                  cfg=cfg_cls(**d["cfg"]))


def baseline_params(family: str, d: dict, device="cuda"):
    """The networks' fields (FlashAvatar's deformer, MonoGaussianAvatar's
    four) are flax param trees."""
    cls = _BASELINES[family][2]
    nets = {f.name: _net_dict(d[f.name], device) for f in dataclasses.fields(cls)
            if isinstance(d.get(f.name), dict)}
    return _build(cls, d, device, **nets)


def baseline_state(family: str, d, device="cuda"):
    cls = _BASELINES[family][3]
    return None if cls is None or d is None else _build(cls, d, device)


def baseline_train_state(family: str, d: dict, device="cuda", seed: int = 0):
    """A ``BaselineTrainState`` from the JAX package's: params, state,
    ``MultiAdamState`` (moments shaped like the params) and step. JAX's PRNG
    key has no torch counterpart; the draws' generator is seeded with
    ``seed``."""
    o = d["opt_state"]
    return BaselineTrainState(
        params=baseline_params(family, d["params"], device),
        state=baseline_state(family, d.get("state"), device),
        opt_state=MultiAdamState(
            mu=baseline_params(family, o["mu"], device),
            nu=baseline_params(family, o["nu"], device),
            count=torch.as_tensor(np.asarray(o["count"]), dtype=torch.int32, device=device)),
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
        elif kind == "Dense" and i == 0:      # the baselines' MLPs
            out.append(f"dense.{int(k)}")
        else:
            raise KeyError(f"unknown flax module {'/'.join(path)}")
    return out


def flax_net_state(variables: dict) -> dict:
    """flax ``{"params": ..., "batch_stats": ...}`` of ``UNet``,
    ``UNetDecoder``, ``FeatureMap`` or a baseline's MLP (nested dicts of
    arrays) -> the port module's ``state_dict`` (numpy): HWIO kernels become
    OIHW weights, [in, out] Dense kernels [out, in]."""
    state = {}

    def walk(tree, collection, path):
        for name, v in tree.items():
            if isinstance(v, dict):
                walk(v, collection, path + (name,))
                continue
            arr = np.asarray(v, np.float32)
            if (collection, name) == ("params", "kernel"):
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
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
