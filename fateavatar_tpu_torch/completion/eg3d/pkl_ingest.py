"""Standalone ingestion of official StyleGAN-family network pickles.

Port of ``fateavatar_tpu/completion/eg3d/pkl_ingest.py`` (host code, copied).
The reference loads SphereHead/PanoHead checkpoints with
``legacy.load_network_pkl`` (train/completion.py:592), which unpickles
``torch_utils.persistence``-wrapped ``nn.Module`` objects: each pickle
embeds the SOURCE CODE of the network classes and reconstructs live modules
by executing it. That requires the original repos and runs arbitrary
embedded code.

This module reads the same ``.pkl`` files WITHOUT executing anything: a
restricted unpickler that

* resolves only an allowlist of globals (tensor/ndarray reconstruction,
  containers, and stubbed ``dnnlib.EasyDict`` /
  ``torch_utils.persistence._reconstruct_persistent_obj``);
* replaces every persistence-wrapped module with an inert record holding
  its pickled ``meta`` (class name + attribute state); the embedded
  ``module_src`` is never compiled or executed;
* then walks ``_parameters`` / ``_buffers`` / ``_modules`` of the stubbed
  object graph to reassemble the exact ``G_ema.state_dict()`` mapping, which
  :func:`load_eg3d_from_pkl` loads into the port's :class:`EG3DGenerator`.

Works on the original upstream pickles and on ``fintuned_generator.pkl``
files written by the reference's own PTI stage (train/completion.py:655).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = [
    "RestrictedNetworkUnpickler", "load_network_pkl_tensors",
    "load_eg3d_from_pkl", "PersistentStub",
]


class EasyDictStub(dict):
    """Attribute-access dict standing in for ``dnnlib.EasyDict``."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value


class PersistentStub:
    """Inert replacement for a ``torch_utils.persistence`` module: keeps
    the pickled ``meta`` (class_name, state) and ignores the embedded
    source code entirely."""

    def __init__(self, meta=None):
        self.meta = meta

    # persistence pickles via __reduce__ ->
    # (_reconstruct_persistent_obj, (meta,)); some variants instead pickle
    # the instance directly and restore state through __setstate__.
    def __setstate__(self, state):
        if self.meta is None:
            self.meta = {}
        self.meta["state"] = state

    @property
    def class_name(self) -> str:
        m = self.meta or {}
        return str(m.get("class_name", "?"))

    @property
    def state(self) -> dict:
        m = self.meta or {}
        s = m.get("state", {})
        return s if isinstance(s, dict) else {}

    def __repr__(self):
        return f"PersistentStub({self.class_name})"


def _reconstruct_persistent_obj(meta) -> PersistentStub:
    return PersistentStub(dict(meta))


def _torch():
    import torch
    return torch


def _load_storage_from_bytes(b: bytes):
    """``torch.storage._load_from_bytes`` under ``weights_only=True``: torch's
    own function unpickles the storage's bytes with no restriction, so a
    file could nest arbitrary code there."""
    import io
    return _torch().load(io.BytesIO(b), weights_only=True)


def _numpy_multiarray():
    """numpy's multiarray module: ``numpy._core`` (numpy 2) first, so that
    the deprecated ``numpy.core`` alias is not touched where it warns."""
    try:
        import numpy._core.multiarray as m
    except ImportError:     # numpy 1.x
        import numpy.core.multiarray as m
    return m


class RestrictedNetworkUnpickler(pickle.Unpickler):
    """Unpickler that admits only tensor/container reconstruction globals.

    Anything else, including the persistence machinery's attempt to
    import the embedded network source, resolves to an inert stub or
    raises ``pickle.UnpicklingError``.
    """

    _STUBS = {
        ("dnnlib", "EasyDict"): EasyDictStub,
        ("dnnlib.util", "EasyDict"): EasyDictStub,
        ("torch_utils.persistence", "_reconstruct_persistent_obj"):
            _reconstruct_persistent_obj,
    }

    _TORCH_UTILS = (
        "_rebuild_tensor", "_rebuild_tensor_v2", "_rebuild_parameter",
        "_rebuild_sparse_tensor",
    )

    def find_class(self, module: str, name: str):
        key = (module, name)
        if key in self._STUBS:
            return self._STUBS[key]
        if module == "_codecs" and name == "encode":
            import _codecs
            return _codecs.encode        # protocol-2 bytes/str reconstruction
        if module == "collections" and name in ("OrderedDict", "defaultdict"):
            import collections
            return getattr(collections, name)
        if module == "builtins" and name in ("set", "frozenset", "slice",
                                             "complex", "bytearray"):
            import builtins
            return getattr(builtins, name)
        if module in ("numpy.core.multiarray", "numpy._core.multiarray") \
                and name in ("_reconstruct", "scalar"):
            return getattr(_numpy_multiarray(), name)
        if module == "numpy" and name in ("ndarray", "dtype"):
            return getattr(np, name)
        if module == "torch._utils" and name in self._TORCH_UTILS:
            return getattr(_torch()._utils, name)
        if module == "torch.storage" and name == "_load_from_bytes":
            return _load_storage_from_bytes
        if module == "torch" and (name.endswith("Storage")
                                  or name in ("Size", "device", "dtype")
                                  or name.startswith(("int", "float", "uint",
                                                      "bfloat", "bool",
                                                      "complex"))):
            return getattr(_torch(), name)
        if module == "torch.serialization" and name == "_get_layout":
            return _torch().serialization._get_layout
        # any persistence-wrapped class pickled by value-name (older
        # variants): stub it rather than import the source repo
        if module.startswith(("torch_utils.", "training.", "dnnlib")):
            return PersistentStub
        raise pickle.UnpicklingError(
            f"blocked global {module}.{name} — not needed to extract "
            "tensors from a network pkl")

    def persistent_load(self, pid):
        # torch's zipfile-format persistent ids: ('storage', cls, key,
        # location, numel). Plain network pkls don't use this path; a
        # combined loader (torch.load) handles it, so refuse clearly.
        raise pickle.UnpicklingError(
            "persistent ids (torch zipfile checkpoints) are not plain "
            "network pkls — load with torch.load(weights_only=True) and "
            "the state-dict converters instead")


def _to_numpy(v) -> Optional[np.ndarray]:
    if isinstance(v, np.ndarray):
        return v
    if hasattr(v, "detach"):   # torch.Tensor / Parameter
        return v.detach().cpu().numpy()
    return None


def _walk_module(obj: Any, prefix: str, out: Dict[str, np.ndarray]):
    """Reassemble ``state_dict()`` from a stubbed module graph."""
    if isinstance(obj, PersistentStub):
        state = obj.state
    elif hasattr(obj, "_parameters") or hasattr(obj, "_modules"):
        state = obj.__dict__           # a plain (allowlisted) nn.Module
    elif isinstance(obj, dict):
        state = obj
    else:
        return
    for group in ("_parameters", "_buffers"):
        for name, v in (state.get(group) or {}).items():
            arr = _to_numpy(v)
            if arr is not None:
                out[prefix + name] = arr
    for name, sub in (state.get("_modules") or {}).items():
        if sub is not None:
            _walk_module(sub, f"{prefix}{name}.", out)


def _module_attrs(obj: Any) -> dict:
    """Non-tensor attributes of a stubbed module (init args,
    rendering_kwargs, neural_rendering_resolution, ...)."""
    state = obj.state if isinstance(obj, PersistentStub) else (
        obj if isinstance(obj, dict) else getattr(obj, "__dict__", {}))
    skip = {"_parameters", "_buffers", "_modules", "_non_persistent_buffers_set",
            "_state_dict_hooks", "_load_state_dict_pre_hooks", "training",
            "_backward_hooks", "_forward_hooks", "_forward_pre_hooks",
            "_state_dict_pre_hooks", "_load_state_dict_post_hooks",
            "_backward_pre_hooks", "_is_full_backward_hook"}
    return {k: v for k, v in state.items()
            if k not in skip and _to_numpy(v) is None}


def load_network_pkl_tensors(path: str):
    """Read a StyleGAN-family network pkl; return
    ``{entry: (state_dict, attrs)}`` for every module entry (G, D, G_ema,
    ...) without executing any embedded code."""
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head[:2] == b"PK":
            raise ValueError(
                f"{path} is a zip archive (torch.save format), not a "
                "network pkl — use the state-dict converters")
        data = RestrictedNetworkUnpickler(f).load()
    if not isinstance(data, dict):
        data = {"G_ema": data}
    out = {}
    for entry, obj in data.items():
        if isinstance(obj, (PersistentStub,)) or hasattr(obj, "_modules"):
            sd: Dict[str, np.ndarray] = {}
            _walk_module(obj, "", sd)
            out[entry] = (sd, _module_attrs(obj))
    if not out:
        raise ValueError(f"{path}: no network modules found "
                         f"(top-level keys: {list(data)[:8]})")
    return out


def load_eg3d_from_pkl(path: str, entry: str = "G_ema", cfg=None, device="cuda"
                       ) -> Tuple[Any, Any, dict]:
    """Official-pkl equivalent of ``legacy.load_network_pkl`` +
    ``G_ema.state_dict()`` (reference train/completion.py:592): returns
    ``(generator, config, attrs)``, the port's :class:`EG3DGenerator` on
    ``device`` holding the pickle's tensors, the config (inferred from the
    shapes unless given) and the module's non-tensor attributes."""
    from fateavatar_tpu_torch.completion.eg3d.convert import (
        _PREFIXES, generator_from_dict, infer_config,
    )

    nets = load_network_pkl_tensors(path)
    if entry not in nets:
        raise KeyError(f"{path} has entries {sorted(nets)}; no {entry!r}")
    sd, attrs = nets[entry]
    raw = {k: v for k, v in sd.items() if k.startswith(_PREFIXES)}
    if not raw:
        raise ValueError(f"{path}:{entry} has no EG3D generator tensors "
                         f"(got {sorted(sd)[:8]}...)")
    if cfg is None:
        cfg = infer_config(raw)
    return generator_from_dict(raw, cfg, device), cfg, attrs
