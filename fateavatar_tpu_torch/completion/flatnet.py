"""Networks whose tensors are addressed by their flat checkpoint names.

The JAX package keeps each completion network (EG3D, GFPGAN, MODNet,
BiSeNet) as a flat ``{torch_param_name: array}`` dict and its forward
indexes by name. :class:`FlatNet` holds such a dict as an ``nn.Module``
tree, so ``state_dict()`` keys are those names and ``load_state_dict``
reads the public checkpoints; :meth:`FlatNet.params` gives back the flat
dict the forward functions take.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

Params = Dict[str, torch.Tensor]
# name -> (shape, init): init a float (randn times it), "zeros" or "ones"
Spec = Dict[str, Tuple[Tuple[int, ...], object]]


class FlatNet(nn.Module):
    """``tensors`` (name -> tensor) registered under their dotted names;
    a name for which ``is_buffer`` holds becomes a buffer, the rest
    parameters."""

    def __init__(self, tensors: Params, is_buffer: Callable[[str], bool] = lambda n: False):
        super().__init__()
        for name, value in tensors.items():
            *path, leaf = name.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            if is_buffer(name):
                mod.register_buffer(leaf, value.detach().clone())
            else:
                mod.register_parameter(leaf, nn.Parameter(value.detach().clone()))

    def params(self) -> Params:
        """The flat name -> tensor dict the forward functions take."""
        return {**dict(self.named_parameters()), **dict(self.named_buffers())}


def is_bn_stat(name: str) -> bool:
    """A BatchNorm running statistic: held as a buffer, not a parameter."""
    return name.endswith(("running_mean", "running_var"))


def batch_norm(p: Params, prefix: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm of NCHW ``x`` from ``prefix``'s weight, bias and
    running statistics, folded into one scale and shift."""
    inv = p[f"{prefix}.weight"] * torch.rsqrt(p[f"{prefix}.running_var"] + eps)
    shift = p[f"{prefix}.bias"] - p[f"{prefix}.running_mean"] * inv
    return x * inv[:, None, None] + shift[:, None, None]


def zeros_from_spec(spec: Spec, device) -> Params:
    return {k: torch.zeros(shape, device=device) for k, (shape, _) in spec.items()}


def random_from_spec(spec: Spec, generator: torch.Generator, device) -> Params:
    """Seeded draws in the spec's order: ``randn * init`` for a float init,
    else zeros or ones."""
    out: Params = {}
    for name, (shape, init) in spec.items():
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.randn(shape, generator=generator, device=device) * init
    return out


def load_flat(net: FlatNet, raw: Dict[str, np.ndarray], what: str) -> list:
    """Load ``raw`` (name -> array) into ``net`` by name: every tensor of the
    net must be there at its shape (a missing or misshapen one raises,
    naming it). Returns the sorted names of ``raw`` the net does not hold."""
    own = net.state_dict()
    missing = sorted(set(own) - set(raw))
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {len(missing)} tensors: {missing[:5]}")
    for k, v in own.items():
        if tuple(np.shape(raw[k])) != tuple(v.shape):
            raise ValueError(f"{what}: {k} expected {tuple(v.shape)}, got {np.shape(raw[k])}")
    net.load_state_dict({k: torch.as_tensor(np.asarray(raw[k], np.float32)) for k in own})
    return sorted(set(raw) - set(own))
