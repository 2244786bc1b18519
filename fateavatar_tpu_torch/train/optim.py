"""Per-attribute Adam with explicit moment management.

Port of ``fateavatar_tpu/train/optim.py`` (train/optim.py:11-123 of the
reference, per-group ``torch.optim.Adam``, plus the optimizer-state surgery of
model/fateavatar.py:637-728). Splat arrays have a static capacity, so the
surgery is zeroing moment rows. The update is written as plain tensor
functions in the JAX package's arithmetic order, with bias correction from
a float32 step count; ``torch.optim.Adam`` would need the same surgery and
rounds differently.

Parameters and moments are dataclasses of tensors (``FateAvatarParams``,
the baselines' params); a field may also be a dict of tensors (a network's
weights by name, as the baselines hold their MLPs), whose every tensor takes
the field's learning rate. The learning rates are a dict keyed by field
name.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class MultiAdamState:
    mu: Any              # first moments, same dataclass as the params
    nu: Any              # second moments
    count: torch.Tensor  # [] int32 steps taken


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def map_leaves(fn, *xs):
    """``fn`` over tensors, or over the values of dicts of tensors."""
    if isinstance(xs[0], dict):
        return {k: fn(*(x[k] for x in xs)) for k in xs[0]}
    return fn(*xs)


def params_device(params) -> torch.device:
    """The device of a params dataclass (its first tensor)."""
    v = next(iter(_fields(params).values()))
    return next(iter(v.values())).device if isinstance(v, dict) else v.device


# the reference's torch.optim.Adam defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class MultiAdam:
    """Adam with one learning rate per parameter field (``lr_tree``, fields
    it does not name get 0) and torch-compatible bias correction."""

    lr_tree: dict

    def init(self, params) -> MultiAdamState:
        def zeros():
            return {k: map_leaves(torch.zeros_like, v) for k, v in _fields(params).items()}

        return MultiAdamState(
            mu=dataclasses.replace(params, **zeros()),
            nu=dataclasses.replace(params, **zeros()),
            count=torch.zeros((), dtype=torch.int32, device=params_device(params)))

    def update(self, grads, opt_state: MultiAdamState, params):
        """Returns (updates, new state); apply with :func:`apply_updates`."""
        count = opt_state.count + 1
        c1 = 1.0 - B1 ** count.to(torch.float32)
        c2 = 1.0 - B2 ** count.to(torch.float32)
        mu, nu, upd = {}, {}, {}
        for name, g in _fields(grads).items():
            lr = self.lr_tree.get(name, 0.0)
            mu[name] = map_leaves(lambda m, g: B1 * m + (1 - B1) * g,
                                  getattr(opt_state.mu, name), g)
            nu[name] = map_leaves(lambda v, g: B2 * v + (1 - B2) * g * g,
                                  getattr(opt_state.nu, name), g)
            upd[name] = map_leaves(lambda m, v: -lr * (m / c1) / (torch.sqrt(v / c2) + EPS),
                                   mu[name], nu[name])
        return (dataclasses.replace(params, **upd),
                MultiAdamState(mu=dataclasses.replace(opt_state.mu, **mu),
                               nu=dataclasses.replace(opt_state.nu, **nu),
                               count=count))


def apply_updates(params, updates):
    return dataclasses.replace(params, **{
        k: map_leaves(torch.add, v, getattr(updates, k)) for k, v in _fields(params).items()})


def zero_moment_rows(opt_state: MultiAdamState, touched: torch.Tensor,
                     fields: tuple) -> MultiAdamState:
    """Zero Adam moments at ``touched`` slots ([N] bool) for the named
    fields (freshly densified splats start with zero moments,
    fateavatar.py:644-645)."""

    def zero_rows(tree):
        out = {}
        for f in fields:
            leaf = getattr(tree, f)
            mask = touched.reshape((-1,) + (1,) * (leaf.dim() - 1))
            out[f] = torch.where(mask, 0.0, leaf)
        return dataclasses.replace(tree, **out)

    return dataclasses.replace(opt_state, mu=zero_rows(opt_state.mu),
                               nu=zero_rows(opt_state.nu))


def zero_moment_field(opt_state: MultiAdamState, field: str) -> MultiAdamState:
    """Zero the whole moment tensors of one field (opacity reset,
    fateavatar.py:722-724)."""
    return dataclasses.replace(
        opt_state,
        mu=dataclasses.replace(opt_state.mu, **{
            field: map_leaves(torch.zeros_like, getattr(opt_state.mu, field))}),
        nu=dataclasses.replace(opt_state.nu, **{
            field: map_leaves(torch.zeros_like, getattr(opt_state.nu, field))}),
    )


def fateavatar_optimizers(training_cfg: dict) -> MultiAdam:
    """The reference's two optimizer groups (train/optim.py:11-37): 'gs' over
    splat attributes with per-attribute LRs and 'bs' over the FLAME
    personalization deltas, as one MultiAdam whose lr dict encodes both."""
    return MultiAdam(lr_tree=dict(
        opacity=training_cfg.get("opacity_lr", 0.05),
        offset=training_cfg.get("offset_lr", 0.0016),
        features_dc=training_cfg.get("feature_dc_lr", 0.0025),
        features_rest=training_cfg.get("feature_dc_lr", 0.0025) / 20.0,
        rotation=training_cfg.get("rotation_lr", 0.001),
        scaling=training_cfg.get("scaling_lr", 0.005),
        delta_shapedirs=training_cfg.get("delta_shapedirs_lr", 1e-5),
        delta_posedirs=training_cfg.get("delta_posedirs_lr", 1e-5),
        delta_vertex=training_cfg.get("delta_vertex_lr", 1e-4),
    ))
