"""Gaussian maintenance: densify / prune / opacity-reset under static shapes.

Port of ``fateavatar_tpu/models/maintenance.py`` (the reference's optimizer
surgery, model/fateavatar.py:610-812). All splat arrays live at a fixed
capacity with an ``alive`` mask, so every maintenance op is a masked index
write: no tensor changes size and nothing waits on the host.

Moment bookkeeping (done by the caller, ``train/step.py``):
* densify: written slots get zero Adam moments (fateavatar.py:644-645),
* prune: surviving slots keep their moments (fateavatar.py:687-688),
* opacity reset: opacity moments zeroed for all slots (fateavatar.py:722-724).

Densify is split into a random draw (:func:`densify_draws`, from a
``torch.Generator``) and a deterministic apply (:func:`apply_densify`), so a
test can feed the apply the draws that ``jax.random`` made.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from fateavatar_tpu_torch.models.fateavatar import FateAvatarParams, FateAvatarState
from fateavatar_tpu_torch.render.splats import inverse_sigmoid

SPLAT_FIELDS = ("offset", "features_dc", "features_rest", "scaling",
                "rotation", "opacity")


def add_densification_stats(state: FateAvatarState, viewspace_grad: torch.Tensor,
                            visibility: torch.Tensor) -> FateAvatarState:
    """Accumulate screen-space gradient norms (fateavatar.py:734-737).
    ``viewspace_grad`` is the [2, N] (or [N, 2]) gradient of the probe."""
    if viewspace_grad.shape[0] == 2:
        gnorm = torch.sqrt(viewspace_grad[0] ** 2 + viewspace_grad[1] ** 2)
    else:
        gnorm = torch.linalg.norm(viewspace_grad[:, :2], dim=-1)
    vis = visibility & state.alive
    return dataclasses.replace(
        state,
        xyz_gradient_accum=state.xyz_gradient_accum + torch.where(vis, gnorm, 0.0),
        denom=state.denom + torch.where(vis, 1.0, 0.0),
    )


def update_max_radii(state: FateAvatarState, radii: torch.Tensor,
                     visibility: torch.Tensor) -> FateAvatarState:
    return dataclasses.replace(state, max_radii2d=torch.where(
        visibility & state.alive,
        torch.maximum(state.max_radii2d, radii.to(torch.float32)),
        state.max_radii2d,
    ))


def _free_slots(alive: torch.Tensor, count: int):
    """Indices of up to ``count`` dead slots (lowest first) and their
    validity. Slots past the number of dead ones are invalid and carry the
    out-of-range index ``n``, whose writes are dropped."""
    n = alive.shape[0]
    count = min(count, n)
    order = torch.argsort(alive.to(torch.uint8), stable=True)   # dead first
    slots = order[:count]
    n_free = n - torch.sum(alive)
    valid = torch.arange(count, device=alive.device) < n_free
    return torch.where(valid, slots, n), valid


def _write(dst: torch.Tensor, slots: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``dst`` with rows ``slots`` set to ``vals``; slot ``n`` (invalid) is
    dropped (JAX's ``.at[].set(mode="drop")``) without a host round trip."""
    n = dst.shape[0]
    pad = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    return pad.index_copy(0, slots, vals.to(dst.dtype))[:n]


def densify_draws(generator: torch.Generator, state: FateAvatarState,
                  increase_num: int = 1000):
    """The random part of UV densification: ``increase_num`` source splats
    drawn with probability proportional to their accumulated screen-space
    gradient (uniform over alive splats while every accumulator is 0), and a
    random barycentric point for each. Returns (src [k] int64, bary [k, 3])."""
    n = state.alive.shape[0]
    k = min(increase_num, n)
    probs = torch.where(state.alive, state.xyz_gradient_accum, 0.0)
    probs = torch.where(torch.sum(probs) > 0, probs, state.alive.to(torch.float32))
    src = torch.multinomial(probs, k, replacement=True, generator=generator)
    uvw = torch.rand((k, 3), generator=generator, device=probs.device)
    return src, uvw / torch.sum(uvw, dim=-1, keepdim=True)


def apply_densify(params: FateAvatarParams, state: FateAvatarState,
                  src: torch.Tensor, new_bary: torch.Tensor):
    """The deterministic part of UV densification (fateavatar.py:610-672):
    copy the source splats' attributes, with scale shrunk by 0.75, onto a
    new barycentric point of the same face, written into dead slots.
    Returns (params, state, touched [N] bool): ``touched`` flags the written
    slots, whose Adam moments the caller zeroes."""
    n = state.alive.shape[0]
    k = src.shape[0]
    slots, valid = _free_slots(state.alive, k)

    def write(dst, vals):
        return _write(dst, slots, vals)

    new_params = dataclasses.replace(
        params,
        offset=write(params.offset, params.offset[src]),
        features_dc=write(params.features_dc, params.features_dc[src]),
        features_rest=write(params.features_rest, params.features_rest[src]),
        scaling=write(params.scaling, params.scaling[src] + math.log(0.75)),
        rotation=write(params.rotation, params.rotation[src]),
        opacity=write(params.opacity, params.opacity[src]),
    )
    new_state = dataclasses.replace(
        state,
        face_index=write(state.face_index, state.face_index[src]),
        bary_coords=write(state.bary_coords, new_bary),
        alive=write(state.alive, valid),
        sample_flag=write(state.sample_flag, torch.ones_like(new_bary[:, 0])),
        # densify resets the stats of every splat (fateavatar.py:670-672)
        xyz_gradient_accum=torch.zeros_like(state.xyz_gradient_accum),
        denom=torch.zeros_like(state.denom),
        max_radii2d=torch.zeros_like(state.max_radii2d),
    )
    touched = write(torch.zeros((n,), dtype=torch.bool, device=valid.device), valid)
    return new_params, new_state, touched


def uv_densify(generator: torch.Generator, params: FateAvatarParams,
               state: FateAvatarState, increase_num: int = 1000):
    """Sampling-based UV densification: :func:`densify_draws` then
    :func:`apply_densify`. Returns (params, state, touched)."""
    src, bary = densify_draws(generator, state, increase_num)
    return apply_densify(params, state, src, bary)


def prune_low_opacity(params: FateAvatarParams, state: FateAvatarState,
                      min_opacity: float = 0.005) -> FateAvatarState:
    """Kill splats whose activated opacity is below ``min_opacity``
    (fateavatar.py:674-713). A mask update: dead slots stop rendering and
    become reusable by densify."""
    keep = torch.sigmoid(params.opacity[:, 0]) >= min_opacity
    return dataclasses.replace(state, alive=state.alive & keep)


def reset_opacity(params: FateAvatarParams) -> FateAvatarParams:
    """Clamp opacity to at most 0.01 (fateavatar.py:715-732). The caller
    zeroes the opacity Adam moments."""
    cur = torch.sigmoid(params.opacity)
    return dataclasses.replace(params, opacity=inverse_sigmoid(torch.clamp_max(cur, 0.01)))
