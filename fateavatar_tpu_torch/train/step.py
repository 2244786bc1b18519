"""The training step.

Port of ``fateavatar_tpu/train/step.py`` (the body of train/iteration.py:21-89
of the reference): forward with the screen-space probe, loss, backward
(``torch.autograd.grad`` over the parameters and the probe), densification
statistics, the per-attribute Adam update, then densify / prune /
opacity-reset when their intervals come due. The step counter lives on the
host, so the intervals are plain Python ``if``s; the loss and every other
aux value stay on the device, so a step never waits on the card.

:func:`make_inplace_step` is the same step in place, on static buffers, for
capture in a CUDA graph (the body of the JAX package's scan epoch).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from fateavatar_tpu_torch.models import maintenance
from fateavatar_tpu_torch.models.fateavatar import (
    FateAvatarModel,
    FateAvatarParams,
    FateAvatarState,
    fateavatar_forward,
)
from fateavatar_tpu_torch.ops.camera import Camera
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train.losses import as_float_rgb
from fateavatar_tpu_torch.train.optim import (
    MultiAdam,
    MultiAdamState,
    apply_updates,
    zero_moment_field,
    zero_moment_rows,
)

SPLAT_FIELDS = maintenance.SPLAT_FIELDS


@dataclass
class Frame:
    """One training sample (the collate output of train/dataset.py:283-319)."""

    expression: torch.Tensor   # [n_exp]
    flame_pose: torch.Tensor   # [15]
    camera: Camera
    rgb: torch.Tensor          # [H, W, 3] float32, or uint8 (device cache)
    bg_color: torch.Tensor     # [3]


@dataclass
class TrainState:
    params: FateAvatarParams
    state: FateAvatarState
    opt_state: MultiAdamState
    step: int                   # steps taken (host counter)
    generator: torch.Generator  # densify draws


@dataclass(frozen=True)
class MaintenanceConfig:
    densify_interval: int = 3000
    prune_interval: int = 2000
    opacity_reset_interval: int = 60000
    increase_num: int = 1000
    min_opacity: float = 0.005
    max_points_num: int = 200_000

    def due(self, step: int) -> bool:
        """Whether the step that brings the count to ``step`` densifies,
        prunes or resets opacity."""
        return (step % self.densify_interval == 0 or step % self.prune_interval == 0
                or step % self.opacity_reset_interval == 0)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def make_train_step(
    model: FateAvatarModel,
    loss_fn: Callable,
    optimizer: MultiAdam,
    maint: MaintenanceConfig = MaintenanceConfig(),
    render_cfg: RenderConfig = RenderConfig(),
):
    """Build the step: (TrainState, Frame, maintain=True) -> (TrainState,
    aux dict of device scalars). Mirrors iteration_step_fateavatar
    (train/iteration.py:21-89); ``maintain=False`` skips the maintenance
    that would fall due (the in-place step runs it apart). The returned
    function also exposes ``grads(ts, frame)`` -> (param grads, probe grad,
    forward output, loss dict), the step's gradient phase alone."""

    def grads(ts: TrainState, frame: Frame):
        leaves = {k: v.detach().requires_grad_() for k, v in _fields(ts.params).items()}
        params = dataclasses.replace(ts.params, **leaves)
        probe = torch.zeros((2, ts.params.offset.shape[0]), dtype=torch.float32,
                            device=ts.params.offset.device, requires_grad=True)
        out = fateavatar_forward(
            model, params, ts.state, frame.expression, frame.flame_pose,
            frame.camera, bg_color=frame.bg_color, render_cfg=render_cfg,
            means2d_probe=probe,
        )
        losses = loss_fn(out, {"rgb": frame.rgb})
        g = torch.autograd.grad(losses["loss"], [*leaves.values(), probe],
                                allow_unused=True)
        param_grads = dataclasses.replace(ts.params, **{
            k: torch.zeros_like(v) if gk is None else gk
            for (k, v), gk in zip(leaves.items(), g[:-1])})
        return param_grads, g[-1], out, losses

    def step_fn(ts: TrainState, frame: Frame, maintain: bool = True):
        param_grads, probe_grad, out, losses = grads(ts, frame)

        # densification statistics from d(loss)/d(mean2d): the
        # viewspace_points.grad hook (train/iteration.py:54-57)
        state = maintenance.add_densification_stats(
            ts.state, probe_grad, out["visibility_filter"])
        state = maintenance.update_max_radii(state, out["radii"],
                                             out["visibility_filter"])

        updates, opt_state = optimizer.update(param_grads, ts.opt_state, ts.params)
        params = apply_updates(ts.params, updates)
        step = ts.step + 1

        if maintain and step % maint.densify_interval == 0:   # train/iteration.py:63-72
            p2, s2, touched = maintenance.uv_densify(
                ts.generator, params, state, increase_num=maint.increase_num)
            o2 = zero_moment_rows(opt_state, touched, SPLAT_FIELDS)
            # the capacity check stays on the device: no host round trip
            ok = torch.sum(state.alive) + maint.increase_num <= maint.max_points_num
            params, state, opt_state = (
                _select(ok, a, b) for a, b in
                ((p2, params), (s2, state), (o2, opt_state)))
        if maintain and step % maint.prune_interval == 0:     # train/iteration.py:74-79
            state = maintenance.prune_low_opacity(params, state, maint.min_opacity)
        if maintain and step % maint.opacity_reset_interval == 0:   # :81-85
            params = maintenance.reset_opacity(params)
            opt_state = zero_moment_field(opt_state, "opacity")

        aux = {k: v.detach() for k, v in losses.items()}
        aux["num_alive"] = torch.sum(state.alive)
        aux["overflow"] = out["overflow"]
        with torch.no_grad():
            aux["psnr"] = -10.0 * torch.log10(torch.mean(
                (out["rgb_image"] - as_float_rgb(frame.rgb)) ** 2))
        new_ts = TrainState(params=params, state=state, opt_state=opt_state,
                            step=step, generator=ts.generator)
        return new_ts, aux

    step_fn.grads = grads
    return step_fn


def _select(cond: torch.Tensor, a, b):
    """Field-wise torch.where(cond, a, b) over dataclasses of tensors (and
    MultiAdamState's nested ones)."""
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            k: _select(cond, v, getattr(b, k)) for k, v in _fields(a).items()})
    return torch.where(cond, a, b)


def init_train_state(params: FateAvatarParams, state: FateAvatarState,
                     optimizer: MultiAdam, seed: int = 0) -> TrainState:
    """A fresh TrainState owning copies of ``params`` and ``state``; the
    densify generator on their device, seeded with ``seed``."""
    dev = params.offset.device
    params = dataclasses.replace(params, **{
        k: v.detach().clone() for k, v in _fields(params).items()})
    state = dataclasses.replace(state, **{
        k: v.detach().clone() for k, v in _fields(state).items()})
    return TrainState(params=params, state=state, opt_state=optimizer.init(params),
                      step=0, generator=torch.Generator(device=dev).manual_seed(seed))


def train_state_tensors(ts: TrainState) -> list:
    """Every tensor of ``ts`` in a fixed order: the parameters, the model
    state, the Adam moments and the Adam step count."""
    o = ts.opt_state
    return [*_fields(ts.params).values(), *_fields(ts.state).values(),
            *_fields(o.mu).values(), *_fields(o.nu).values(), o.count]


def clone_train_state(ts: TrainState) -> TrainState:
    """A TrainState owning copies of every tensor of ``ts`` (the static
    buffers of the in-place step); it shares the generator."""
    def copy(obj):
        return dataclasses.replace(obj, **{k: v.clone() for k, v in _fields(obj).items()})

    o = ts.opt_state
    return TrainState(params=copy(ts.params), state=copy(ts.state),
                      opt_state=MultiAdamState(mu=copy(o.mu), nu=copy(o.nu),
                                               count=o.count.clone()),
                      step=ts.step, generator=ts.generator)


def copy_train_state_(dst: TrainState, src: TrainState):
    """Copy every tensor of ``src`` into ``dst`` (a no-op where they are the
    same tensor)."""
    for d, s in zip(train_state_tensors(dst), train_state_tensors(src)):
        d.copy_(s)


# the per-step scalars an epoch of in-place steps records (the ys of the
# JAX package's scan epoch), with their types
EPOCH_AUX = {"loss": torch.float32, "psnr": torch.float32, "overflow": torch.int32}


def make_inplace_step(step_fn: Callable, static: TrainState, frame_at: Callable,
                      aux: dict, cursor: torch.Tensor):
    """The step on static buffers, for capture in a CUDA graph: the body of
    the JAX package's scan epoch (``make_train_step(..., return_raw=True)``).

    ``run(step=None)`` builds its frame with ``frame_at(cursor)`` from
    device-resident stacked frames at the device cursor ([1] int64), runs
    ``step_fn`` on ``static``, copies the new TrainState's tensors into
    ``static``, writes loss, psnr and overflow into ``aux`` ([n] tensors of
    :data:`EPOCH_AUX`) at the cursor, advances the cursor and returns the
    frame. Without ``step`` it reads no host value and runs no maintenance,
    so one capture replays as every such step (the Adam step count lives
    on the device); ``step`` (the steps taken before this one) runs the
    maintenance that falls due, eagerly: densify draws from a
    ``torch.Generator``. ``static.step`` is left to the caller."""

    def run(step: Optional[int] = None):
        frame = frame_at(cursor)
        if step is None:
            new, a = step_fn(static, frame, maintain=False)
        else:
            new, a = step_fn(dataclasses.replace(static, step=step), frame)
        copy_train_state_(static, new)
        for k, buf in aux.items():
            buf.index_copy_(0, cursor, a[k].reshape(1).to(buf.dtype))
        cursor.add_(1)
        return frame

    return run
